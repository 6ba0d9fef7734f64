"""The port's main path against the reference, end to end, at the fixture
size: the same LDBC data, the same manifest bytes and digest, a
byte-identical IS5 bundle (wall-clock timings cleared), and each package's
verifier accepting the other's bytes.  The port runs the plain ``torch``
backend on the CPU, which it is asked for explicitly; by default it runs on
the card and raises without one."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.session import ProofBundle as RBundle
from repro.graphdb import ldbc as r_ldbc
from repro_torch import interop
from repro_torch.core import backend as be
from repro_torch.core import prover as TPV
from repro_torch.core.session import ProofBundle as TBundle
from repro_torch.core.session import TrustAnchor as TAnchor
from repro_torch.core.session import ZKGraphSession as TSession
from repro_torch.graphdb import ldbc as t_ldbc

IS5 = ("IS5", dict(message=(1 << 20) + 7))


def _arrays(db):
    return (db.n_nodes, db.node_ids,
            {k: (t.src, t.dst, t.props) for k, t in db.tables.items()},
            db.node_props)


def _same_db(a, b):
    assert a.n_nodes == b.n_nodes
    np.testing.assert_array_equal(a.node_ids, b.node_ids)
    assert sorted(a.tables) == sorted(b.tables)
    for k in a.tables:
        ta, tb = a.tables[k], b.tables[k]
        np.testing.assert_array_equal(ta.src, tb.src)
        np.testing.assert_array_equal(ta.dst, tb.dst)
        assert sorted(ta.props) == sorted(tb.props)
        for p in ta.props:
            np.testing.assert_array_equal(ta.props[p], tb.props[p])
    assert sorted(a.node_props) == sorted(b.node_props)
    for ent in a.node_props:
        for p in a.node_props[ent]:
            np.testing.assert_array_equal(a.node_props[ent][p],
                                          b.node_props[ent][p])


def _canonical(bundle, cls):
    """Wire bytes with the wall-clock timings cleared, on a decoded copy
    (the session fixtures are shared)."""
    b = cls.from_bytes(bundle.to_bytes())
    for step in b.steps:
        step.proof.timings = {}
    return b.to_bytes()


@pytest.fixture(scope="module")
def port_cfg(tiny_cfg):
    return TPV.ProverConfig(tiny_cfg.blowup, tiny_cfg.n_queries,
                            tiny_cfg.fri_final_size, tiny_cfg.shift,
                            backend="torch", device="cpu")


@pytest.fixture(scope="module")
def port_owner(db, port_cfg):
    return TSession(interop.graphdb_from_numpy(*_arrays(db)), port_cfg)


@pytest.fixture(scope="module")
def port_bundle(port_owner):
    return port_owner.prove(*IS5)


@pytest.mark.parametrize("kw", [
    dict(n_knows=96, n_persons=24, n_comments=64, seed=11),
    dict(n_knows=300, seed=3),
    dict(n_knows=40, n_persons=10, n_comments=0, seed=5),
])
def test_ldbc_generate_arrays_equal_reference(kw):
    _same_db(t_ldbc.generate(**kw), r_ldbc.generate(**kw))


def test_graphdb_from_numpy_gives_the_same_db(db):
    port = interop.graphdb_from_numpy(*_arrays(db))
    _same_db(port, db)
    _same_db(port, t_ldbc.generate(n_knows=96, n_persons=24, n_comments=64,
                                   seed=11))
    assert port.id_bits == db.id_bits


def test_manifest_bytes_and_digest_equal_reference(owner, port_owner):
    want = owner.commitments.to_bytes()
    assert port_owner.commitments.to_bytes() == want
    np.testing.assert_array_equal(port_owner.commitments.digest(),
                                  owner.commitments.digest())
    decoded = interop.manifest_from_bytes(want)
    assert decoded.to_bytes() == want
    np.testing.assert_array_equal(decoded.digest(device="cpu"),
                                  owner.commitments.digest())


def test_is5_bundle_byte_identical_to_reference(bundle, port_bundle):
    assert _canonical(port_bundle, TBundle) == _canonical(bundle, RBundle)
    np.testing.assert_array_equal(port_bundle.result["creator"],
                                  bundle.result["creator"])
    assert port_bundle.result["creator"].dtype == np.int64


def test_cross_verification_both_ways(bundle, port_bundle, verifier,
                                      port_owner, port_cfg):
    port_verifier = TSession.verifier(
        anchor=TAnchor(manifest=port_owner.commitments), cfg=port_cfg)
    assert verifier.verify_bytes(port_bundle.to_bytes())
    assert port_verifier.verify_bytes(bundle.to_bytes())
    assert port_verifier.verify_bytes(port_bundle.to_bytes())


def test_flipped_byte_rejected(port_bundle, port_owner, port_cfg, verifier):
    port_verifier = TSession.verifier(
        anchor=TAnchor(manifest=port_owner.commitments), cfg=port_cfg)
    raw = port_bundle.to_bytes()
    root = np.asarray(port_bundle.steps[0].proof.data_root, "<u4").tobytes()
    for at in (raw.index(root), len(raw) // 2, 9):
        bad = bytearray(raw)
        bad[at] ^= 1
        assert not port_verifier.verify_bytes(bytes(bad)), at
        assert not verifier.verify_bytes(bytes(bad)), at


def test_unported_operator_raises_not_implemented(port_owner):
    with pytest.raises(NotImplementedError, match="SetExpand"):
        port_owner.prove("IC2", dict(person=3))


def test_default_session_runs_on_the_card_or_raises(db, monkeypatch):
    monkeypatch.delenv(be.ENV_VAR, raising=False)
    cfg = TPV.ProverConfig(blowup=4, n_queries=4, fri_final_size=16)
    if torch.cuda.is_available():
        s = TSession(db, cfg)
        assert (s.backend, s.device.type) == ("cuda", "cuda")
        return
    with pytest.raises(be.BackendUnavailableError, match="no CUDA device"):
        TSession(db, cfg)
    # the env var picks the backend, never the device: still the card
    monkeypatch.setenv(be.ENV_VAR, "torch")
    with pytest.raises(be.BackendUnavailableError):
        TSession(db, cfg)
    with pytest.raises(be.UnknownBackendError):
        TSession(db, dataclasses.replace(cfg, backend="pallas"))
    # naming the CPU device is how a caller asks for the CPU; the backend
    # stays what was selected, and its wrappers see CPU tensors
    monkeypatch.delenv(be.ENV_VAR)
    s = TSession(db, dataclasses.replace(cfg, device="cpu"))
    assert (s.backend, s.device.type) == ("cuda", "cpu")
