"""The port's prover layers against the reference, exact equality: Merkle
roots and openings, the Fiat–Shamir challenge stream, FRI, and for the
``expand`` operator (n_rows=32, m_edges=20) the keygen LDEs and every field
of a proof.  The port runs the plain ``torch`` backend on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import fri as RFRI, merkle as RM
from repro.core import transcript as RT
from repro.core.operators import expansion as RX
from repro.core.operators import registry as RR
from repro_torch.core import backend as be
from repro_torch.core import field as TF, fri as TFRI, merkle as TM
from repro_torch.core import prover as TPV, transcript as TT
from repro_torch.core import verifier as TV
from repro_torch.core.operators import expansion as TX
from repro_torch.core.operators import registry as TR

SHAPE = dict(n_rows=32, m_edges=20, with_prop=False, reverse=False)


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, TF.P, size=shape,
                                                dtype=np.int64)


@pytest.fixture
def cpu():
    with be.use("torch", "cpu"):
        yield


@pytest.fixture(scope="module")
def port_cfg():
    return TPV.ProverConfig(blowup=4, n_queries=4, fri_final_size=16,
                            backend="torch", device="cpu")


def test_merkle_roots_and_openings(cpu):
    rows = _rand((64, 5), 1)
    r_tree = RM.commit(jnp.asarray(rows.astype(np.uint32)))
    t_tree = TM.commit(torch.from_numpy(rows))
    for r_layer, t_layer in zip(r_tree.layers, t_tree.layers):
        np.testing.assert_array_equal(t_layer.numpy(), np.asarray(r_layer))
    idx = np.array([0, 5, 63, 17])
    r_rows, r_path = RM.open_at(r_tree, jnp.asarray(idx))
    t_rows, t_path = TM.open_at(t_tree, torch.from_numpy(idx))
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(r_rows))
    np.testing.assert_array_equal(t_path.numpy(), np.asarray(r_path))
    assert TM.verify_open(t_tree.root, torch.from_numpy(idx), t_rows, t_path)
    bad = t_rows.clone()
    bad[1, 2] = (bad[1, 2] + 1) % TF.P
    assert not TM.verify_open(t_tree.root, torch.from_numpy(idx), bad, t_path)
    left, right = _rand(8, 2), _rand(8, 3)
    np.testing.assert_array_equal(TM.compress_pair(left, right),
                                  RM.compress_pair(left, right))


def test_transcript_challenge_stream(cpu):
    r, t = RT.Transcript("stream"), TT.Transcript("stream")
    for step in range(6):
        vals = _rand(step * 5 + 1, step)
        r.absorb(vals)
        t.absorb(vals)
        r.absorb_digest(_rand(8, 10 + step).astype(np.uint32))
        t.absorb_digest(torch.from_numpy(_rand(8, 10 + step)))
        np.testing.assert_array_equal(t.challenge_ext(), r.challenge_ext())
        assert t.challenge_fp() == r.challenge_fp()
        np.testing.assert_array_equal(t.challenge_indices(7, 256),
                                      r.challenge_indices(7, 256))


def test_fri_prove_and_verify(cpu):
    # a codeword of degree < 64 on the coset: the LDE of random evaluations
    from repro_torch.core import poly as TP
    evals = torch.from_numpy(_rand((4, 64), 4))
    code = TP.coset_lde(evals, 4).T.contiguous().numpy()
    r_cfg = RFRI.FriConfig(blowup=4, n_queries=5, final_size=16)
    t_cfg = TFRI.FriConfig(blowup=4, n_queries=5, final_size=16)
    r_pf = RFRI.fri_prove(jnp.asarray(code.astype(np.uint32)),
                          RT.Transcript("fri"), r_cfg)
    t_pf = TFRI.fri_prove(torch.from_numpy(code), TT.Transcript("fri"), t_cfg)
    assert t_pf.to_bytes() == r_pf.to_bytes()
    ok, _, layer0, _ = TFRI.fri_verify(t_pf, TT.Transcript("fri"), t_cfg, 256)
    assert ok is True and layer0 is not None
    # a codeword of too high a degree fails the final degree check
    high = TFRI.fri_prove(torch.from_numpy(_rand((256, 4), 5)),
                          TT.Transcript("fri"), t_cfg)
    assert not TFRI.fri_verify(high, TT.Transcript("fri"), t_cfg, 256)[0]


def _witness(pkg_expansion, op):
    rng = np.random.default_rng(7)
    src = rng.integers(1, 6, size=SHAPE["m_edges"]).astype(np.int64)
    dst = rng.integers(1, 50, size=SHAPE["m_edges"]).astype(np.int64)
    return pkg_expansion.witness_edge_list(op, src, dst, 3)


def test_expand_keygen_and_every_proof_field(tiny_cfg, port_cfg):
    r_op = RR.build_operator("expand", dict(SHAPE))
    t_op = TR.build_operator("expand", dict(SHAPE))
    assert t_op.circuit.digest_seed() == r_op.circuit.digest_seed()
    r_op.keygen(tiny_cfg)
    t_op.keygen(port_cfg)
    assert t_op.keys.backend == "torch" and t_op.keys.device.type == "cpu"
    np.testing.assert_array_equal(t_op.keys.fixed_lde.numpy(),
                                  np.asarray(r_op.keys.fixed_lde))
    np.testing.assert_array_equal(t_op.keys.fixed_coeffs.numpy(),
                                  np.asarray(r_op.keys.fixed_coeffs))
    r_w = _witness(RX, r_op)
    t_w = _witness(TX, t_op)
    for a, b in zip(t_w, r_w):
        np.testing.assert_array_equal(a, b)
    r_pf = r_op.prove(*r_w)
    t_pf = t_op.prove(*t_w)
    for f in ("data_root", "advice_root", "ext_root", "quotient_root"):
        np.testing.assert_array_equal(getattr(t_pf, f), getattr(r_pf, f))
    assert sorted(t_pf.openings) == sorted(r_pf.openings)
    for k in r_pf.openings:
        np.testing.assert_array_equal(t_pf.openings[k], r_pf.openings[k])
    assert t_pf.fri_proof.to_bytes() == r_pf.fri_proof.to_bytes()
    assert sorted(t_pf.tree_openings) == sorted(r_pf.tree_openings)
    for name, (rows, paths) in r_pf.tree_openings.items():
        np.testing.assert_array_equal(t_pf.tree_openings[name][0], rows)
        np.testing.assert_array_equal(t_pf.tree_openings[name][1], paths)
    assert sorted(t_pf.timings) == sorted(r_pf.timings)
    t_pf.timings, r_pf.timings = {}, {}
    assert t_pf.to_bytes() == r_pf.to_bytes()
    # each package's verifier accepts the other's proof
    assert t_op.verify(t_w[1], r_pf)
    assert r_op.verify(r_w[1], t_pf)
    adv, inst, data = t_w
    forged = inst.copy()
    forged[t_op.handles["C_t"].index, 0] += 1
    assert not t_op.verify(forged, t_pf)


def test_verifier_binds_data_root_and_label(port_cfg):
    t_op = TR.build_operator("expand", dict(SHAPE)).keygen(port_cfg)
    adv, inst, data = _witness(TX, t_op)
    pf = t_op.prove(adv, inst, data)
    assert t_op.verify(inst, pf, expected_data_root=pf.data_root)
    other = (np.asarray(pf.data_root) + 1) % TF.P
    assert not t_op.verify(inst, pf, expected_data_root=other)
    # the transcript label is the operator name: another label is another
    # Fiat–Shamir transcript
    assert not TV.verify(t_op.keys, inst, pf, label="zkgraph")
