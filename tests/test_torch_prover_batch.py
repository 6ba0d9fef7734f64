"""The port's lane-batched prover against its solo prover and the
reference, exact equality: the batched transcript's challenges, lane
Merkle trees, lane FRI, and ``prove_batch`` / ``prove_steps`` lane bytes
(timings cleared) for the grand-product circuit and for IS5 steps at the
fixture size.  The port runs the plain ``torch`` backend on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fri as RFRI, merkle as RM, plonkish as RPK
from repro.core import prover as RPV, prover_batch as RPB
from repro.core import transcript as RT
from repro_torch import interop
from repro_torch.core import backend as be
from repro_torch.core import field as TF, fri as TFRI, merkle as TM
from repro_torch.core import plonkish as TPK, poly as TP, prover as TPV
from repro_torch.core import prover_batch as TPB, transcript as TT
from repro_torch.core import verifier as TVF
from repro_torch.core.session import ZKGraphSession as TSession

MESSAGES = ((1 << 20) + 3, (1 << 20) + 9)


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, TF.P, size=shape,
                                                dtype=np.int64)


def _canonical(proof) -> bytes:
    proof = type(proof).from_bytes(proof.to_bytes())
    proof.timings = {}
    return proof.to_bytes()


@pytest.fixture
def cpu():
    with be.use("torch", "cpu"):
        yield


@pytest.fixture(scope="module")
def port_cfg(tiny_cfg):
    return TPV.ProverConfig(tiny_cfg.blowup, tiny_cfg.n_queries,
                            tiny_cfg.fri_final_size, tiny_cfg.shift,
                            backend="torch", device="cpu")


# ---------------------------------------------------------------------------
# lane primitives
# ---------------------------------------------------------------------------
def test_batched_transcript_matches_reference_and_solo_lanes(cpu):
    lane_vals = np.stack([_rand(13, l) for l in range(3)])
    shared = _rand(9, 7)
    r = RT.BatchedTranscript("lanes", lanes=3)
    t = TT.BatchedTranscript("lanes", lanes=3)
    solos = [TT.Transcript("lanes") for _ in range(3)]
    for tx in (r, t):
        tx.absorb_shared(shared)
        tx.absorb(lane_vals)
    for solo, vals in zip(solos, lane_vals):
        solo.absorb(shared)
        solo.absorb(vals)
    t.absorb_digest(torch.from_numpy(_rand((3, 8), 8)))
    r.absorb_digest(_rand((3, 8), 8).astype(np.uint32))
    for solo, d in zip(solos, _rand((3, 8), 8)):
        solo.absorb_digest(d)
    ch = t.challenge_ext()
    np.testing.assert_array_equal(ch, r.challenge_ext())
    for l, solo in enumerate(solos):
        np.testing.assert_array_equal(ch[l], solo.challenge_ext())
    idx = t.challenge_indices(11, 256)
    np.testing.assert_array_equal(idx, r.challenge_indices(11, 256))
    for l, solo in enumerate(solos):
        np.testing.assert_array_equal(idx[l], solo.challenge_indices(11, 256))


def test_commit_lanes_and_open_lanes_match_reference(cpu):
    rows = _rand((3, 32, 5), 2)
    r_tree = RM.commit_lanes(jnp.asarray(rows.astype(np.uint32)))
    t_tree = TM.commit_lanes(torch.from_numpy(rows))
    for r_layer, t_layer in zip(r_tree.layers, t_tree.layers, strict=True):
        np.testing.assert_array_equal(t_layer.numpy(), np.asarray(r_layer))
    np.testing.assert_array_equal(t_tree.roots.numpy(),
                                  np.asarray(r_tree.roots))
    for l in range(3):
        np.testing.assert_array_equal(
            t_tree.roots[l].numpy(),
            TM.commit(torch.from_numpy(rows[l])).root.numpy())
    idx = np.array([[0, 5, 31], [7, 7, 1], [30, 2, 16]])
    r_rows, r_path = RM.open_lanes(r_tree, jnp.asarray(idx))
    t_rows, t_path = TM.open_lanes(t_tree, torch.from_numpy(idx))
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(r_rows))
    np.testing.assert_array_equal(t_path.numpy(), np.asarray(r_path))


def test_fri_prove_lanes_matches_reference_and_verifies(cpu):
    evals = torch.from_numpy(_rand((3, 4, 64), 4))
    code = TP.coset_lde(evals, 4).transpose(1, 2).contiguous()  # (3, 256, 4)
    cfg_r = RFRI.FriConfig(blowup=4, n_queries=5, final_size=16)
    cfg_t = TFRI.FriConfig(blowup=4, n_queries=5, final_size=16)
    r_pfs = RFRI.fri_prove_lanes(jnp.asarray(code.numpy().astype(np.uint32)),
                                 RT.BatchedTranscript("fri", 3), cfg_r)
    t_pfs = TFRI.fri_prove_lanes(code, TT.BatchedTranscript("fri", 3), cfg_t)
    for l, (r_pf, t_pf) in enumerate(zip(r_pfs, t_pfs, strict=True)):
        assert t_pf.to_bytes() == r_pf.to_bytes()
        solo = TFRI.fri_prove(code[l], TT.Transcript("fri"), cfg_t)
        assert t_pf.to_bytes() == solo.to_bytes()
        assert TFRI.fri_verify(t_pf, TT.Transcript("fri"), cfg_t, 256)[0]


# ---------------------------------------------------------------------------
# prove_batch on the grand-product circuit
# ---------------------------------------------------------------------------
def _perm_witness(n_rows, seed):
    """Advice of the gp permutation circuit: a1, a2 a random table and
    b1, b2 the same pairs under ``default_rng(seed)``'s permutation."""
    rng = np.random.default_rng(seed)
    advice = np.zeros((4, n_rows), np.uint32)
    pairs = rng.integers(0, TF.P, size=(n_rows, 2)).astype(np.uint32)
    perm = rng.permutation(n_rows)
    advice[0], advice[1] = pairs[:, 0], pairs[:, 1]
    advice[2], advice[3] = pairs[perm, 0], pairs[perm, 1]
    return advice


def _perm_circuit(pkg, n_rows=64):
    c = pkg.Circuit(n_rows, name="perm")
    a1, a2 = c.add_advice("a1"), c.add_advice("a2")
    b1, b2 = c.add_advice("b1"), c.add_advice("b2")
    c.add_grand_product("perm", [a1, a2], [b1, b2])
    return c


def test_prove_batch_gp_lanes_equal_solo_and_reference(tiny_cfg, port_cfg):
    inst = np.zeros((0, 64), np.uint32)
    witnesses = [_perm_witness(64, k) for k in range(3)]
    t_keys = TPV.keygen(_perm_circuit(TPK), port_cfg)
    r_keys = RPV.keygen(_perm_circuit(RPK), tiny_cfg)
    t_lanes = TPB.prove_batch(t_keys, [(w.copy(), inst, None)
                                       for w in witnesses])
    r_lanes = RPB.prove_batch(r_keys, [(w.copy(), inst, None)
                                       for w in witnesses])
    assert len(t_lanes) == len(r_lanes) == 3
    for w, t_pf, r_pf in zip(witnesses, t_lanes, r_lanes):
        assert sorted(t_pf.timings) == sorted(r_pf.timings)
        want = _canonical(TPV.prove(t_keys, w.copy(), inst))
        assert _canonical(t_pf) == want
        assert _canonical(r_pf) == want
        assert TVF.verify(t_keys, inst, t_pf)


def test_prove_batch_refuses_a_placement(port_cfg):
    keys = TPV.keygen(_perm_circuit(TPK, 16), port_cfg)
    w = (_perm_witness(16, 0), np.zeros((0, 16), np.uint32), None)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        TPB.prove_batch(keys, [w, w], placement=object())


# ---------------------------------------------------------------------------
# prove_steps through the session: two IS5 queries, one batched pass
# ---------------------------------------------------------------------------
def _arrays(db):
    return (db.n_nodes, db.node_ids,
            {k: (t.src, t.dst, t.props) for k, t in db.tables.items()},
            db.node_props)


@pytest.fixture(scope="module")
def port_owner(db, port_cfg):
    return TSession(interop.graphdb_from_numpy(*_arrays(db)), port_cfg)


def _is5_steps(session):
    runs = [session.run_query("IS5", dict(message=m)) for m in MESSAGES]
    return [st for run in runs for st in run.steps]


def test_prove_steps_lanes_equal_solo_and_reference(owner, port_owner):
    steps = _is5_steps(port_owner)
    key0 = port_owner.step_shape_key(steps[0])
    assert all(port_owner.step_shape_key(st) == key0 for st in steps[1:])
    assert key0[2][4:] == ("torch", "cpu")
    batched = port_owner.prove_steps(steps)
    solo = [port_owner.prove_step(st) for st in steps]
    r_batched = owner.prove_steps(_is5_steps(owner))
    assert len(batched) == len(solo) == len(r_batched) == len(steps) >= 2
    for sp, so, rp in zip(batched, solo, r_batched):
        assert (sp.kind, sp.shape, sp.data_desc) == \
            (so.kind, so.shape, so.data_desc)
        np.testing.assert_array_equal(sp.instance, rp.instance)
        assert _canonical(sp.proof) == _canonical(so.proof)
        assert _canonical(sp.proof) == _canonical(rp.proof)


def test_prove_steps_single_lane_takes_the_solo_path(port_owner):
    st = _is5_steps(port_owner)[0]
    (sp,) = port_owner.prove_steps([st])
    assert _canonical(sp.proof) == _canonical(port_owner.prove_step(st).proof)
