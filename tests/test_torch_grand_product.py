"""The port's running-product and field-op kernels' plain versions against
the reference, and the grand-product argument (paper Eq. (2)) end to end,
exact equality throughout.

The reference side is ``repro``'s plain oracles at every listed shape, and
its Pallas kernels in interpret mode at one shape each (each trace is
costly); n = 257 crosses the reference wrapper's pad to a multiple of 256.
The gp permutation circuit (``tests/test_plonkish.py``'s, 64 rows) is
built in both packages; the port runs the plain ``torch`` backend on the
CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plonkish as RPK, prover as RPV, verifier as RVF
from repro.kernels.fieldops import ops as r_fops, ref as r_fref
from repro.kernels.grand_product import ops as r_gops, ref as r_gref
from repro_torch.core import backend as be
from repro_torch.core import field as TF, plonkish as TPK, prover as TPV
from repro_torch.core import verifier as TVF
from repro_torch.kernels.fieldops import ops as t_fops, ref as t_fref
from repro_torch.kernels.grand_product import ops as t_gops, ref as t_gref

N_GP = [1, 8, 255, 256, 257, 512]


def _rand(shape, seed, lo=0):
    return np.random.default_rng(seed).integers(lo, TF.P, size=shape,
                                                dtype=np.int64)


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


@pytest.fixture(scope="module")
def port_cfg(tiny_cfg):
    return TPV.ProverConfig(tiny_cfg.blowup, tiny_cfg.n_queries,
                            tiny_cfg.fri_final_size, tiny_cfg.shift,
                            backend="torch", device="cpu")


# ---------------------------------------------------------------------------
# plain versions against the reference's oracles and interpret-mode kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", N_GP)
def test_grand_product_plain_equals_reference(n):
    x = _rand(n, n, lo=1)
    want = np.asarray(r_gref.grand_product_ref(_j(x)))
    np.testing.assert_array_equal(t_gref.grand_product_ref(
        torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("n", N_GP)
def test_grand_product_ext_plain_equals_reference(n):
    x = _rand((n, 4), 100 + n)
    want = np.asarray(r_gref.grand_product_ext_ref(_j(x)))
    np.testing.assert_array_equal(t_gref.grand_product_ext_ref(
        torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("n", [1, 257, 1024, 1025])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("ext", [False, True], ids=["fp", "fp4"])
def test_running_products_over_lanes_equal_reference_lane_by_lane(ext, lanes,
                                                                  n):
    """(L, n[, 4]) in, each lane's exclusive products out; any int64 values
    (negative, >= P) are taken mod P, floored, as the kernel takes them."""
    shape = (lanes, n, 4) if ext else (lanes, n)
    rng = np.random.default_rng(10 * n + lanes + ext)
    x = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     size=shape, dtype=np.int64)
    edge = np.array([-1, TF.P, np.iinfo(np.int64).min], np.int64)
    x.reshape(-1)[:3] = edge[:x.size]
    ours = t_gops.grand_product_ext if ext else t_gops.grand_product
    got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == shape
    ref = r_gref.grand_product_ext_ref if ext else r_gref.grand_product_ref
    for k in range(lanes):
        np.testing.assert_array_equal(got[k], np.asarray(ref(_j(x[k] % TF.P))))


@pytest.mark.parametrize("ext", [False, True], ids=["fp", "fp4"])
def test_grand_product_plain_equals_interpret_kernel(ext):
    shape = (257, 4) if ext else (257,)
    x = _rand(shape, 257 + ext, lo=1)
    kernel = r_gops.grand_product_ext if ext else r_gops.grand_product
    want = np.asarray(kernel(_j(x), interpret=True))
    ours = t_gops.grand_product_ext if ext else t_gops.grand_product
    np.testing.assert_array_equal(ours(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("shape", [(1,), (257,), (8, 32), (4, 4, 16)])
def test_field_ops_plain_equal_reference(shape):
    a, b, c = (_rand(shape, sum(shape) + k) for k in range(3))
    np.testing.assert_array_equal(
        t_fref.mulmod_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(r_fref.mulmod_ref(_j(a), _j(b))))
    np.testing.assert_array_equal(
        t_fref.fused_mul_add_ref(*map(torch.from_numpy, (a, b, c))).numpy(),
        np.asarray(r_fref.fused_mul_add_ref(_j(a), _j(b), _j(c))))


@pytest.mark.parametrize("op", ["mulmod", "fused_mul_add"])
def test_field_ops_equal_interpret_kernel(op):
    shape = (3, 257)
    xs = [_rand(shape, k) for k in range(2 if op == "mulmod" else 3)]
    want = np.asarray(getattr(r_fops, op)(*map(_j, xs), interpret=True))
    got = getattr(t_fops, op)(*map(torch.from_numpy, xs))
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_field_op_edge_values():
    edge = np.asarray([0, 1, 2, TF.P - 1, TF.P - 2, (1 << 16) - 1, 1 << 16,
                       1 << 27, TF.P // 2, 1 << 30], np.int64)
    a, b = (t.ravel() for t in np.meshgrid(edge, edge))
    got = t_fops.mulmod(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray([int(x) * int(y) % TF.P for x, y in zip(a, b)])
    np.testing.assert_array_equal(got, want)
    got = t_fops.fused_mul_add(*map(torch.from_numpy, (a, b, b))).numpy()
    np.testing.assert_array_equal(got, (want + b) % TF.P)


def test_telescoping_ratio_multiplies_back_to_one():
    """Eq. (2): the ratios of a cyclic shift multiply back to one, in the
    base field and in Fp4."""
    vals = _rand(255, 3, lo=1)
    num = np.concatenate([vals, [1]])
    den = np.concatenate([[1], vals])
    ratio = torch.from_numpy(num) * TF.finv(torch.from_numpy(den)) % TF.P
    z = t_gops.grand_product(ratio)
    assert int(z[-1]) * int(ratio[-1]) % TF.P == 1
    v4 = torch.from_numpy(_rand((64, 4), 4, lo=1))
    r4 = TF.emul(torch.roll(v4, -1, 0), TF.einv(v4))
    z4 = t_gops.grand_product_ext(r4)
    np.testing.assert_array_equal(TF.emul(z4[-1], r4[-1]).numpy(),
                                  TF.EXT_ONE)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = be.launch_counts()
    x = torch.from_numpy(_rand((33, 4), 9))
    assert torch.equal(t_gops.grand_product_ext(x),
                       t_gref.grand_product_ext_ref(x))
    assert torch.equal(t_gops.grand_product(x[:, 0]),
                       t_gref.grand_product_ref(x[:, 0]))
    assert torch.equal(t_fops.mulmod(x, x), t_fref.mulmod_ref(x, x))
    assert torch.equal(t_fops.fused_mul_add(x, x, x),
                       t_fref.fused_mul_add_ref(x, x, x))
    assert be.launch_counts() == before
    for name in ("grand_product_ext", "grand_product", "mulmod",
                 "fused_mul_add"):
        assert name in before


def test_wrappers_refuse_wrong_shapes():
    with pytest.raises(ValueError):
        t_gops.grand_product_ext(torch.zeros((8, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        t_gops.grand_product_ext(torch.zeros((2, 2, 8, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        t_gops.grand_product(torch.zeros((2, 8, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        t_fops.mulmod(torch.zeros(4, dtype=torch.int64),
                      torch.zeros(5, dtype=torch.int64))
    with pytest.raises(ValueError):
        t_fops.fused_mul_add(*(torch.zeros(4, dtype=torch.int64),) * 2,
                             torch.zeros((2, 2), dtype=torch.int64))


# ---------------------------------------------------------------------------
# the grand-product argument through both provers and verifiers
# ---------------------------------------------------------------------------
def _perm_circuit(pkg, n_rows=64, bad=False):
    """``tests/test_plonkish.py``'s Eq. (1)+(2) circuit: (a1, a2) and
    (b1, b2) must be equal as multisets."""
    c = pkg.Circuit(n_rows, name="perm")
    a1, a2 = c.add_advice("a1"), c.add_advice("a2")
    b1, b2 = c.add_advice("b1"), c.add_advice("b2")
    c.add_grand_product("perm", [a1, a2], [b1, b2])
    rng = np.random.default_rng(7)
    advice = np.zeros((c.n_advice, n_rows), np.uint32)
    pairs = rng.integers(0, TF.P, size=(n_rows, 2)).astype(np.uint32)
    perm = rng.permutation(n_rows)
    advice[0], advice[1] = pairs[:, 0], pairs[:, 1]
    advice[2], advice[3] = pairs[perm, 0], pairs[perm, 1]
    if bad:
        advice[2, 5] = (int(advice[2, 5]) + 1) % TF.P
    return c, advice


@pytest.fixture(scope="module")
def gp_pair(tiny_cfg, port_cfg):
    """(keys, advice) of the gp circuit in the reference and the port."""
    r_c, r_adv = _perm_circuit(RPK)
    t_c, t_adv = _perm_circuit(TPK)
    return (RPV.keygen(r_c, tiny_cfg), r_adv), (TPV.keygen(t_c, port_cfg),
                                                t_adv)


def _canonical(proof):
    proof = type(proof).from_bytes(proof.to_bytes())
    proof.timings = {}
    return proof.to_bytes()


def test_gp_keygen_adds_row0_and_matches_reference(gp_pair):
    (r_keys, _), (t_keys, _) = gp_pair
    assert t_keys.circuit.fixed_names == r_keys.circuit.fixed_names
    assert t_keys.circuit.fixed_names[-1] == "__row0"
    for t_col, r_col in zip(t_keys.circuit.fixed_cols,
                            r_keys.circuit.fixed_cols):
        np.testing.assert_array_equal(t_col, r_col)
    assert t_keys.circuit.digest_seed() == r_keys.circuit.digest_seed()
    np.testing.assert_array_equal(t_keys.fixed_lde.numpy(),
                                  np.asarray(r_keys.fixed_lde))
    np.testing.assert_array_equal(t_keys.fixed_coeffs.numpy(),
                                  np.asarray(r_keys.fixed_coeffs))
    # a second keygen of the same circuit adds no second one-hot
    again = TPV.keygen(t_keys.circuit, t_keys.cfg)
    assert again.circuit.fixed_names.count("__row0") == 1


def test_gp_proof_bytes_equal_and_verify_both_ways(gp_pair):
    (r_keys, r_adv), (t_keys, t_adv) = gp_pair
    inst = np.zeros((0, 64), np.uint32)
    r_pf = RPV.prove(r_keys, r_adv.copy(), inst)
    t_pf = TPV.prove(t_keys, t_adv.copy(), inst)
    assert _canonical(t_pf) == _canonical(r_pf)
    assert TVF.verify(t_keys, inst, t_pf)
    assert TVF.verify(t_keys, inst, r_pf)
    assert RVF.verify(r_keys, inst, t_pf)


def test_gp_bad_witness_rejected_by_both(gp_pair):
    (r_keys, _), (t_keys, _) = gp_pair
    _, r_bad = _perm_circuit(RPK, bad=True)
    _, t_bad = _perm_circuit(TPK, bad=True)
    inst = np.zeros((0, 64), np.uint32)
    r_pf = RPV.prove(r_keys, r_bad, inst)
    t_pf = TPV.prove(t_keys, t_bad, inst)
    assert _canonical(t_pf) == _canonical(r_pf)
    assert not TVF.verify(t_keys, inst, t_pf)
    assert not RVF.verify(r_keys, inst, t_pf)


def test_gp_column_goes_through_the_dispatched_accumulator(gp_pair,
                                                           monkeypatch):
    """The prover's Eq. (2) column is the active backend's
    ``grand_product_ext``, on both backend names."""
    (_, _), (t_keys, t_adv) = gp_pair
    calls = []
    for name in ("torch", "cuda"):
        real = be.get(name)

        def spy(x, real=real, name=name):
            calls.append((name, tuple(x.shape)))
            return real.grand_product_ext(x)

        monkeypatch.setitem(be._REGISTRY, name,
                            dataclasses.replace(real, grand_product_ext=spy))
    inst = np.zeros((0, 64), np.uint32)
    want = _canonical(TPV.prove(t_keys, t_adv.copy(), inst))
    keys_cuda = dataclasses.replace(t_keys, backend="cuda")
    assert _canonical(TPV.prove(keys_cuda, t_adv.copy(), inst)) == want
    assert calls == [("torch", (1, 64, 4)), ("cuda", (1, 64, 4))]
