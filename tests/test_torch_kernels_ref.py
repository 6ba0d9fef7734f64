"""The plain versions of the port's two kernels against the reference: the
Poseidon permutation and the NTT, each held against ``repro``'s pure-jnp
oracle and its Pallas kernel run in interpret mode, at the padding-edge
shapes ``tests/test_backend.py`` uses, with exact equality; and what the
CUDA NTT's host side computes (its pass plan, its Montgomery twiddles).
The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import field as RF, hashing as RH, poly as RP
from repro.kernels.ntt import ops as r_ntt_ops
from repro.kernels.poseidon import ops as r_pos_ops
from repro_torch.core import backend as be
from repro_torch.core import hashing as TH, poly as TP
from repro_torch.kernels.ntt import ops as t_ntt_ops, ref as t_ntt_ref
from repro_torch.kernels.poseidon import ops as t_pos_ops, ref as t_pos_ref

POSEIDON_N = [1, 63, 64, 65, 130]
NTT_SHAPES = [(1, 64), (7, 32), (9, 128), (2, 3, 16)]


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, RF.P, size=shape, dtype=np.int64)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.uint32))


def test_params_rebuilt_with_numpy_equal_reference():
    mds_t, rc_t = TH._params()
    mds_r, rc_r = RH._params()
    np.testing.assert_array_equal(mds_t, mds_r)
    np.testing.assert_array_equal(rc_t, rc_r)
    assert mds_t.dtype == mds_r.dtype and rc_t.dtype == rc_r.dtype
    assert (TH.WIDTH, TH.RATE, TH.DIGEST, TH.FULL_ROUNDS,
            TH.PARTIAL_ROUNDS) == (RH.WIDTH, RH.RATE, RH.DIGEST,
                                   RH.FULL_ROUNDS, RH.PARTIAL_ROUNDS)


@pytest.mark.parametrize("n", POSEIDON_N)
def test_poseidon_plain_equals_reference(n):
    x = _rand((n, 16), seed=n)
    got = t_pos_ref.permute_ref(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(RH.permute_ref(_j(x))))
    # the kernel wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(t_pos_ops.permute(_t(x)).numpy(), got)


def test_poseidon_plain_equals_interpret_kernel():
    """One interpret-mode call over the states of every shape above: each
    interpret trace costs tens of seconds, and rows are independent."""
    xs = [_rand((n, 16), seed=n) for n in POSEIDON_N]
    want = np.asarray(r_pos_ops.permute(_j(np.concatenate(xs)),
                                        interpret=True))
    at = 0
    for x in xs:
        np.testing.assert_array_equal(
            t_pos_ref.permute_ref(_t(x)).numpy(), want[at:at + len(x)])
        at += len(x)


@pytest.mark.parametrize("shape", NTT_SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_plain_equals_reference_and_interpret_kernel(shape, inverse):
    x = _rand(shape, seed=sum(shape))
    got = t_ntt_ref.ntt_ref(_t(x), inverse=inverse).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(RP.ntt_ref(_j(x), inverse=inverse)))
    np.testing.assert_array_equal(
        got, np.asarray(r_ntt_ops.ntt(_j(x), inverse=inverse, interpret=True)))
    np.testing.assert_array_equal(
        t_ntt_ops.ntt(_t(x), inverse=inverse).numpy(), got)


def test_ntt_tables_equal_reference():
    for n in (2, 16, 1024):
        np.testing.assert_array_equal(TP._bitrev_perm(n), RP._bitrev_perm(n))
        for inv in (False, True):
            for a, b in zip(TP._stage_twiddles(n, inv),
                            RP._stage_twiddles(n, inv)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("log_n", list(range(1, 20)) + [27])
def test_ntt_pass_plan_covers_every_stage_once(log_n):
    """The kernel's launches: every stage once, in order, at most
    MAX_STAGES a pass, ceil(log_n / MAX_STAGES) passes, so at most two for
    every length the prover uses (up to 2^19)."""
    plan = t_ntt_ops._passes(log_n)
    assert [s for s0, ks in plan for s in range(s0, s0 + ks)] == \
        list(range(log_n))
    assert all(1 <= ks <= t_ntt_ops.MAX_STAGES == 11 for _, ks in plan)
    assert len(plan) == -(-log_n // t_ntt_ops.MAX_STAGES)
    assert len(plan) <= 2 if log_n <= 19 else len(plan) == 3
    assert t_ntt_ops._passes(0) == []


def test_ntt_twiddles_are_the_stage_tables_in_montgomery_form():
    r_inv = pow(1 << 32, RF.P - 2, RF.P)
    for n in (2, 16, 4096):
        for inv in (False, True):
            tw = t_ntt_ops._twiddles(n, inv, torch.device("cpu"))
            assert tw.dtype == torch.int32 and tw.shape == (n - 1,)
            want = np.concatenate(RP._stage_twiddles(n, inv)).astype(np.int64)
            np.testing.assert_array_equal(
                tw.numpy().astype(np.int64) * r_inv % RF.P, want)


@pytest.mark.parametrize("shape", [(2, 2048), (3, 4096)])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_takes_any_int64_as_the_reference_takes_it_mod_p(shape, inverse):
    """One contract for the kernel and its plain version: any int64 in,
    reduced mod P, floored (values >= P and negative values included)."""
    rng = np.random.default_rng(sum(shape) + inverse)
    x = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     size=shape, dtype=np.int64)
    x[0, :4] = [-1, RF.P, -RF.P - 1, np.iinfo(np.int64).min]
    got = t_ntt_ops.ntt(_t(x), inverse=inverse).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(RP.ntt_ref(_j(x % RF.P), inverse=inverse)))


def test_compress_hash_rows_hash_bytes_equal_reference():
    left, right = _rand((33, 8), 1), _rand((33, 8), 2)
    rows = _rand((3, 17, 13), 3)
    with be.use("torch", "cpu"):
        np.testing.assert_array_equal(
            TH.compress(_t(left), _t(right)).numpy(),
            np.asarray(RH.compress(_j(left), _j(right))))
        np.testing.assert_array_equal(TH.hash_rows(_t(rows)).numpy(),
                                      np.asarray(RH.hash_rows(_j(rows))))
        for data in (b"", b"z", b"zkgraph \x00\x01\x02" * 5):
            np.testing.assert_array_equal(TH.hash_bytes(data),
                                          RH.hash_bytes(data))


def test_poly_helpers_equal_reference():
    x = _rand((3, 32), 4)
    with be.use("torch", "cpu"):
        np.testing.assert_array_equal(
            TP.coset_lde(_t(x), 4).numpy(), np.asarray(RP.coset_lde(_j(x), 4)))
        np.testing.assert_array_equal(
            TP.coset_coeffs(_t(x), 31).numpy(),
            np.asarray(RP.coset_coeffs(_j(x), 31)))
        np.testing.assert_array_equal(TP.domain_points(64, 31).numpy(),
                                      np.asarray(RP.domain_points(64, 31)))
    z = _rand(4, 5)
    np.testing.assert_array_equal(
        TP.eval_at_ext(_t(x), _t(z)).numpy(),
        np.asarray(RP.eval_at_ext(_j(x), _j(z))))
