"""repro_torch.core.field against repro.core.field: Fp and Fp4 ops on the
same seeded numpy inputs, exact equality (field arithmetic is exact)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import field as RF
from repro_torch.core import field as TF

N = 257


def _rand(shape, seed, zeros=False):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, RF.P, size=shape, dtype=np.int64)
    if zeros:
        a.reshape(-1)[::7] = 0
    return a


def _ref(fn, *arrs):
    return np.asarray(fn(*[jnp.asarray(a.astype(np.uint32)) for a in arrs]),
                      np.int64)


def _port(fn, *arrs):
    return fn(*[torch.from_numpy(a) for a in arrs]).numpy()


def test_constants_match():
    assert (TF.P, TF.TWO_ADICITY, TF.GENERATOR, TF.W_EXT) == \
        (RF.P, RF.TWO_ADICITY, RF.GENERATOR, RF.W_EXT)
    assert TF.ROOTS == RF.ROOTS
    for k in range(TF.TWO_ADICITY + 1):
        assert TF.root_of_unity(1 << k) == RF.root_of_unity(1 << k)


@pytest.mark.parametrize("name", ["fadd", "fsub", "fmul"])
def test_fp_binary(name):
    a, b = _rand(N, 1, zeros=True), _rand(N, 2, zeros=True)
    np.testing.assert_array_equal(_port(getattr(TF, name), a, b),
                                  _ref(getattr(RF, name), a, b))


@pytest.mark.parametrize("name", ["fneg", "finv", "fbatch_inv"])
def test_fp_unary(name):
    a = _rand(N, 3, zeros=True)
    np.testing.assert_array_equal(_port(getattr(TF, name), a),
                                  _ref(getattr(RF, name), a))


@pytest.mark.parametrize("e", [0, 1, 7, 2**31 - 5])
def test_fpow(e):
    a = _rand(N, 4, zeros=True)
    np.testing.assert_array_equal(_port(lambda x: TF.fpow(x, e), a),
                                  _ref(lambda x: RF.fpow(x, e), a))


@pytest.mark.parametrize("name", ["eadd", "esub", "emul"])
def test_fp4_binary(name):
    a, b = _rand((N, 4), 5, zeros=True), _rand((N, 4), 6)
    np.testing.assert_array_equal(_port(getattr(TF, name), a, b),
                                  _ref(getattr(RF, name), a, b))


def test_fp4_emul_fp_and_epow():
    a, b = _rand((N, 4), 7), _rand(N, 8)
    np.testing.assert_array_equal(_port(TF.emul_fp, a, b),
                                  _ref(RF.emul_fp, a, b))
    for e in (0, 1, 5, 37):
        np.testing.assert_array_equal(_port(lambda x: TF.epow(x, e), a),
                                      _ref(lambda x: RF.epow(x, e), a))


@pytest.mark.parametrize("name", ["einv", "ebatch_inv"])
def test_fp4_inverse(name):
    a = _rand((N, 4), 9)
    a[::5] = 0                          # whole zero elements map to zero
    got = _port(getattr(TF, name), a)
    np.testing.assert_array_equal(got, _ref(getattr(RF, "ebatch_inv"), a))
    if name == "einv":                  # and a * a^-1 = 1 elsewhere
        prod = _port(TF.emul, a, got)
        nz = a.any(axis=1)
        assert (prod[nz] == [1, 0, 0, 0]).all()


def test_powers_and_epowers():
    w = TF.root_of_unity(64)
    got = TF.powers(w, 100, "cpu").numpy()
    want = [pow(w, i, TF.P) for i in range(100)]
    assert got.tolist() == want
    z = _rand(4, 10)
    table = TF.epowers(torch.from_numpy(z), 37).numpy()
    acc = np.asarray(RF.EXT_ONE, np.int64)
    for i in range(37):
        np.testing.assert_array_equal(table[i], acc)
        acc = _ref(RF.emul, acc, z)
