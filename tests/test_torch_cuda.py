"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device each test skips (the kernels have no
CPU mode).  This file imports neither JAX nor ``repro``, so it also runs on
a machine that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import backend as be
from repro_torch.core import field as F
from repro_torch.kernels.fieldops import ops as f_ops, ref as f_ref
from repro_torch.kernels.grand_product import ops as gp_ops, ref as gp_ref
from repro_torch.kernels.ntt import ops as ntt_ops, ref as ntt_ref
from repro_torch.kernels.poseidon import ops as pos_ops, ref as pos_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _rand(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, F.P, size=shape, dtype=np.int64)).to(dev)


def _wild(shape, seed, dev):
    """Canonical values with some replaced by values >= P and by negative
    int64 values (the int64 extremes and -1 among them): the NTT and the
    running products reduce any int64 as their plain versions do."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, F.P, size=shape, dtype=np.int64)
    pick = rng.random(shape)
    big = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                       size=shape, dtype=np.int64)
    x = np.where(pick < 0.05, big, x)
    x = np.where((pick >= 0.05) & (pick < 0.1), x + F.P, x)
    x = np.where((pick >= 0.1) & (pick < 0.15), -x, x)
    flat = x.reshape(-1)
    edge = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1,
                     F.P], np.int64)[:flat.size]
    flat[:edge.size] = edge
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 130, 4096])
def test_poseidon_kernel_matches_plain(dev, n):
    x = _rand((n, 16), n, dev)
    before = be.launch_counts()["poseidon_permute"]
    assert torch.equal(pos_ops.permute(x), pos_ref.permute_ref(x))
    assert be.launch_counts()["poseidon_permute"] == before + 1


@pytest.mark.parametrize("shape", [(1, 64), (7, 32), (9, 128), (2, 3, 16),
                                   (4, 65536), (1, 2), (1, 1024), (3, 2048),
                                   (16, 4096), (3, 1 << 22)])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_matches_plain(dev, shape, inverse):
    """One launch per pass of at most 11 stages, on either side of one
    pass (2^11) and of two (2^22), any int64 values in."""
    x = _wild(shape, sum(shape), dev)
    before = be.launch_counts()["ntt_stage"]
    assert torch.equal(ntt_ops.ntt(x, inverse=inverse),
                       ntt_ref.ntt_ref(x, inverse=inverse))
    log_n = shape[-1].bit_length() - 1
    assert be.launch_counts()["ntt_stage"] == \
        before + len(ntt_ops._passes(log_n))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 511, 512, 513, 1023, 1024,
                               1025, 65536, 300001])
@pytest.mark.parametrize("lanes", [1, 3, 4])
@pytest.mark.parametrize("ext", [False, True], ids=["fp", "fp4"])
def test_grand_product_kernels_match_plain(dev, n, lanes, ext):
    """One launch for every lane, on either side of a chunk (512 Fp4 or
    1,024 Fp elements), three times over: a look-back scan that reads a
    stale status word fails only now and then."""
    shape = ((n,) if lanes == 1 else (lanes, n)) + ((4,) if ext else ())
    x = _wild(shape, 10 * n + lanes + ext, dev)
    name = "grand_product_ext" if ext else "grand_product"
    kernel = gp_ops.grand_product_ext if ext else gp_ops.grand_product
    plain = gp_ref.grand_product_ext_ref if ext else gp_ref.grand_product_ref
    want = plain(x)
    for _ in range(3):
        before = be.launch_counts()[name]
        assert torch.equal(kernel(x), want)
        assert be.launch_counts()[name] == before + gp_ops.LAUNCHES_PER_CALL
    assert gp_ops.LAUNCHES_PER_CALL == 1


@pytest.mark.parametrize("shape", [(1,), (257,), (3, 1000), (4, 65536)])
def test_field_op_kernels_match_plain(dev, shape):
    a, b, c = (_rand(shape, sum(shape) + k, dev) for k in range(3))
    before = be.launch_counts()
    assert torch.equal(f_ops.mulmod(a, b), f_ref.mulmod_ref(a, b))
    assert torch.equal(f_ops.fused_mul_add(a, b, c),
                       f_ref.fused_mul_add_ref(a, b, c))
    after = be.launch_counts()
    assert after["mulmod"] == before["mulmod"] + 1
    assert after["fused_mul_add"] == before["fused_mul_add"] + 1


def test_wrappers_refuse_what_the_kernels_cannot_take(dev):
    with pytest.raises(TypeError):
        pos_ops.permute(torch.zeros((2, 16), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        pos_ops.permute(torch.zeros((2, 8), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        ntt_ops.ntt(torch.zeros((2, 12), dtype=torch.int64, device=dev))
    with pytest.raises(TypeError):
        gp_ops.grand_product_ext(torch.zeros((2, 4), dtype=torch.int32,
                                             device=dev))
    with pytest.raises(ValueError):
        gp_ops.grand_product(torch.zeros(0, dtype=torch.int64, device=dev))
    with pytest.raises(TypeError):
        f_ops.mulmod(*(torch.zeros(4, dtype=torch.int32, device=dev),) * 2)
