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


@pytest.mark.parametrize("n", [1, 63, 64, 65, 130, 4096])
def test_poseidon_kernel_matches_plain(dev, n):
    x = _rand((n, 16), n, dev)
    before = be.launch_counts()["poseidon_permute"]
    assert torch.equal(pos_ops.permute(x), pos_ref.permute_ref(x))
    assert be.launch_counts()["poseidon_permute"] == before + 1


@pytest.mark.parametrize("shape", [(1, 64), (7, 32), (9, 128), (2, 3, 16),
                                   (4, 65536), (1, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_matches_plain(dev, shape, inverse):
    x = _rand(shape, sum(shape), dev)
    before = be.launch_counts()["ntt_stage"]
    assert torch.equal(ntt_ops.ntt(x, inverse=inverse),
                       ntt_ref.ntt_ref(x, inverse=inverse))
    log_n = shape[-1].bit_length() - 1
    assert be.launch_counts()["ntt_stage"] == before + log_n


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1023, 1024, 1025, 65536,
                               300001])
@pytest.mark.parametrize("ext", [False, True], ids=["fp", "fp4"])
def test_grand_product_kernels_match_plain(dev, n, ext):
    x = _rand((n, 4) if ext else (n,), n + ext, dev)
    name = "grand_product_ext" if ext else "grand_product"
    kernel = gp_ops.grand_product_ext if ext else gp_ops.grand_product
    plain = gp_ref.grand_product_ext_ref if ext else gp_ref.grand_product_ref
    before = be.launch_counts()[name]
    assert torch.equal(kernel(x), plain(x))
    assert be.launch_counts()[name] == before + gp_ops.LAUNCHES_PER_CALL


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
