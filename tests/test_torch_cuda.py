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


def test_wrappers_refuse_what_the_kernels_cannot_take(dev):
    with pytest.raises(TypeError):
        pos_ops.permute(torch.zeros((2, 16), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        pos_ops.permute(torch.zeros((2, 8), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        ntt_ops.ntt(torch.zeros((2, 12), dtype=torch.int64, device=dev))
