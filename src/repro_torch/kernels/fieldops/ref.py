"""Plain PyTorch versions of the elementwise field kernels: the CPU path of
:mod:`ops` and the oracle the CUDA kernel is held against."""
from __future__ import annotations

import torch

from ...core import field as F


def mulmod_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a * b mod P."""
    return F.fmul(a.to(F.I64) % F.P, b.to(F.I64) % F.P)


def fused_mul_add_ref(a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor) -> torch.Tensor:
    """Elementwise (a * b + c) mod P."""
    return F.fadd(mulmod_ref(a, b), c.to(F.I64) % F.P)
