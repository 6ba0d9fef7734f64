"""Plain PyTorch versions of the exclusive running products, the paper's
Eq. (2) accumulator Z: Z[0] = 1, Z[i] = x[0] * ... * x[i-1], along n of
(n,) or (L, n) Fp and (n, 4) or (L, n, 4) Fp4 elements.  They are the CPU
path of :mod:`ops` and the oracle the CUDA kernel is held against.

An inclusive scan by log-step doubling (Hillis-Steele: round k multiplies
each element by the one 2^k places before it), shifted right by one with a
leading 1; every lane at once.  Field products are exact, so every
association order gives the reference's values."""
from __future__ import annotations

import torch

from ...core import field as F


def _exclusive(x: torch.Tensor, mul, one: torch.Tensor,
               dim: int) -> torch.Tensor:
    n = x.shape[dim]
    if n == 0:
        return x.clone()
    acc = x
    shift = 1
    while shift < n:
        acc = torch.cat([acc.narrow(dim, 0, shift),
                         mul(acc.narrow(dim, shift, n - shift),
                             acc.narrow(dim, 0, n - shift))], dim)
        shift *= 2
    return torch.cat([one, acc.narrow(dim, 0, n - 1)], dim)


def grand_product_ref(x: torch.Tensor) -> torch.Tensor:
    """(..., n) Fp -> (..., n) exclusive prefix products along n."""
    x = x.to(F.I64) % F.P
    one = torch.ones(x.shape[:-1] + (1,), dtype=F.I64, device=x.device)
    return _exclusive(x, F.fmul, one, -1)


def grand_product_ext_ref(x: torch.Tensor) -> torch.Tensor:
    """(..., n, 4) Fp4 -> (..., n, 4) exclusive prefix products along n,
    Z[0] = [1, 0, 0, 0]."""
    x = x.to(F.I64) % F.P
    return _exclusive(x, F.emul, F.ext_one(x.shape[:-2] + (1,), x.device), -2)
