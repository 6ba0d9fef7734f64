"""Polynomial arithmetic over BabyBear: radix-2 NTT, coset LDE, evaluation.

PyTorch counterpart of ``repro.core.poly``.  :func:`ntt` dispatches through
the active compute backend (:mod:`repro_torch.core.backend`);
:func:`ntt_ref` is the plain version.

Domain conventions
------------------
* ``H_n``     : multiplicative subgroup of size n (powers of w_n, natural order)
* coset LDE   : evaluations on ``shift * H_{n*blowup}``
* evaluation order is *natural* (index i -> shift * w^i), not bit-reversed.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import backend
from . import field as F

# default coset shift for LDEs: the field generator (not in any small H)
COSET_SHIFT = F.GENERATOR


@functools.lru_cache(maxsize=None)
def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _stage_twiddles(n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """Per-stage twiddle tables for DIT butterflies, stage m = 1,2,4,...,n/2."""
    root = F.root_of_unity(n)
    if inverse:
        root = pow(root, F.P - 2, F.P)
    tables = []
    m = 1
    while m < n:
        w_m = pow(root, n // (2 * m), F.P)     # order 2m
        tw = np.ones(m, np.uint64)
        for j in range(1, m):
            tw[j] = tw[j - 1] * w_m % F.P
        tables.append(tw.astype(np.uint32))
        m *= 2
    return tuple(tables)


@functools.lru_cache(maxsize=None)
def _tables_on(n: int, inverse: bool, device: torch.device):
    perm = torch.from_numpy(_bitrev_perm(n)).to(device)
    tws = [torch.from_numpy(t.astype(np.int64)).to(device)
           for t in _stage_twiddles(n, inverse)]
    return perm, tws


def ntt(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Radix-2 DIT NTT along the last axis (length a power of two).

    Natural-order input -> natural-order output; ``inverse=True`` includes
    the 1/n scaling.  Dispatches to the active compute backend."""
    return backend.active().ntt(a, inverse=inverse)


def ntt_ref(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The plain PyTorch NTT: bit-reversal permutation, log2 n DIT stages
    with :func:`_stage_twiddles`, then the n^-1 scale for the inverse."""
    n = a.shape[-1]
    if n == 1:
        return a.clone()
    perm, tws = _tables_on(n, bool(inverse), a.device)
    a = a[..., perm] % F.P
    batch = a.shape[:-1]
    m = 1
    for tw in tws:
        a = a.reshape(batch + (n // (2 * m), 2, m))
        even = a[..., 0, :]
        odd = F.fmul(a[..., 1, :], tw)
        a = torch.stack([F.fadd(even, odd), F.fsub(even, odd)], dim=-2)
        m *= 2
    a = a.reshape(batch + (n,))
    if inverse:
        a = F.fmul(a, pow(n, F.P - 2, F.P))
    return a


def intt(a: torch.Tensor) -> torch.Tensor:
    return ntt(a, inverse=True)


def _zero_pad(coeffs: torch.Tensor, size: int) -> torch.Tensor:
    out = coeffs.new_zeros(coeffs.shape[:-1] + (size,))
    out[..., :coeffs.shape[-1]] = coeffs
    return out


def coset_lde(evals: torch.Tensor, blowup: int,
              shift: int = COSET_SHIFT) -> torch.Tensor:
    """Given evaluations on H_n (natural order), return evaluations on
    ``shift * H_{n*blowup}`` (natural order). Last-axis transform."""
    n = evals.shape[-1]
    coeffs = F.fmul(intt(evals), F.powers(shift, n, evals.device))
    return ntt(_zero_pad(coeffs, n * blowup))


def coset_coeffs(evals: torch.Tensor, shift: int) -> torch.Tensor:
    """Interpolate coefficients from evaluations on ``shift * H_n``."""
    n = evals.shape[-1]
    s_inv = pow(shift, F.P - 2, F.P)
    return F.fmul(intt(evals), F.powers(s_inv, n, evals.device))


def eval_at_ext(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Evaluate Fp-coefficient polynomials at an Fp4 point ``z``.

    coeffs: (..., n) Fp; z: (4,) Fp4, or (L, 4) with coeffs (L, ..., n),
    one point per leading index (the lane-batched prover's OOD points).
    Returns (..., 4) = sum_i c_i z^i, from a table of powers of z and one
    modular dot product."""
    n = coeffs.shape[-1]
    zpows = F.epowers(z, n)                               # (L?, n, 4)
    zpows = zpows.reshape(tuple(z.shape[:-1])
                          + (1,) * (coeffs.ndim - z.ndim) + (n, 4))
    prod = coeffs[..., None] * zpows % F.P                # (..., n, 4)
    return prod.sum(dim=-2) % F.P                         # n * P < 2^63


def domain_points(n: int, shift: int = 1, device=None) -> torch.Tensor:
    """Natural-order points of shift * H_n as an (n,) Fp tensor."""
    device = backend.active_device() if device is None else device
    return F.fmul(F.powers(F.root_of_unity(n), n, device), shift % F.P)
