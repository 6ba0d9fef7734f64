"""BabyBear prime field Fp (p = 2^31 - 2^27 + 1) and its quartic extension Fp4.

PyTorch counterpart of ``repro.core.field``.

Conventions
-----------
* Fp elements: ``torch.int64`` tensors holding canonical values in [0, p).
  A product of two such values is below 2^62, so ``a * b % P`` is exact.
* Fp4 elements: int64 tensors whose **last axis has size 4** (coefficients
  of 1, x, x^2, x^3 in Fp[x]/(x^4 - W)).
* Every op is elementwise and runs on whatever device its inputs live on.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

P = 2013265921                     # 15 * 2^27 + 1  (BabyBear)
TWO_ADICITY = 27
GENERATOR = 31                     # multiplicative generator of Fp*
W_EXT = 11                         # Fp4 = Fp[x]/(x^4 - 11)

I64 = torch.int64

# two-adic roots of unity: ROOTS[k] has order 2^k
ROOTS: list[int] = [1] * (TWO_ADICITY + 1)
ROOTS[TWO_ADICITY] = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
for _k in range(TWO_ADICITY - 1, -1, -1):
    ROOTS[_k] = ROOTS[_k + 1] * ROOTS[_k + 1] % P
assert ROOTS[1] == P - 1 and ROOTS[0] == 1


@functools.lru_cache(maxsize=None)
def root_of_unity(order: int) -> int:
    """Primitive root of unity of the given power-of-two order (python int)."""
    k = order.bit_length() - 1
    assert order == 1 << k and k <= TWO_ADICITY, f"bad NTT order {order}"
    return ROOTS[k]


def tensor(x, device) -> torch.Tensor:
    """Host values (numpy / list / int) or a tensor -> int64 tensor on
    ``device``, reduced into [0, P)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I64) % P
    arr = np.asarray(x)
    if arr.dtype == np.uint64:
        arr = arr % np.uint64(P)
    return torch.from_numpy(np.ascontiguousarray(arr.astype(np.int64) % P)) \
        .to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Device tensor of field elements -> host uint32 array."""
    return x.detach().cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# Fp ops
# ---------------------------------------------------------------------------
def fadd(a, b):
    s = a + b
    return torch.where(s >= P, s - P, s)


def fsub(a, b):
    d = a - b
    return torch.where(d < 0, d + P, d)


def fneg(a):
    return torch.where(a == 0, a, P - a)


def fmul(a, b):
    return a * b % P


def fpow(a, e: int):
    """a ** e with a python-int exponent (square and multiply)."""
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = fmul(result, base)
        base = fmul(base, base)
        e >>= 1
    return result


def finv(a):
    return fpow(a, P - 2)


# Elementwise inverse with zero mapped to zero (0^(P-2) = 0).  Inverses are
# unique, so this equals the reference's Montgomery batch inversion element
# for element; on the device one elementwise pass beats a prefix scan.
fbatch_inv = finv


def powers(base: int, n: int, device) -> torch.Tensor:
    """[base^0, base^1, ..., base^(n-1)] as an (n,) tensor, built by
    doubling (log2 n vector products instead of n scalar ones)."""
    out = torch.ones(max(n, 1), dtype=I64, device=device)
    k = 1
    step = base % P
    while k < n:
        m = min(k, n - k)
        out[k:k + m] = out[:m] * step % P
        step = step * step % P
        k *= 2
    return out[:n]


# ---------------------------------------------------------------------------
# Fp4 ops — last axis of size 4
# ---------------------------------------------------------------------------
EXT_ZERO = np.array([0, 0, 0, 0], np.uint32)
EXT_ONE = np.array([1, 0, 0, 0], np.uint32)


def ext(x):
    """Embed an Fp tensor into Fp4 (append 3 zero coefficients)."""
    z = torch.zeros(x.shape + (3,), dtype=I64, device=x.device)
    return torch.cat([x[..., None], z], dim=-1)


def ext_one(shape, device):
    out = torch.zeros(tuple(shape) + (4,), dtype=I64, device=device)
    out[..., 0] = 1
    return out


def eadd(a, b):
    return fadd(a, b)


def esub(a, b):
    return fsub(a, b)


def eneg(a):
    return fneg(a)


def emul(a, b):
    """Schoolbook Fp4 multiply with reduction x^4 = W_EXT."""
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    b0, b1, b2, b3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]

    def m(x, y):
        return x * y % P

    # every partial sum below stays under 2^63
    c0 = (m(a0, b0) + W_EXT * ((m(a1, b3) + m(a2, b2) + m(a3, b1)) % P)) % P
    c1 = (m(a0, b1) + m(a1, b0) + W_EXT * ((m(a2, b3) + m(a3, b2)) % P)) % P
    c2 = (m(a0, b2) + m(a1, b1) + m(a2, b0) + W_EXT * m(a3, b3)) % P
    c3 = (m(a0, b3) + m(a1, b2) + m(a2, b1) + m(a3, b0)) % P
    return torch.stack([c0, c1, c2, c3], dim=-1)


def emul_fp(a_ext, b_fp):
    """Fp4 * Fp (scalar multiply each coefficient)."""
    if not isinstance(b_fp, torch.Tensor):
        return a_ext * (int(b_fp) % P) % P
    return a_ext * b_fp[..., None] % P


def epow(a, e: int):
    result = ext_one(a.shape[:-1], a.device)
    base = a
    while e > 0:
        if e & 1:
            result = emul(result, base)
        base = emul(base, base)
        e >>= 1
    return result


_FROB_S = pow(W_EXT, (P - 1) // 4, P)     # x^p = s * x, s^4 = 1


def einv(a):
    """Inverse in Fp4 via the norm map (three Frobenius conjugates):
    inv(a) = phi(a) phi^2(a) phi^3(a) / N(a), with N(a) in Fp."""
    def frob(v, k):
        mults = torch.tensor([pow(_FROB_S, i * k, P) for i in range(4)],
                             dtype=I64, device=v.device)
        return v * mults % P

    prod = emul(emul(frob(a, 1), frob(a, 2)), frob(a, 3))
    norm = emul(a, prod)              # lies in Fp: coefficients 1..3 are 0
    return emul_fp(prod, finv(norm[..., 0]))


# Elementwise Fp4 inverse; zero maps to zero (its norm is 0, and 0^-1 := 0).
ebatch_inv = einv


def epowers(z, n: int) -> torch.Tensor:
    """(..., n, 4) tables [z^0, ..., z^(n-1)] of Fp4 elements z (..., 4),
    by doubling."""
    batch = tuple(z.shape[:-1])
    out = ext_one(batch + (max(n, 1),), z.device)
    k = 1
    step = z
    while k < n:
        m = min(k, n - k)
        out[..., k:k + m, :] = emul(out[..., :m, :],
                                    step[..., None, :].expand(batch + (m, 4)))
        step = emul(step, step)
        k *= 2
    return out[..., :n, :]
