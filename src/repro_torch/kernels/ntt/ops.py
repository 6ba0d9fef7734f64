"""Wrapper of the CUDA NTT kernel (``csrc/ntt.cu``).

:func:`ntt` is the radix-2 DIT transform along the last axis of an int64
tensor, natural order in and out, ``inverse=True`` including the n^-1
scale.  A tensor on the CPU goes to the plain version (``ref.ntt_ref``); a
tensor on a CUDA device goes to one launch per pass of :func:`_passes`
(the first reads through the bit-reversal permutation, the last of an
inverse scales), and anything the kernel cannot take raises.  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...core import backend
from ...core import field as F
from . import ref

KERNEL = "ntt_stage"
# most butterfly stages one pass runs in shared memory (csrc/ntt.cu
# MAX_STAGES: the kernel refuses a longer pass, and the wrapper raises)
MAX_STAGES = 11
MONT_R = (1 << 32) % F.P          # the kernel's Montgomery radix 2^32, mod P


def _passes(log_n: int) -> list[tuple[int, int]]:
    """The kernel's launches for a length 2^log_n: (first stage, stages).

    The first pass takes up to MAX_STAGES stages, the others split the rest
    evenly, so there are ceil(log_n / MAX_STAGES) passes."""
    if log_n <= MAX_STAGES:
        return [(0, log_n)] if log_n > 0 else []
    rest = log_n - MAX_STAGES
    k = -(-rest // MAX_STAGES)
    plan, s0 = [(0, MAX_STAGES)], MAX_STAGES
    for i in range(k):
        ks = rest // k + (i < rest % k)
        plan.append((s0, ks))
        s0 += ks
    return plan


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """All stage tables of ``poly._stage_twiddles`` concatenated, each
    twiddle w as w * 2^32 mod P (Montgomery form), as 32-bit words: the
    table of half-size m starts at offset m - 1 (1 + 2 + ... + n/2 = n - 1
    entries)."""
    from ...core import poly
    flat = np.concatenate(poly._stage_twiddles(n, inverse)).astype(np.uint64)
    mont = (flat * MONT_R % F.P).astype(np.int32)     # < P < 2^31
    return torch.from_numpy(mont).to(device)


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.ntt_ref(x, inverse=inverse)
    if x.device.type != "cuda":
        raise ValueError(f"ntt: unsupported device {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"ntt takes int64 tensors, got {x.dtype}")
    if x.ndim == 0:
        raise ValueError("ntt takes a tensor with a last axis")
    shape = x.shape
    n = shape[-1]
    log_n = n.bit_length() - 1
    if n < 1 or n != 1 << log_n or log_n > F.TWO_ADICITY:
        raise ValueError(f"ntt length must be a power of two, got {n}")
    flat = x.reshape(-1, n).contiguous()
    b = flat.shape[0]
    if b == 0 or n == 1:
        return flat.clone().reshape(shape)
    out = torch.empty_like(flat)
    plan = _passes(log_n)
    # the passes between the first and the last keep uint32 words
    scratch = (torch.empty(flat.shape, dtype=torch.int32, device=flat.device)
               if len(plan) > 1 else None)
    from .. import build
    lib = build.load()
    dev = flat.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    tw = _twiddles(n, bool(inverse), dev)
    scale = pow(n, F.P - 2, F.P) * MONT_R % F.P if inverse else 0
    for k, (s0, ks) in enumerate(plan):
        last = k == len(plan) - 1
        src = flat if k == 0 else scratch
        dst = out if last else scratch
        rc = lib.zk_ntt_pass(src.data_ptr(), dst.data_ptr(), tw.data_ptr(), b,
                             log_n, s0, ks, int(k == 0), int(last),
                             scale if last else 0, dev.index, stream)
        build.check(rc, "ntt pass")
        backend.count_launch(KERNEL)
    return out.reshape(shape)
