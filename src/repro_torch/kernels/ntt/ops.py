"""Wrapper of the CUDA NTT stage kernel (``csrc/ntt.cu``).

:func:`ntt` is the radix-2 DIT transform along the last axis of an int64
tensor, natural order in and out, ``inverse=True`` including the n^-1
scale.  A tensor on the CPU goes to the plain version (``ref.ntt_ref``); a
tensor on a CUDA device goes to log2(n) launches of the stage kernel (the
first gathers through the bit-reversal permutation, the last of an inverse
scales), and anything the kernel cannot take raises.  There is no fallback
from the kernel to the plain version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...core import backend
from ...core import field as F
from . import ref

KERNEL = "ntt_stage"


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """All stage tables concatenated: the table of half-size m starts at
    offset m - 1 (1 + 2 + ... + n/2 = n - 1 entries)."""
    from ...core import poly
    tables = poly._stage_twiddles(n, inverse)
    flat = np.concatenate(tables).astype(np.int64)
    return torch.from_numpy(flat).to(device)


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
    from .. import build
    lib = build.load()
    dev = flat.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    tw = _twiddles(n, bool(inverse), dev)
    n_inv = pow(n, F.P - 2, F.P) if inverse else 0
    src = flat
    for log_m in range(log_n):
        m = 1 << log_m
        scale = n_inv if log_m == log_n - 1 else 0
        rc = lib.zk_ntt_stage(src.data_ptr(), out.data_ptr(),
                              tw.data_ptr() + 8 * (m - 1), b, log_n, log_m,
                              int(log_m == 0), scale, dev.index, stream)
        build.check(rc, "ntt stage")
        backend.count_launch(KERNEL)
        src = out
    return out.reshape(shape)
