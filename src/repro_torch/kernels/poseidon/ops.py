"""Wrapper of the CUDA Poseidon kernel (``csrc/poseidon.cu``).

:func:`permute` takes (..., 16) int64 states.  A tensor on the CPU goes to
the plain version (``ref.permute_ref``); a tensor on a CUDA device goes to
the kernel, and anything the kernel cannot take raises.  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...core import backend
from . import ref

KERNEL = "poseidon_permute"


@functools.lru_cache(maxsize=None)
def _params(device: torch.device) -> torch.Tensor:
    """MDS (row-major) then round constants, one int64 buffer per device."""
    from ...core import hashing
    mds, rc = hashing._params()
    flat = np.concatenate([mds.reshape(-1), rc.reshape(-1)]).astype(np.int64)
    return torch.from_numpy(flat).to(device)


def permute(states: torch.Tensor) -> torch.Tensor:
    """Apply the permutation to (..., 16) states."""
    if states.device.type == "cpu":
        return ref.permute_ref(states)
    if states.device.type != "cuda":
        raise ValueError(f"poseidon permute: unsupported device {states.device}")
    if states.dtype != torch.int64:
        raise TypeError(f"poseidon permute takes int64 states, got {states.dtype}")
    if states.ndim == 0 or states.shape[-1] != 16:
        raise ValueError(f"poseidon permute takes (..., 16) states, got "
                         f"{tuple(states.shape)}")
    shape = states.shape
    flat = states.reshape(-1, 16).contiguous()
    out = torch.empty_like(flat)
    n = flat.shape[0]
    if n == 0:
        return out.reshape(shape)
    from .. import build
    lib = build.load()
    dev = flat.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.zk_poseidon_permute(flat.data_ptr(), out.data_ptr(),
                                 _params(dev).data_ptr(), n, dev.index, stream)
    build.check(rc, "poseidon permute")
    backend.count_launch(KERNEL)
    return out.reshape(shape)
