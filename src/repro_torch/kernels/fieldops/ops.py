"""Wrapper of the CUDA elementwise field kernel (``csrc/fieldops.cu``).

:func:`mulmod` and :func:`fused_mul_add` take int64 tensors of one shape,
any shape and size, and work on them flattened.  Tensors on the CPU go to
the plain versions (``ref``); tensors on a CUDA device go to the kernel,
one launch per call, and anything the kernel cannot take raises.  There is
no fallback from the kernel to the plain version, and no padding.
"""
from __future__ import annotations

import torch

from ...core import backend
from . import ref


def mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a * b mod P."""
    _check("mulmod", a, b)
    if a.device.type == "cpu":
        return ref.mulmod_ref(a, b)
    return _launch("mulmod", a, b, None)


def fused_mul_add(a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """Elementwise (a * b + c) mod P in one pass."""
    _check("fused_mul_add", a, b, c)
    if a.device.type == "cpu":
        return ref.fused_mul_add_ref(a, b, c)
    return _launch("fused_mul_add", a, b, c)


def _check(kernel: str, *xs: torch.Tensor):
    if any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"{kernel} takes tensors of one shape, got "
                         f"{[tuple(x.shape) for x in xs]}")
    if any(x.device != xs[0].device for x in xs):
        raise ValueError(f"{kernel} takes tensors on one device, got "
                         f"{[str(x.device) for x in xs]}")


def _launch(kernel: str, a, b, c) -> torch.Tensor:
    xs = (a, b) if c is None else (a, b, c)
    if a.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {a.device}")
    if any(x.dtype != torch.int64 for x in xs):
        raise TypeError(f"{kernel} takes int64 tensors, got "
                        f"{[x.dtype for x in xs]}")
    flat = [x.reshape(-1).contiguous() for x in xs]
    out = torch.empty_like(flat[0])
    n = out.numel()
    if n == 0:
        return out.reshape(a.shape)
    from .. import build
    lib = build.load()
    dev = a.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.zk_fieldops(flat[0].data_ptr(), flat[1].data_ptr(),
                         flat[2].data_ptr() if c is not None else None,
                         out.data_ptr(), n, dev.index, stream)
    build.check(rc, kernel)
    backend.count_launch(kernel)
    return out.reshape(a.shape)
