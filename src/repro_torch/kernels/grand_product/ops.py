"""Wrapper of the CUDA running-product kernels (``csrc/grand_product.cu``).

:func:`grand_product` takes (n,) Fp elements and :func:`grand_product_ext`
(n, 4) Fp4 elements, n >= 1, both int64; each returns the exclusive running
product (Z[0] = 1).  A tensor on the CPU goes to the plain version
(``ref``); a tensor on a CUDA device goes to the kernel's three launches
(chunk scans, the scan of the chunk totals, the chunk offsets), and
anything the kernel cannot take raises.  There is no fallback from the
kernel to the plain version, and no padding: any n works.
"""
from __future__ import annotations

import torch

from ...core import backend
from . import ref

LAUNCHES_PER_CALL = 3


def grand_product(x: torch.Tensor) -> torch.Tensor:
    """Exclusive running product of (n,) Fp elements."""
    if x.ndim != 1:
        raise ValueError(f"grand_product takes (n,) elements, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.grand_product_ref(x)
    return _launch(x, ext=False, kernel="grand_product")


def grand_product_ext(x: torch.Tensor) -> torch.Tensor:
    """Exclusive running product of (n, 4) Fp4 elements."""
    if x.ndim != 2 or x.shape[1] != 4:
        raise ValueError(f"grand_product_ext takes (n, 4) elements, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.grand_product_ext_ref(x)
    return _launch(x, ext=True, kernel="grand_product_ext")


def _launch(x: torch.Tensor, ext: bool, kernel: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"{kernel} takes int64 elements, got {x.dtype}")
    n = x.shape[0]
    if n == 0:
        raise ValueError(f"{kernel} takes n >= 1 elements")
    flat = x.contiguous()
    out = torch.empty_like(flat)
    from .. import build
    lib = build.load()
    chunks = -(-n // lib.zk_grand_product_chunk())
    totals = flat.new_empty((chunks,) + tuple(flat.shape[1:]))
    offsets = torch.empty_like(totals)
    dev = flat.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.zk_grand_product(flat.data_ptr(), out.data_ptr(),
                              totals.data_ptr(), offsets.data_ptr(), n,
                              int(ext), dev.index, stream)
    build.check(rc, kernel)
    backend.count_launch(kernel, LAUNCHES_PER_CALL)
    return out
