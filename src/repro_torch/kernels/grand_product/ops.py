"""Wrapper of the CUDA running-product kernel (``csrc/grand_product.cu``).

:func:`grand_product` takes (n,) or (L, n) Fp elements and
:func:`grand_product_ext` (n, 4) or (L, n, 4) Fp4 elements, n >= 1, int64
(any values: they are reduced mod P, floored, as the plain version does);
each returns the exclusive running product along n of every lane (Z[0] =
1), in the input's shape.  A tensor on the CPU goes to the plain version
(``ref``); a tensor on a CUDA device goes to the kernel's one launch for
all lanes (a single-pass scan with decoupled look-back), and anything the
kernel cannot take raises.  There is no fallback from the kernel to the
plain version, and no padding: any n works.
"""
from __future__ import annotations

import torch

from ...core import backend
from . import ref

LAUNCHES_PER_CALL = 1


def grand_product(x: torch.Tensor) -> torch.Tensor:
    """Exclusive running product of (n,) or (L, n) Fp elements along n."""
    if x.ndim not in (1, 2):
        raise ValueError(f"grand_product takes (n,) or (L, n) elements, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.grand_product_ref(x)
    return _launch(x, ext=False, kernel="grand_product")


def grand_product_ext(x: torch.Tensor) -> torch.Tensor:
    """Exclusive running product of (n, 4) or (L, n, 4) Fp4 elements along
    n."""
    if x.ndim not in (2, 3) or x.shape[-1] != 4:
        raise ValueError(f"grand_product_ext takes (n, 4) or (L, n, 4) "
                         f"elements, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.grand_product_ext_ref(x)
    return _launch(x, ext=True, kernel="grand_product_ext")


def _launch(x: torch.Tensor, ext: bool, kernel: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"{kernel} takes int64 elements, got {x.dtype}")
    lanes_shape = x.shape[:-2] if ext else x.shape[:-1]
    n = x.shape[-2] if ext else x.shape[-1]
    lanes = lanes_shape.numel()
    if n == 0 or lanes == 0:
        raise ValueError(f"{kernel} takes n >= 1 elements in L >= 1 lanes, "
                         f"got {tuple(x.shape)}")
    flat = x.contiguous()
    if flat.data_ptr() % 16:
        flat = flat.clone()           # the kernel loads 16-byte words
    out = torch.empty_like(flat)
    from .. import build
    lib = build.load()
    scratch = torch.empty(lib.zk_grand_product_scratch(n, lanes, int(ext)),
                          dtype=torch.int32, device=flat.device)
    dev = flat.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.zk_grand_product(flat.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), n, lanes, int(ext),
                              dev.index, stream)
    build.check(rc, kernel)
    backend.count_launch(kernel, LAUNCHES_PER_CALL)
    return out
