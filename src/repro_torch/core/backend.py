"""Compute backends for the prover hot loops, and the kernels' launch counts.

Two interchangeable implementations of the dispatched primitives, which
compute the same field elements bit for bit:

``cuda``
    The hand-written CUDA kernels under ``repro_torch.kernels`` (Poseidon
    permutation, NTT, Fp4 running product).  The default.
``torch``
    The plain PyTorch versions of the same functions, on any device; on the
    card it is the reference the kernels are held against.

One rule picks kernel or plain version: a kernel wrapper launches its kernel
on a CUDA tensor and takes the plain version only for a CPU tensor, so the
``cuda`` backend on the CPU device runs the plain versions.  The ``torch``
name forces them on the card too.

Selection (first hit wins): an explicit :func:`use` scope, the
``ZKGRAPH_TORCH_BACKEND`` environment variable (name only), the default
``cuda``.  The device is the scope's, else ``cuda:0``.  A CUDA device without
a card raises :class:`BackendUnavailableError`; nothing ever falls back to
the CPU by itself.  Running on the CPU is asked for explicitly, by naming the
CPU device (``use("torch", "cpu")``, ``ProverConfig(device="cpu")``).

Each kernel wrapper calls :func:`count_launch` once per kernel launch, so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Callable

import torch

ENV_VAR = "ZKGRAPH_TORCH_BACKEND"
DEFAULT = "cuda"
DEFAULT_DEVICE = "cuda:0"


class UnknownBackendError(ValueError):
    """Asked for a backend name that does not exist."""


class BackendUnavailableError(RuntimeError):
    """The selected backend cannot run here (no CUDA device)."""


@dataclass(frozen=True)
class ComputeBackend:
    name: str
    description: str
    permute: Callable          # (..., 16) int64 -> (..., 16)
    ntt: Callable              # (..., n), inverse=False -> (..., n)
    grand_product_ext: Callable  # (L?, n, 4) -> exclusive Fp4 products on n


def _cuda_permute(states):
    from ..kernels.poseidon import ops
    return ops.permute(states)


def _cuda_ntt(x, inverse: bool = False):
    from ..kernels.ntt import ops
    return ops.ntt(x, inverse=inverse)


def _cuda_grand_product_ext(x):
    from ..kernels.grand_product import ops
    return ops.grand_product_ext(x)


def _torch_permute(states):
    from ..kernels.poseidon import ref
    return ref.permute_ref(states)


def _torch_ntt(x, inverse: bool = False):
    from ..kernels.ntt import ref
    return ref.ntt_ref(x, inverse=inverse)


def _torch_grand_product_ext(x):
    from ..kernels.grand_product import ref
    return ref.grand_product_ext_ref(x)


_REGISTRY = {
    "cuda": ComputeBackend("cuda", "hand-written CUDA kernels (sm_90a)",
                           _cuda_permute, _cuda_ntt, _cuda_grand_product_ext),
    "torch": ComputeBackend("torch", "plain PyTorch versions, any device",
                            _torch_permute, _torch_ntt,
                            _torch_grand_product_ext),
}

_TLS = threading.local()


def _scopes() -> list:
    scopes = getattr(_TLS, "scopes", None)
    if scopes is None:
        scopes = _TLS.scopes = []
    return scopes


def names() -> tuple:
    return tuple(_REGISTRY)


def get(name: str) -> ComputeBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownBackendError(
            f"unknown compute backend {name!r}; available: "
            f"{', '.join(_REGISTRY)}") from None


def resolve(name: str = None, device=None) -> tuple:
    """The concrete ``(backend name, torch.device)`` a call runs under.

    Unset parts come from the innermost :func:`use` scope, then the
    environment variable (name only), then the defaults.  Raises if the
    pair cannot run here."""
    scopes = _scopes()
    if device is None:
        device = scopes[-1][1] if scopes else DEFAULT_DEVICE
    device = torch.device(device)
    if name is None:
        name = scopes[-1][0] if scopes else (os.environ.get(ENV_VAR)
                                             or DEFAULT)
    get(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise BackendUnavailableError(
            f"backend {name!r} on {device}: no CUDA device is available. "
            f"To run on the CPU, ask for it: {ENV_VAR}=torch and "
            f"device='cpu' (ProverConfig(backend='torch', device='cpu')).")
    return name, device


def active() -> ComputeBackend:
    return get(resolve()[0])


def active_device() -> torch.device:
    return resolve()[1]


@contextlib.contextmanager
def use(name: str = None, device=None):
    """Pin the backend and device within a ``with`` block (thread-local;
    nests and restores).  ``None`` parts pin whatever is active at entry."""
    scopes = _scopes()
    scopes.append(resolve(name, device))
    try:
        yield get(scopes[-1][0]), scopes[-1][1]
    finally:
        scopes.pop()


# ---------------------------------------------------------------------------
# kernel launch counts (incremented by each kernel wrapper where it launches)
# ---------------------------------------------------------------------------
# the base-field grand product and the field ops are not dispatched (as in
# repro): they launch only through their own entry points
_LAUNCHES = {"poseidon_permute": 0, "ntt_stage": 0, "grand_product_ext": 0,
             "grand_product": 0, "mulmod": 0, "fused_mul_add": 0}
_LAUNCH_LOCK = threading.Lock()


def count_launch(kernel: str, k: int = 1):
    with _LAUNCH_LOCK:
        _LAUNCHES[kernel] += k


def launch_counts() -> dict:
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts():
    with _LAUNCH_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0
