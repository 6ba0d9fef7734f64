"""Plain PyTorch version of the NTT: the CPU path of :func:`ops.ntt` and the
oracle the CUDA kernel is held against.

It is ``poly.ntt_ref`` itself, never the backend-dispatching ``poly.ntt``,
so the oracle stays plain whatever backend is active."""
from ...core.poly import ntt_ref

__all__ = ["ntt_ref"]
