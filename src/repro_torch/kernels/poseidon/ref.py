"""Plain PyTorch version of the Poseidon permutation: the CPU path of
:func:`ops.permute` and the oracle the CUDA kernel is held against.

It is ``hashing.permute_ref`` itself, never the backend-dispatching
``hashing.permute``, so the oracle stays plain whatever backend is active."""
from ...core.hashing import permute_ref

__all__ = ["permute_ref"]
