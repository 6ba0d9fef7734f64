"""ZKGraph on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

Mirrors ``repro``'s module layout (``core/``, ``graphdb/``, ``kernels/``)
and produces the same bytes; imports neither JAX nor ``repro``."""
