"""Radix-2 NTT: CUDA kernel wrapper (``ops``) and plain version (``ref``)."""
