"""Poseidon permutation: CUDA kernel wrapper (``ops``) and plain version
(``ref``)."""
