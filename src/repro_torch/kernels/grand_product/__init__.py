"""Exclusive running products (Eq. (2)) over Fp and Fp4: CUDA kernel
wrapper (``ops``) and plain version (``ref``)."""
