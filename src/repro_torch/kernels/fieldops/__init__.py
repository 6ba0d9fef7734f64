"""Elementwise modular multiply and multiply-add: CUDA kernel wrapper
(``ops``) and plain version (``ref``)."""
