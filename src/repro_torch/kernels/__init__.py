"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), one package
per kernel with its wrapper (``ops``) and plain PyTorch version (``ref``)."""
