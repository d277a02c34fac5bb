"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), their
wrappers, and the plain PyTorch versions they are held against (``ref``)."""
