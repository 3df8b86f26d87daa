"""Kernels of the port: each a hand-written CUDA kernel with a plain
PyTorch version beside it."""
