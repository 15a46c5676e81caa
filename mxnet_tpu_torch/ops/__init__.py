"""Operators of the port: plain PyTorch functions, and the hand-written
CUDA kernels that replace the JAX package's Pallas kernels."""
