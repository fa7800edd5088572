"""Kernels of the port: plain PyTorch versions and their CUDA wrappers."""
