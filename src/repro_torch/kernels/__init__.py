"""Kernels: plain PyTorch versions, hand-written CUDA kernels and their wrappers."""
