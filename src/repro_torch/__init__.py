"""Sparse-on-Dense in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package :mod:`repro`, module for module: the tree under
``repro_torch/`` mirrors ``repro/`` (``core/formats.py`` is the twin of
``repro/core/formats.py`` and so on), and each ported module answers to its
JAX twin in the ``tests/test_torch_*.py`` parity tests.

The port imports ``torch``, numpy and the standard library only — never
``jax`` and nothing of ``repro``.  Its entry points run on CUDA unless the
caller asks for the CPU; on a CPU tensor every kernel wrapper takes the
kernel's plain PyTorch version, on a CUDA tensor it launches the kernel.
"""
