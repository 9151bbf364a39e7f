"""Public matmul entry point over dense and packed weights.

Twin of :mod:`repro.kernels.ops` without the kernel registry, the autotuner
and SPMD routing (not ported yet): a dense weight flows straight to
``torch.matmul`` (the paper's decompression bypass, Fig. 2c); a
:class:`~repro_torch.core.formats.TiledCSC` goes to the fused kernel wrapper
with the input flattened to 2-D.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import TiledCSC
from repro_torch.kernels import sod_matmul as sod_matmul_kernel

__all__ = ["sod_matmul"]


def sod_matmul(x: torch.Tensor, w, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ W`` for ``x`` of shape (..., K); returns (..., N) in
    ``out_dtype`` (default: ``x.dtype``)."""
    out_dtype = out_dtype or x.dtype
    if not isinstance(w, TiledCSC):
        return torch.matmul(x, w).to(out_dtype)
    k, n = w.shape
    if x.shape[-1] != k:
        raise ValueError(f"x inner dim {x.shape[-1]} != W K {k}")
    lead = x.shape[:-1]
    y = sod_matmul_kernel.sod_matmul(x.reshape(-1, k).contiguous(), w, out_dtype)
    return y.reshape(*lead, n)
