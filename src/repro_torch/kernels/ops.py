"""Public entry points over dense and packed weights.

Twin of :mod:`repro.kernels.ops` without the kernel registry, the autotuner
and SPMD routing (not ported yet): a dense weight flows straight to
:func:`dense_matmul` (the paper's decompression bypass, Fig. 2c); a
:class:`~repro_torch.core.formats.TiledCSC` goes to the fused kernel wrapper
and a :class:`~repro_torch.core.formats.BlockCSR` to the block kernel
wrapper, with the input flattened to 2-D.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.kernels import block_matmul as block_matmul_kernel
from repro_torch.kernels import decompress as decompress_kernel
from repro_torch.kernels import sod_matmul as sod_matmul_kernel

__all__ = ["sod_matmul", "decompress", "dense_matmul"]


def dense_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` for a dense 2-D ``w``, as the reference's ``jnp.dot(x, w,
    preferred_element_type=float32).astype(out_dtype)``: the operands
    promoted to one dtype (bf16 activations meet an f32 weight as f32),
    products summed in float32, the sums cast once to ``out_dtype``.

    On CUDA with 16-bit operands one cuBLAS call keeps the f32 sums
    (``aten::mm.dtype``); the CPU build has no such kernel, so there the
    operands are widened first, which gives the same sums of exact products.
    """
    dtype = torch.promote_types(x.dtype, w.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(x2.to(dtype), w.to(dtype), out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), w.float())
    return y.to(out_dtype).reshape(*x.shape[:-1], w.shape[-1])


def sod_matmul(x: torch.Tensor, w, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ W`` for ``x`` of shape (..., K); returns (..., N) in
    ``out_dtype`` (default: ``x.dtype``).  A packed W whose values have
    another dtype than x is computed in the promoted dtype (``_promote``)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, TiledCSC):
        kernel = sod_matmul_kernel.sod_matmul
    elif isinstance(w, BlockCSR):
        kernel = block_matmul_kernel.block_matmul
    else:
        return dense_matmul(x, w, out_dtype)
    k, n = w.shape
    if x.shape[-1] != k:
        raise ValueError(f"x inner dim {x.shape[-1]} != W K {k}")
    x, w = _promote(x, w)
    lead = x.shape[:-1]
    y = kernel(x.reshape(-1, k).contiguous(), w, out_dtype)
    return y.reshape(*lead, n)


def _promote(x: torch.Tensor, w):
    """x and a packed qmode-``none`` w whose value dtype differs from x's,
    both in their promoted dtype, as the reference's ``jnp.dot`` promotes
    them (bf16 meets f32 as f32; both widenings are exact).  The kernels
    take one dtype, so the values are widened in a copy, once per call: no
    serving path mixes dtypes.  Quantized codes are left to the kernel
    wrapper, which checks them."""
    if w.qmode != "none" or w.dtype == x.dtype:
        return x, w
    dtype = torch.promote_types(x.dtype, w.dtype)
    field = "vals" if isinstance(w, TiledCSC) else "block_vals"
    return x.to(dtype), dataclasses.replace(w, **{field: getattr(w, field).to(dtype)})


def decompress(w) -> torch.Tensor:
    """Dense matrix of a packed operand at its logical shape: a ``TiledCSC``
    through the decompression kernel, a ``BlockCSR`` through its scatter,
    each in its value dtype, or float32 when quantized (as the reference);
    a dense tensor comes back unchanged."""
    if isinstance(w, TiledCSC):
        return decompress_kernel.decompress(w)
    if isinstance(w, BlockCSR):
        return w.to_dense()
    return w
