"""Plain PyTorch versions of the kernels — the twins of :mod:`repro.kernels.ref`.

The CPU path of every kernel wrapper, and what the kernels are held against
on the card.  A quantized operand is dequantized through ``to_dense()``,
which gives its float32 weight.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import BlockCSR, TiledCSC

__all__ = ["decompress_tiled_ref", "decompress_block_ref", "sod_matmul_ref",
           "block_matmul_ref", "dense_matmul_ref"]


def decompress_tiled_ref(packed: TiledCSC,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The decompression unit, element granular (scatter-add), at the
    logical shape: in the value dtype (float32 for a quantized operand), or
    cast to ``out_dtype``."""
    dense = packed.to_dense()
    return dense if out_dtype is None else dense.to(out_dtype)


def decompress_block_ref(packed: BlockCSR) -> torch.Tensor:
    """A BlockCSR's dense matrix at the logical shape, in the value dtype
    (float32 for a quantized operand)."""
    return packed.to_dense()


def dense_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` with float32 sums, cast to ``out_dtype`` (x's dtype by
    default)."""
    return torch.matmul(x.float(), w.float()).to(out_dtype or x.dtype)


def sod_matmul_ref(x: torch.Tensor, packed: TiledCSC | BlockCSR,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ decompress(packed)`` unfused: the weight in its value dtype (or
    dequantized to float32), float32 accumulation, then a cast."""
    w = packed.to_dense()
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"inner dims mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    return dense_matmul_ref(x, w, out_dtype)


def block_matmul_ref(x: torch.Tensor, packed: BlockCSR,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ decompress(packed)`` for a BlockCSR operand, unfused."""
    return sod_matmul_ref(x, packed, out_dtype)
