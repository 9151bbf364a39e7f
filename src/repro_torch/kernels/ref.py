"""Plain PyTorch versions of the kernels — the twins of :mod:`repro.kernels.ref`.

The CPU path of every kernel wrapper, and what the kernels are held against
on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import BlockCSR, TiledCSC

__all__ = ["decompress_tiled_ref", "sod_matmul_ref", "block_matmul_ref"]


def decompress_tiled_ref(packed: TiledCSC) -> torch.Tensor:
    """The decompression unit, element granular (scatter-add), at the
    logical shape."""
    return packed.to_dense()


def sod_matmul_ref(x: torch.Tensor, packed: TiledCSC | BlockCSR,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ decompress(packed)`` unfused: float32 accumulation, then a cast."""
    w = packed.to_dense()
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"inner dims mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    return torch.matmul(x.float(), w.float()).to(out_dtype or x.dtype)


def block_matmul_ref(x: torch.Tensor, packed: BlockCSR,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ decompress(packed)`` for a BlockCSR operand, unfused."""
    return sod_matmul_ref(x, packed, out_dtype)
