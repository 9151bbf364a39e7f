"""Differentiable wrappers of the matmul kernels — twin of :mod:`repro.kernels.vjp`.

The hand-written kernels have no derivative, so each gets a
``torch.autograd.Function`` whose forward is the kernel's launch
(:func:`repro_torch.kernels.sod_matmul.sod_matmul` for a ``TiledCSC``,
:func:`repro_torch.kernels.block_matmul.block_matmul` for a ``BlockCSR``;
on a CPU tensor each wrapper runs its plain version) and whose backward is
the reference's analytical one, in plain torch:

* ``dL/dx = g @ Wᵀ``, W re-densified once (``ops.decompress``: the
  ``decompress`` kernel for a TiledCSC on the card, ``to_dense`` for a
  BlockCSR), float32 sums cast to x's dtype;
* ``dL/dvals`` gathers the dense weight cotangent ``xᵀ g`` (float32 sums)
  at the packed coordinates — the exact transpose of the decompression's
  scatter, so padding slots (row or block id ``-1``) get exactly 0 and
  fixed-mask training stays on the mask;
* a quantized operand's gradient is pulled through dequantization
  (:func:`_pull_quant`) into its float codes (fp8), ``scale`` and
  ``codebook``; int8 codes and codebook indices get ``None``.

An ``autograd.Function`` sees only the tensors it is passed, so the float
buffers go in positionally and the integer ones (``rows``; ``block_ids``,
``tile_nnz``) ride on ``ctx``; the operand is rebuilt inside.  Registry
runners call :func:`fused_matmul` / :func:`block_matmul` only when
:func:`wants_grad` says a gradient is being recorded, so serving under
``torch.inference_mode()`` launches the kernels directly.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.kernels import ops

__all__ = ["fused_matmul", "block_matmul", "wants_grad"]


def _float_fields(w) -> tuple[str, ...]:
    return ("vals" if isinstance(w, TiledCSC) else "block_vals", "scale", "codebook")


def wants_grad(x2: torch.Tensor, w) -> bool:
    """Whether autograd records this product: grad mode is on and x or one
    of the operand's float buffers requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    return x2.requires_grad or any(
        t is not None and t.requires_grad
        for t in (getattr(w, f) for f in _float_fields(w)))


def _grad_w_tiles(x2: torch.Tensor, g: torch.Tensor, shape, tile, grid) -> torch.Tensor:
    """Cotangent of the tile-padded dense weight, float32, as (Kt, Nt, bk, bn)."""
    kt, nt = grid
    bk, bn = tile
    gw = ops.mm_f32(x2.T, g)
    gw = F.pad(gw, (0, nt * bn - shape[1], 0, kt * bk - shape[0]))
    return gw.reshape(kt, bk, nt, bn).permute(0, 2, 1, 3)


def _pull_quant(qmode: str, vals, scale, codebook, nval_dims: int,
                gdq: torch.Tensor):
    """Cotangents of ``(vals, scale, codebook)`` given ``gdq``, the float32
    cotangent of the dequantized slot values: the chain rule through
    :func:`repro_torch.core.formats._dequant_values` — ``code * scale``
    (int8, fp8) or a table lookup (codebook) — as the reference's
    ``jax.vjp``.  Integer codes get ``None``."""
    if qmode == "none":
        return gdq.to(vals.dtype), None, None
    if qmode in ("int8", "fp8"):
        value_dims = tuple(range(vals.ndim - nval_dims, vals.ndim))
        gscale = (gdq * vals.float()).sum(dim=value_dims)
        gvals = None
        if vals.is_floating_point():      # fp8 codes are float leaves
            bcast = tuple(scale.shape) + (1,) * nval_dims
            gvals = (gdq * scale.reshape(bcast)).to(vals.dtype)
        return gvals, gscale, None
    if qmode == "codebook":
        gbook = torch.zeros_like(codebook, dtype=torch.float32)
        gbook.index_add_(0, vals.long().reshape(-1), gdq.reshape(-1))
        return None, None, gbook
    raise ValueError(f"unknown qmode {qmode!r}")


def _vjp(ctx, w, x2: torch.Tensor, g: torch.Tensor, nval_dims: int, slot_grads):
    """The backward of both Functions: ``gx`` through the re-densified
    weight, and the cotangents of the operand's float buffers from the
    dense weight cotangent, which ``slot_grads`` gathers at the stored
    slots (0 at padding)."""
    need_x, *need_w = ctx.needs_input_grad[:4]
    gx = gvals = gscale = gbook = None
    if need_x:
        gx = ops.mm_f32(g, ops.decompress(w).T).to(x2.dtype)
    if any(need_w):
        gdq = slot_grads(_grad_w_tiles(x2, g, w.shape, w.tile, w.grid))
        vals = w.vals if isinstance(w, TiledCSC) else w.block_vals
        gvals, gscale, gbook = _pull_quant(w.qmode, vals, w.scale, w.codebook,
                                           nval_dims, gdq)
    return gx, gvals, gscale, gbook, None, None, None


class _FusedMatmul(torch.autograd.Function):
    """``(x2, vals, scale, codebook) -> x2 @ W`` for a TiledCSC W."""

    @staticmethod
    def forward(ctx, x2, vals, scale, codebook, w, out_dtype, launch):
        from repro_torch.kernels import sod_matmul

        w = dataclasses.replace(w, vals=vals, scale=scale, codebook=codebook)
        ctx.save_for_backward(x2, vals, scale, codebook)
        ctx.rows, ctx.layout = w.rows, (w.shape, w.tile, w.qmode)
        return sod_matmul.sod_matmul(x2, w, out_dtype, **launch)

    @staticmethod
    def backward(ctx, g):
        x2, vals, scale, codebook = ctx.saved_tensors
        shape, tile, qmode = ctx.layout
        w = TiledCSC(vals=vals, rows=ctx.rows, shape=shape, tile=tile,
                     scale=scale, codebook=codebook, qmode=qmode)
        def slot_grads(tiles):          # (Kt, Nt, bk, bn) -> (Kt, Nt, cap, bn)
            rows = w.rows.long()
            gdq = torch.gather(tiles, 2, rows.clamp(0, tile[0] - 1))
            return torch.where(rows >= 0, gdq, 0.0)

        return _vjp(ctx, w, x2, g, 2, slot_grads)


class _BlockMatmul(torch.autograd.Function):
    """``(x2, block_vals, scale, codebook) -> x2 @ W`` for a BlockCSR W."""

    @staticmethod
    def forward(ctx, x2, block_vals, scale, codebook, w, out_dtype, launch):
        from repro_torch.kernels import block_matmul

        w = dataclasses.replace(w, block_vals=block_vals, scale=scale,
                                codebook=codebook)
        ctx.save_for_backward(x2, block_vals, scale, codebook)
        ctx.ids = (w.block_ids, w.tile_nnz)
        ctx.layout = (w.shape, w.tile, w.br, w.qmode)
        return block_matmul.block_matmul(x2, w, out_dtype, **launch)

    @staticmethod
    def backward(ctx, g):
        x2, block_vals, scale, codebook = ctx.saved_tensors
        shape, tile, br, qmode = ctx.layout
        block_ids, tile_nnz = ctx.ids
        w = BlockCSR(block_vals=block_vals, block_ids=block_ids, tile_nnz=tile_nnz,
                     shape=shape, tile=tile, br=br, scale=scale, codebook=codebook,
                     qmode=qmode)
        def slot_grads(tiles):  # (Kt, Nt, bk, bn) -> (Kt, Nt, bcap, br, bn)
            kt, nt = w.grid
            bk, bn = tile
            nb = bk // br
            ids = block_ids.long()
            idx = ids.clamp(0, nb - 1)[..., None, None].expand(*ids.shape, br, bn)
            gdq = torch.gather(tiles.reshape(kt, nt, nb, br, bn), 2, idx)
            return torch.where((ids >= 0)[..., None, None], gdq, 0.0)

        return _vjp(ctx, w, x2, g, 3, slot_grads)


def fused_matmul(x2: torch.Tensor, w: TiledCSC, out_dtype: torch.dtype | None,
                 launch: dict) -> torch.Tensor:
    """Differentiable ``x2 @ W`` through the fused kernel with its launch
    parameters ``launch``."""
    return _FusedMatmul.apply(x2, w.vals, w.scale, w.codebook, w, out_dtype, launch)


def block_matmul(x2: torch.Tensor, w: BlockCSR, out_dtype: torch.dtype | None,
                 launch: dict) -> torch.Tensor:
    """Differentiable ``x2 @ W`` through the block kernel with its launch
    parameters ``launch``."""
    return _BlockMatmul.apply(x2, w.block_vals, w.scale, w.codebook, w, out_dtype,
                              launch)
