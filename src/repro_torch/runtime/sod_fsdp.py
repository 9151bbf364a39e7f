"""Sparse-on-Dense at the interconnect — twin of :mod:`repro.runtime.sod_fsdp`.

The paper's trade (compressed storage, cheap local re-densify, dense
compute) applied to the two collective planes of data-parallel training:

* **Compressed weight all-gather (SoD-FSDP)** — a packed weight lives
  sharded along its Nt grid dim over the data axis (:func:`shard_packed`);
  a product all-gathers the *compressed* blocks (values and row indices,
  and the per-tile scale; ≈ 1.5·density of the dense bytes) and runs the
  rank's kernel on the whole operand (:func:`sod_fsdp_matmul`, the
  ``gather_axis`` plan of :mod:`repro_torch.runtime.spmd`).
* **Compressed gradient reduce (top-k + error feedback)** — each rank
  all-gathers only its top-k gradient coordinates and rebuilds the dense
  mean locally (:func:`compressed_grad_allreduce`): ≈ 6·ratio bytes an
  element cross the wire instead of 4 (float32).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.formats import Shard, TiledCSC
from repro_torch.optim.grad import topk_compress, topk_decompress
from repro_torch.runtime import spmd

__all__ = ["shard_packed", "sod_fsdp_matmul", "compressed_grad_allreduce",
           "collective_savings"]


# ---------------------------------------------------------------------------
# compressed weight all-gather
# ---------------------------------------------------------------------------
def _nt_block(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n = mesh.shape[axis]
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axis) * size, size).contiguous()


def shard_packed(packed: TiledCSC, mesh, axis: str = "data") -> TiledCSC:
    """This rank's Nt block of a whole packed weight on ``axis`` (the
    per-tile scale split along the same dim, the codebook replicated), on
    the mesh's device, recording where the block sits
    (``shard``), stacked or not."""
    nd = packed.vals.ndim
    kt, nt = packed.grid
    if nt % mesh.shape[axis]:
        raise ValueError(f"Nt={nt} not divisible by {axis}={mesh.shape[axis]}")
    dev = mesh.device
    kw = {"vals": _nt_block(packed.vals, nd - 3, mesh, axis).to(dev),
          "rows": _nt_block(packed.rows, nd - 3, mesh, axis).to(dev)}
    if packed.scale is not None:
        kw["scale"] = _nt_block(packed.scale, packed.scale.ndim - 1, mesh, axis).to(dev)
    if packed.codebook is not None:
        kw["codebook"] = packed.codebook.to(dev)
    bn = packed.tile[1]
    return dataclasses.replace(packed, **kw,
                               shape=(packed.shape[0], nt // mesh.shape[axis] * bn),
                               shard=Shard(tuple(packed.shape), (kt, nt), None, axis))


class _GatherNt(torch.autograd.Function):
    """All-gather along ``dim`` over ``axis``; the cotangent is replicated,
    so its transpose takes this rank's block."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return spmd.all_gather(t, mesh, axis, dim, "gather_bytes")

    @staticmethod
    def backward(ctx, g):
        return _nt_block(g, ctx.dim, ctx.mesh, ctx.axis), None, None, None


def _gather(t, mesh, axis, dim):
    if t.is_floating_point() and torch.is_grad_enabled() and t.requires_grad:
        return _GatherNt.apply(t, mesh, axis, dim)
    return spmd.all_gather(t, mesh, axis, dim, "gather_bytes")


def sod_fsdp_matmul(x: torch.Tensor, packed: TiledCSC, mesh, axis: str = "data",
                    impl: str = "auto") -> torch.Tensor:
    """``x @ W`` with W stored compressed and Nt-sharded on ``axis``
    (:func:`shard_packed`, or whole: the rank then keeps its own block).
    ``x`` is the global activation on every rank (the FSDP situation:
    weights gathered per layer); returns the global product on every rank.

    A 2-D operand runs the ``gather_axis`` plan of
    :func:`repro_torch.runtime.spmd.sod_matmul_spmd`: the registry's kernel
    under a mesh-qualified key on the gathered compressed operand.  A
    stacked (lead-dim) operand gathers its compressed leaves explicitly,
    re-densifies them locally and multiplies each matrix (``mk,...kn``),
    as the reference's stacked path does."""
    if packed.vals.ndim == 4:
        return spmd.sod_matmul_spmd(x, packed, mesh=mesh,
                                    plan=spmd.SpmdPlan(gather_axis=axis),
                                    impl=impl, out_dtype=x.dtype)
    if packed.shard is None:      # whole on this rank: keep its own block
        packed = shard_packed(packed, mesh, axis)
    nd = packed.vals.ndim
    w = dataclasses.replace(
        packed, vals=_gather(packed.vals, mesh, axis, nd - 3),
        rows=_gather(packed.rows, mesh, axis, nd - 3),
        scale=(None if packed.scale is None
               else _gather(packed.scale, mesh, axis, packed.scale.ndim - 1)),
        shape=packed.shard.shape, shard=None)
    dense = w.to_dense()
    dtype = torch.promote_types(x.dtype, dense.dtype)
    return torch.einsum("mk,...kn->...mn", x.to(dtype), dense.to(dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# compressed gradient all-reduce
# ---------------------------------------------------------------------------
def compressed_grad_allreduce(grad: torch.Tensor, mesh, ratio: float,
                              axis: str = "data", error: torch.Tensor | None = None):
    """Mean over ``axis`` of every rank's local ``grad``, moving only each
    rank's top-k coordinates and indices.

    ``grad`` and ``error`` are this rank's (the reference's per-shard
    blocks).  Returns (the dense mean, float32, the same on every rank of
    the line; the new error-feedback residual): the residual keeps the
    dropped coordinates for the next step (DGC-style)."""
    if error is None:
        error = torch.zeros_like(grad, dtype=torch.float32)
    g_fb = grad.float() + error
    vals, idx, resid = topk_compress(g_fb, ratio)
    all_vals = spmd.all_gather(vals, mesh, axis, 0, "gather_bytes")
    all_idx = spmd.all_gather(idx, mesh, axis, 0, "gather_bytes")
    dense = topk_decompress(all_vals, all_idx, grad.shape)
    return dense / mesh.shape[axis], resid


def collective_savings(density: float, ratio: float | None = None,
                       qmode: str = "none") -> dict:
    """The reference's napkin numbers: the gathered fraction of the dense
    bytes, ``(value bytes + 1 B index) / 2 B · density`` (int8 / fp8 values
    1 B, 4-bit codebook indices 0.5 B; the side bands vanish in the
    napkin), and ``1.5 · ratio`` for the top-k gradient reduce."""
    from repro_torch.core.plan import QVALUE_BITS

    vbytes = QVALUE_BITS.get(qmode, 16) / 8.0
    out = {"weight_allgather_fraction": (vbytes + 1.0) / 2.0 * density}
    if ratio is not None:
        out["grad_reduce_fraction"] = 1.5 * ratio
    return out
