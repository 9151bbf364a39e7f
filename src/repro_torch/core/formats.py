"""The executable Sparse-on-Dense format: :class:`TiledCSC` in PyTorch.

Twin of :mod:`repro.core.formats` for the element-granular, paper-faithful
format.  The matrix is cut into (bk, bn) tiles; each tile column stores up to
``cap`` non-zeros as (value, in-tile row index).  Padding slots carry value 0
and the sentinel row ``-1``.

Packing is bit-for-bit the JAX package's: the same stable sorts on the same
keys, so ``vals`` and ``rows`` come out equal, padding order included (with
``cap < bk`` the kept slots are re-sorted by row id *with* the padding slots,
so ``-1`` sentinels sit between real rows — no consumer may stop at the
first ``-1``).

BlockCSR, the Bitmap/CSC footprint formats and the quantized ``qmode`` value
storage are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

__all__ = ["TiledCSC", "pack_tiled_csc", "padded_shape", "observed_tiled_cap"]

# Paper accounting: 16-bit values (qmode "none"), 8-bit row indices.
VALUE_BITS, INDEX_BITS = 16, 8


def padded_shape(shape: tuple[int, int], tile: tuple[int, int]) -> tuple[int, int]:
    """Round ``shape`` up to whole multiples of ``tile``."""
    bk, bn = tile
    k, n = shape
    return ((k + bk - 1) // bk * bk, (n + bn - 1) // bn * bn)


def _pad_to_tiles(w: torch.Tensor, tile: tuple[int, int]) -> torch.Tensor:
    k, n = w.shape[-2:]
    kp, np_ = padded_shape((k, n), tile)
    if (kp, np_) != (k, n):
        w = F.pad(w, (0, np_ - n, 0, kp - k))
    return w


def observed_tiled_cap(w: torch.Tensor, tile: tuple[int, int]) -> int:
    """Max per-tile-column non-zero count over a (possibly stacked) matrix —
    the data-dependent capacity :func:`pack_tiled_csc` uses (unaligned)."""
    if not w.numel():
        return 0
    bk, bn = tile
    wp = _pad_to_tiles(w.reshape((-1,) + tuple(w.shape[-2:])), tile)
    kp, np_ = wp.shape[-2:]
    t = wp.reshape(wp.shape[0], kp // bk, bk, np_ // bn, bn)
    return int((t != 0).sum(dim=2).max())


@dataclasses.dataclass
class TiledCSC:
    """Per-(bk, bn)-tile padded CSC.

    ``vals[kt, nt, s, j]`` is the s-th stored slot of column ``j`` of tile
    ``(kt, nt)`` and ``rows[kt, nt, s, j]`` its in-tile row index; padding
    slots hold value 0 and row ``-1``.  Leading dims ahead of ``(Kt, Nt)``
    are layer stacks packed with one shared ``cap``.
    """

    vals: torch.Tensor   # (*lead, Kt, Nt, cap, bn)
    rows: torch.Tensor   # same shape, int8 (bk <= 128) or int32
    shape: tuple[int, int]   # logical (K, N) before tile padding
    tile: tuple[int, int]
    qmode: str = "none"

    @property
    def cap(self) -> int:
        """Padded slot count per tile column."""
        return self.vals.shape[-2]

    @property
    def grid(self) -> tuple[int, int]:
        """``(Kt, Nt)`` tile-grid extents."""
        return self.vals.shape[-4], self.vals.shape[-3]

    @property
    def lead(self) -> tuple[int, ...]:
        """Leading stack dims ahead of the grid."""
        return tuple(self.vals.shape[:-4])

    @property
    def dtype(self) -> torch.dtype:
        """Stored value dtype."""
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        """Device holding the buffers."""
        return self.vals.device

    def layer(self, i: int) -> "TiledCSC":
        """Slice ``i`` of a stacked operand (first lead dim)."""
        if not self.lead:
            raise ValueError("operand has no stack dim to slice")
        return TiledCSC(vals=self.vals[i], rows=self.rows[i], shape=self.shape,
                        tile=self.tile, qmode=self.qmode)

    def nbytes_compressed(self) -> int:
        """Footprint under the paper's encoding (value + index per slot)."""
        return self.vals.numel() * (VALUE_BITS + INDEX_BITS) // 8

    def nbytes_dense(self) -> int:
        """Dense-equivalent 16-bit bytes (lead dims included)."""
        kp, np_ = padded_shape(self.shape, self.tile)
        n_lead = 1
        for d in self.lead:
            n_lead *= int(d)
        return n_lead * kp * np_ * VALUE_BITS // 8

    def to_dense(self) -> torch.Tensor:
        """Scatter the stored slots back into a dense ``(*lead, K, N)``.

        The sentinel is masked before the scatter: torch would wrap row
        ``-1`` to the tile's last row, so padding slots scatter a zero into
        row 0 instead (exact: every real slot is non-zero and rows are unique
        per column).
        """
        kt_n, nt_n = self.grid
        bk, bn = self.tile
        vals = self.vals.reshape((-1, kt_n, nt_n, self.cap, bn))
        rows = self.rows.reshape(vals.shape).long()
        valid = rows >= 0
        dense = torch.zeros((vals.shape[0], kt_n, nt_n, bk, bn),
                            dtype=vals.dtype, device=vals.device)
        dense.scatter_add_(3, rows.clamp(min=0),
                           torch.where(valid, vals, torch.zeros_like(vals)))
        dense = dense.permute(0, 1, 3, 2, 4).reshape(
            vals.shape[0], kt_n * bk, nt_n * bn)
        k, n = self.shape
        return dense[:, :k, :n].reshape(self.lead + (k, n))


def pack_tiled_csc(w: torch.Tensor, tile: tuple[int, int] = (128, 128),
                   cap: int | None = None) -> TiledCSC:
    """Pack a dense matrix into :class:`TiledCSC`, as the JAX package does.

    ``cap=None`` takes the exact max column non-zero count over all tiles
    (lossless), rounded up to 8.  A smaller ``cap`` keeps the ``cap``
    largest-magnitude entries per tile column.  Leading dims (layer stacks)
    are packed with one shared cap.  Row indices are int8 for ``bk <= 128``
    (int32 above).
    """
    if w.ndim > 2:
        lead = tuple(w.shape[:-2])
        flat = w.reshape((-1,) + tuple(w.shape[-2:]))
        if cap is None:
            cap = max((observed_tiled_cap(w, tile) + 7) // 8 * 8, 8)
        packed = [pack_tiled_csc(flat[i], tile, cap)
                  for i in range(flat.shape[0])]
        vals = torch.stack([p.vals for p in packed])
        rows = torch.stack([p.rows for p in packed])
        return TiledCSC(vals=vals.reshape(lead + tuple(vals.shape[1:])),
                        rows=rows.reshape(lead + tuple(rows.shape[1:])),
                        shape=tuple(w.shape[-2:]), tile=tuple(tile))
    if w.ndim != 2:
        raise ValueError(f"expected >=2-D matrix, got {tuple(w.shape)}")
    bk, bn = tile
    shape = tuple(w.shape)
    wp = _pad_to_tiles(w, tile)
    kp, np_ = wp.shape
    kt_n, nt_n = kp // bk, np_ // bn
    tiles = wp.reshape(kt_n, bk, nt_n, bn).permute(0, 2, 1, 3)  # (Kt, Nt, bk, bn)

    nz = tiles != 0
    if cap is None:
        cap = int(nz.sum(dim=2).max()) if wp.numel() else 0
        cap = max(cap, 1)
        cap = (cap + 7) // 8 * 8
    # Non-zeros first in ascending row order (stable sort), as the reference.
    order = torch.argsort((~nz).to(torch.int32), dim=2, stable=True)
    gathered = torch.gather(tiles, 2, order)
    gathered_nz = torch.gather(nz, 2, order)
    if cap < bk:
        # keep the largest |value| entries, then restore ascending row order
        # within the kept set — padding slots included, as the reference
        key = torch.where(gathered_nz, -gathered.float().abs(),
                          torch.full_like(gathered, float("inf"),
                                          dtype=torch.float32))
        keep = torch.argsort(key, dim=2, stable=True)[:, :, :cap, :]
        vals = torch.gather(gathered, 2, keep)
        row_ids = torch.gather(order, 2, keep)
        asc = torch.argsort(row_ids, dim=2, stable=True)
        rows = torch.gather(row_ids, 2, asc)
        vals = torch.gather(vals, 2, asc)
        valid = torch.gather(torch.gather(gathered_nz, 2, keep), 2, asc)
    else:
        vals = gathered[:, :, :bk, :]
        rows = order[:, :, :bk, :]
        valid = gathered_nz[:, :, :bk, :]
        if cap > bk:  # degenerate: more slots than rows
            pad = (0, 0, 0, cap - bk)
            vals, rows, valid = F.pad(vals, pad), F.pad(rows, pad), F.pad(valid, pad)
    vals = torch.where(valid, vals, torch.zeros_like(vals)).to(w.dtype)
    rows = torch.where(valid, rows, torch.full_like(rows, -1))
    index_dtype = torch.int8 if bk <= 128 else torch.int32
    return TiledCSC(vals=vals.contiguous(), rows=rows.to(index_dtype).contiguous(),
                    shape=shape, tile=(bk, bn))
