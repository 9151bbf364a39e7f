"""The Sparse-on-Dense formats in PyTorch: the executable :class:`TiledCSC`
and :class:`BlockCSR`, and the footprint formats :class:`Bitmap` (SIGMA's)
and the classic pointer CSC.

Twin of :mod:`repro.core.formats`.
``TiledCSC`` is the element-granular, paper-faithful one: the matrix is cut
into (bk, bn) tiles; each tile column stores up to ``cap`` non-zeros as
(value, in-tile row index).  Padding slots carry value 0 and the sentinel row
``-1``.  ``BlockCSR`` stores whole (br, bn) sub-blocks of each (bk, bn) macro
tile, with in-tile block ids (``-1`` = padding) and a per-tile count.

Packing is bit-for-bit the JAX package's: the same stable sorts on the same
keys, so ``vals`` and ``rows`` come out equal, padding order included (with
``cap < bk`` the kept slots are re-sorted by row id *with* the padding slots,
so ``-1`` sentinels sit between real rows — no consumer may stop at the
first ``-1``).

Quantized value storage (``qmode``) is the reference's: ``"int8"`` and
``"fp8"`` store codes with one f32 scale per (bk, bn) tile, ``"codebook"``
stores int8 indices into one shared-value table per lead slice (entry 0 is
0.0), fitted with the same numpy Lloyd k-means.  Quantization happens after
packing (:func:`quantize_packed`); ``to_dense`` of a quantized operand
dequantizes first and returns float32.

The footprint formats count bytes for the paper's cost model: a
:class:`Bitmap` (1 bit an element and the non-zeros in row-major order,
padded to ``cap``) and a pointer CSC in numpy (:func:`pack_csc`,
:func:`csc_nbytes`), exact as the reference's.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.plan import CODEBOOK_SIZE, QMODES, QVALUE_BITS, SCALE_BITS

__all__ = ["Shard", "TiledCSC", "pack_tiled_csc", "padded_shape", "observed_tiled_cap",
           "BlockCSR", "pack_block_csr", "observed_block_cap",
           "quantize_packed", "qvalue_bits", "fp8_dtype", "QMODES",
           "CODEBOOK_SIZE", "density", "Bitmap", "pack_bitmap", "pack_csc",
           "unpack_csc", "csc_nbytes"]

# Paper accounting: 16-bit values (qmode "none"), 8-bit row indices; BlockCSR
# counts its block ids at 16 bits.
VALUE_BITS, INDEX_BITS, BLOCK_ID_BITS = 16, 8, 16


def fp8_dtype() -> torch.dtype:
    """The fp8 value dtype of qmode ``"fp8"``."""
    return torch.float8_e4m3fn


def qvalue_bits(qmode: str, ncodes: int = CODEBOOK_SIZE) -> int:
    """Paper-accounting bits per stored value slot under ``qmode``: 16
    unquantized, 8 for int8/fp8, the index width for codebook
    (``ceil(log2(ncodes))``, 4 at the default table size)."""
    if qmode == "codebook":
        return max(int(np.ceil(np.log2(max(ncodes, 2)))), 1)
    qmode = qmode or "none"
    if qmode not in QVALUE_BITS:
        raise ValueError(f"unknown qmode {qmode!r} (expected one of {QMODES})")
    return QVALUE_BITS[qmode]


def _check_qmode(qmode: str) -> str:
    qmode = qmode or "none"
    if qmode not in QMODES:
        raise ValueError(f"unknown qmode {qmode!r} (expected one of {QMODES})")
    return qmode


def density(x) -> float:
    """Fraction of non-zero elements (a tensor or an array)."""
    if isinstance(x, torch.Tensor):
        nnz, size = int(torch.count_nonzero(x)), x.numel()
    else:
        x = np.asarray(x)
        nnz, size = np.count_nonzero(x), x.size
    if size == 0:
        return 0.0
    return float(nnz) / float(size)


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
    the data-dependent capacity :func:`pack_tiled_csc` uses (unaligned).
    Counted one matrix of a stack at a time: the count of a whole stack
    widens every element to int64 at once (22 GB for pixtral-12b's 40
    ``w_gate`` matrices)."""
    if not w.numel():
        return 0
    bk, bn = tile
    best = 0
    for m in w.reshape((-1,) + tuple(w.shape[-2:])):
        wp = _pad_to_tiles(m, tile)
        kp, np_ = wp.shape
        t = wp.reshape(kp // bk, bk, np_ // bn, bn)
        best = max(best, int((t != 0).sum(dim=1).max()))
    return best


def observed_block_cap(w: torch.Tensor, tile: tuple[int, int], br: int) -> int:
    """Max non-zero (br, bn) sub-block count per macro tile over a (possibly
    stacked) matrix — the data-dependent bcap :func:`pack_block_csr` uses."""
    if not w.numel():
        return 0
    bk, bn = tile
    wp = _pad_to_tiles(w.reshape((-1,) + tuple(w.shape[-2:])), tile)
    kp, np_ = wp.shape[-2:]
    blk = wp.reshape(wp.shape[0], kp // bk, bk // br, br, np_ // bn, bn)
    nz = (blk != 0).any(dim=5).any(dim=3)
    return int(nz.sum(dim=2).max())


def _slice(t: torch.Tensor | None, i: int) -> torch.Tensor | None:
    return None if t is None else t[i]


def _ncodes(codebook: torch.Tensor | None) -> int:
    return CODEBOOK_SIZE if codebook is None else codebook.shape[-1]


def _n_lead(lead: tuple[int, ...]) -> int:
    n = 1
    for d in lead:
        n *= int(d)
    return n


def _fit_codebook(x: np.ndarray, ncodes: int) -> np.ndarray:
    """EIE-style shared-value table via 1-D Lloyd k-means (deterministic).

    Copied verbatim from the reference (numpy) so the tables come out equal.
    Entry 0 is reserved for exactly 0.0 so padding slots (and pruned
    positions inside stored blocks) round-trip to zero; the remaining
    ``ncodes - 1`` centroids are quantile-initialised over the non-zero
    values and refined for a few Lloyd iterations.
    """
    book = np.zeros((ncodes,), np.float32)
    nz = np.asarray(x, np.float32).ravel()
    nz = nz[nz != 0]
    if nz.size == 0:
        return book
    k = ncodes - 1
    cent = np.quantile(nz, np.linspace(0.0, 1.0, k))
    # collapsed quantiles (few distinct values) would alias centroids;
    # nudge them apart so argmin assignment stays well defined
    cent = cent + np.arange(k) * 1e-12
    for _ in range(8):
        assign = np.argmin(np.abs(nz[:, None] - cent[None, :]), axis=1)
        for i in range(k):
            sel = assign == i
            if sel.any():
                cent[i] = nz[sel].mean()
    book[1:] = np.sort(cent)
    return book


def _dequant_values(vals: torch.Tensor, scale, codebook, qmode: str,
                    nval_dims: int) -> torch.Tensor:
    """A packed value buffer dequantized to float32.

    ``vals`` is ``(*lead, Kt, Nt, *value_dims)`` with ``nval_dims`` trailing
    value dims (2 for TiledCSC's ``(cap, bn)``, 3 for BlockCSR's
    ``(bcap, br, bn)``); ``scale`` is ``(*lead, Kt, Nt)``; ``codebook`` is
    ``(*lead, ncodes)``.  int8/fp8: one f32 multiply ``code * scale``;
    codebook: a table lookup.
    """
    if qmode in (None, "none"):
        return vals
    if qmode in ("int8", "fp8"):
        return vals.float() * scale.reshape(tuple(scale.shape) + (1,) * nval_dims)
    if qmode == "codebook":
        lead_ndim = vals.ndim - 2 - nval_dims
        idx = vals.long().reshape(tuple(vals.shape[:lead_ndim]) + (-1,))
        return torch.gather(codebook.float(), -1, idx).reshape(vals.shape)
    raise ValueError(f"unknown qmode {qmode!r}")


def _quantize_values(vals: torch.Tensor, qmode: str, nval_dims: int, ncodes: int):
    """Quantize a packed value buffer; returns ``(qvals, scale, codebook)``.

    Shapes as in :func:`_dequant_values`.  As the reference: the scale is the
    tile's f32 absmax over 127 (int8) or 448 (fp8), 1.0 for an empty tile;
    int8 codes round half to even and clamp to ±127; fp8 codes are the
    round-to-nearest-even cast of ``value / scale``.  Padding slots hold 0
    and map to code 0 (or codebook entry 0) in every mode.
    """
    qmode = _check_qmode(qmode)
    if qmode == "none":
        return vals, None, None
    vf = vals.float()
    if qmode in ("int8", "fp8"):
        tile_dims = tuple(range(vals.ndim - nval_dims, vals.ndim))
        absmax = vf.abs().amax(dim=tile_dims)
        qmax = 127.0 if qmode == "int8" else 448.0
        scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
        q = vf / scale.reshape(tuple(scale.shape) + (1,) * nval_dims)
        if qmode == "int8":
            return torch.clamp(torch.round(q), -127, 127).to(torch.int8), scale, None
        return q.to(fp8_dtype()), scale, None
    # codebook: one shared-value table per lead slice, fitted on the host
    # with numpy exactly as the reference does.  The slices are independent
    # and numpy releases the GIL in its array loops, so they run in threads
    # (a full-width layer's fit takes tens of seconds on one core).
    lead = tuple(vals.shape[:vals.ndim - 2 - nval_dims])
    v_np = vf.cpu().numpy().reshape((-1,) + tuple(vals.shape[len(lead):]))

    def fit(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        book = _fit_codebook(v, ncodes)
        return book, np.argmin(np.abs(v[..., None] - book), axis=-1).astype(np.int8)

    workers = max(1, min(len(v_np), os.cpu_count() or 1, 8))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        books, idx = zip(*pool.map(fit, v_np))
    books, idx = np.stack(books), np.stack(idx)
    codebook = torch.from_numpy(books.reshape(lead + (ncodes,))).to(vals.device)
    return torch.from_numpy(idx.reshape(vals.shape)).to(vals.device), None, codebook


def _side_bytes(scale, codebook) -> int:
    """Side band of a quantized operand: 16 bits per scale or table entry."""
    return sum(t.numel() * SCALE_BITS // 8 for t in (scale, codebook)
               if t is not None)


def quantize_packed(packed, qmode: str, ncodes: int = CODEBOOK_SIZE):
    """Quantize the value buffer of a packed operand (TiledCSC/BlockCSR).

    Returns a new container with ``qmode`` set, ``vals``/``block_vals``
    replaced by the codes and the ``scale``/``codebook`` side band filled.
    ``qmode='none'`` (or the operand's own qmode) is the identity.
    """
    qmode = _check_qmode(qmode)
    if qmode == packed.qmode:
        return packed
    if packed.qmode != "none":
        raise ValueError(f"operand is already quantized ({packed.qmode}); "
                         "re-pack from dense to change qmode")
    if isinstance(packed, TiledCSC):
        q, scale, codebook = _quantize_values(packed.vals, qmode, 2, ncodes)
        return dataclasses.replace(packed, vals=q, scale=scale,
                                   codebook=codebook, qmode=qmode)
    if isinstance(packed, BlockCSR):
        q, scale, codebook = _quantize_values(packed.block_vals, qmode, 3, ncodes)
        return dataclasses.replace(packed, block_vals=q, scale=scale,
                                   codebook=codebook, qmode=qmode)
    raise TypeError(f"cannot quantize {type(packed).__name__}")


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a resident block of a packed operand sits in the whole one:
    the operand's tensors hold the tile-grid block of this rank, its
    ``shape`` is the block's own (whole tiles on a split grid dim), and
    this records the whole operand's logical ``shape`` and ``grid`` and the
    mesh axes its Kt and Nt dims are split on (None: whole).  Set by
    :func:`repro_torch.runtime.sharding.place` and
    :func:`repro_torch.runtime.sod_fsdp.shard_packed`; read by
    :func:`repro_torch.runtime.spmd.sod_matmul_spmd`."""

    shape: tuple[int, int]
    grid: tuple[int, int]
    kt_axis: str | None = None
    nt_axis: str | None = None


@dataclasses.dataclass
class TiledCSC:
    """Per-(bk, bn)-tile padded CSC.

    ``vals[kt, nt, s, j]`` is the s-th stored slot of column ``j`` of tile
    ``(kt, nt)`` and ``rows[kt, nt, s, j]`` its in-tile row index; padding
    slots hold value 0 and row ``-1``.  Leading dims ahead of ``(Kt, Nt)``
    are layer stacks packed with one shared ``cap``.  Under a quantized
    ``qmode`` ``vals`` holds the codes (int8, fp8, or int8 codebook indices)
    and ``scale``/``codebook`` the dequantization side band.
    """

    vals: torch.Tensor   # (*lead, Kt, Nt, cap, bn)
    rows: torch.Tensor   # same shape, int8 (bk <= 128) or int32
    shape: tuple[int, int]   # logical (K, N) before tile padding
    tile: tuple[int, int]
    scale: torch.Tensor | None = None      # (*lead, Kt, Nt) f32: int8, fp8
    codebook: torch.Tensor | None = None   # (*lead, ncodes) f32: codebook
    qmode: str = "none"
    shard: Shard | None = None             # a rank's resident block, or None

    @property
    def cap(self) -> int:
        """Padded slot count per tile column."""
        return self.vals.shape[-2]

    @property
    def grid(self) -> tuple[int, int]:
        """``(Kt, Nt)`` tile-grid extents."""
        return self.vals.shape[-4], self.vals.shape[-3]

    @property
    def global_shape(self) -> tuple[int, int]:
        """Logical (K, N) of the whole operand (of which a resident block
        holds a part)."""
        return tuple(self.shard.shape) if self.shard else tuple(self.shape)

    @property
    def global_grid(self) -> tuple[int, int]:
        """``(Kt, Nt)`` of the whole operand."""
        return tuple(self.shard.grid) if self.shard else tuple(self.grid)

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
                        tile=self.tile, scale=_slice(self.scale, i),
                        codebook=_slice(self.codebook, i), qmode=self.qmode)

    def nbytes_compressed(self) -> int:
        """Footprint under the paper's encoding: value (the qmode's width) +
        index per slot, plus the quantization side band."""
        value_bits = qvalue_bits(self.qmode, _ncodes(self.codebook))
        return (self.vals.numel() * (value_bits + INDEX_BITS) // 8
                + _side_bytes(self.scale, self.codebook))

    def nbytes_dense(self) -> int:
        """Dense-equivalent 16-bit bytes (lead dims included)."""
        kp, np_ = padded_shape(self.shape, self.tile)
        return _n_lead(self.lead) * kp * np_ * VALUE_BITS // 8

    def compression_ratio(self) -> float:
        """``nbytes_compressed / nbytes_dense`` — below 1 when packing pays."""
        return self.nbytes_compressed() / max(self.nbytes_dense(), 1)

    def dequantize(self) -> "TiledCSC":
        """The equivalent unquantized operand, values dequantized to
        float32; the operand itself when it is not quantized."""
        if self.qmode == "none":
            return self
        return TiledCSC(vals=_dequant_values(self.vals, self.scale, self.codebook,
                                             self.qmode, 2),
                        rows=self.rows, shape=self.shape, tile=self.tile)

    def to_dense(self) -> torch.Tensor:
        """Scatter the stored slots back into a dense ``(*lead, K, N)``, in
        the value dtype (float32 for a quantized operand, dequantized first).

        The sentinel is masked before the scatter: torch would wrap row
        ``-1`` to the tile's last row, so padding slots scatter a zero into
        row 0 instead (exact: every real slot is non-zero and rows are unique
        per column).
        """
        if self.qmode != "none":
            return self.dequantize().to_dense()
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
                   cap: int | None = None, qmode: str = "none",
                   ncodes: int = CODEBOOK_SIZE) -> TiledCSC:
    """Pack a dense matrix into :class:`TiledCSC`, as the JAX package does.

    ``cap=None`` takes the exact max column non-zero count over all tiles
    (lossless), rounded up to 8.  A smaller ``cap`` keeps the ``cap``
    largest-magnitude entries per tile column.  Leading dims (layer stacks)
    are packed with one shared cap.  Row indices are int8 for ``bk <= 128``
    (int32 above).  ``qmode`` quantizes the values after packing
    (:func:`quantize_packed`), over the whole stack.
    """
    if qmode != "none":
        return quantize_packed(pack_tiled_csc(w, tile, cap), qmode, ncodes)
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


@dataclasses.dataclass
class BlockCSR:
    """Block-compressed rows of (bk, bn) macro tiles.

    Each macro tile is cut along K into (br, bn) sub-blocks; up to ``bcap``
    non-zero sub-blocks are stored with their in-tile block ids (``-1`` =
    padding, value 0).  ``tile_nnz[kt, nt]`` counts the stored sub-blocks,
    and :func:`pack_block_csr` stores them first, in ascending id order, so
    the ids are ``>= 0`` exactly at slots ``s < tile_nnz``.  A macro tile with
    ``tile_nnz == 0`` holds nothing and is skipped by the matmul kernel.
    ``qmode``/``scale``/``codebook`` quantize ``block_vals`` as
    :class:`TiledCSC` quantizes ``vals`` (scale per macro tile).
    """

    block_vals: torch.Tensor   # (*lead, Kt, Nt, bcap, br, bn)
    block_ids: torch.Tensor    # (*lead, Kt, Nt, bcap) int32
    tile_nnz: torch.Tensor     # (*lead, Kt, Nt) int32
    shape: tuple[int, int]     # logical (K, N) before tile padding
    tile: tuple[int, int]      # (bk, bn) macro tile
    br: int                    # sub-block rows
    scale: torch.Tensor | None = None      # (*lead, Kt, Nt) f32: int8, fp8
    codebook: torch.Tensor | None = None   # (*lead, ncodes) f32: codebook
    qmode: str = "none"
    shard: Shard | None = None             # a rank's resident block, or None

    @property
    def bcap(self) -> int:
        """Stored sub-blocks per macro tile."""
        return self.block_vals.shape[-3]

    @property
    def grid(self) -> tuple[int, int]:
        """``(Kt, Nt)`` tile-grid extents."""
        return self.block_vals.shape[-5], self.block_vals.shape[-4]

    @property
    def global_shape(self) -> tuple[int, int]:
        """Logical (K, N) of the whole operand (of which a resident block
        holds a part)."""
        return tuple(self.shard.shape) if self.shard else tuple(self.shape)

    @property
    def global_grid(self) -> tuple[int, int]:
        """``(Kt, Nt)`` of the whole operand."""
        return tuple(self.shard.grid) if self.shard else tuple(self.grid)

    @property
    def lead(self) -> tuple[int, ...]:
        """Leading stack dims ahead of the grid."""
        return tuple(self.block_vals.shape[:-5])

    @property
    def dtype(self) -> torch.dtype:
        """Stored value dtype."""
        return self.block_vals.dtype

    @property
    def device(self) -> torch.device:
        """Device holding the buffers."""
        return self.block_vals.device

    def layer(self, i: int) -> "BlockCSR":
        """Slice ``i`` of a stacked operand (first lead dim)."""
        if not self.lead:
            raise ValueError("operand has no stack dim to slice")
        return BlockCSR(block_vals=self.block_vals[i], block_ids=self.block_ids[i],
                        tile_nnz=self.tile_nnz[i], shape=self.shape,
                        tile=self.tile, br=self.br, scale=_slice(self.scale, i),
                        codebook=_slice(self.codebook, i), qmode=self.qmode)

    def nbytes_compressed(self) -> int:
        """Footprint: stored sub-block values (the qmode's width), 16-bit
        block ids, and the quantization side band."""
        value_bits = qvalue_bits(self.qmode, _ncodes(self.codebook))
        return (self.block_vals.numel() * value_bits // 8
                + self.block_ids.numel() * BLOCK_ID_BITS // 8
                + _side_bytes(self.scale, self.codebook))

    def nbytes_dense(self) -> int:
        """Dense-equivalent 16-bit bytes (lead dims included)."""
        kp, np_ = padded_shape(self.shape, self.tile)
        return _n_lead(self.lead) * kp * np_ * VALUE_BITS // 8

    def dequantize(self) -> "BlockCSR":
        """The equivalent unquantized operand (cf. ``TiledCSC.dequantize``)."""
        if self.qmode == "none":
            return self
        return BlockCSR(block_vals=_dequant_values(self.block_vals, self.scale,
                                                   self.codebook, self.qmode, 3),
                        block_ids=self.block_ids, tile_nnz=self.tile_nnz,
                        shape=self.shape, tile=self.tile, br=self.br)

    def to_dense(self) -> torch.Tensor:
        """Scatter the stored sub-blocks back into a dense ``(*lead, K, N)``,
        in the value dtype (float32 for a quantized operand).

        Id ``-1`` is masked before the scatter (torch would wrap it to the
        tile's last sub-block): padding adds a zero into sub-block 0, which
        is exact because real ids are unique per tile.
        """
        if self.qmode != "none":
            return self.dequantize().to_dense()
        kt_n, nt_n = self.grid
        bk, bn = self.tile
        br, nb = self.br, bk // self.br
        bv = self.block_vals.reshape((-1, kt_n, nt_n, self.bcap, br, bn))
        ids = self.block_ids.reshape(bv.shape[:4]).long()
        valid = (ids >= 0)[..., None, None]
        dense = torch.zeros((bv.shape[0], kt_n, nt_n, nb, br, bn),
                            dtype=bv.dtype, device=bv.device)
        dense.scatter_add_(3, ids.clamp(min=0)[..., None, None].expand_as(bv),
                           torch.where(valid, bv, torch.zeros_like(bv)))
        dense = dense.permute(0, 1, 3, 4, 2, 5).reshape(
            bv.shape[0], kt_n * bk, nt_n * bn)
        k, n = self.shape
        return dense[:, :k, :n].reshape(self.lead + (k, n))


def pack_block_csr(w: torch.Tensor, tile: tuple[int, int] = (128, 128),
                   br: int = 8, bcap: int | None = None, qmode: str = "none",
                   ncodes: int = CODEBOOK_SIZE) -> BlockCSR:
    """Pack a dense matrix into :class:`BlockCSR`, as the JAX package does.

    ``bcap=None`` takes the largest non-zero sub-block count of any macro
    tile (lossless).  An explicit ``bcap`` below that keeps the
    largest-L2 sub-blocks and clamps ``tile_nnz`` to what is stored.  Leading
    dims (layer stacks) are packed with one shared ``bcap``.  Either way the
    stored sub-blocks come first, in ascending id order.  ``qmode``
    quantizes ``block_vals`` after packing, over the whole stack.
    """
    bk, bn = tile
    if bk % br:
        raise ValueError(f"tile rows {bk} not divisible by block rows {br}")
    if qmode != "none":
        return quantize_packed(pack_block_csr(w, tile, br, bcap), qmode, ncodes)
    if w.ndim > 2:
        lead = tuple(w.shape[:-2])
        flat = w.reshape((-1,) + tuple(w.shape[-2:]))
        if bcap is None:
            bcap = max(observed_block_cap(w, tile, br), 1)
        packed = [pack_block_csr(flat[i], tile, br, bcap)
                  for i in range(flat.shape[0])]

        def stack(name):
            t = torch.stack([getattr(p, name) for p in packed])
            return t.reshape(lead + tuple(t.shape[1:]))

        return BlockCSR(block_vals=stack("block_vals"), block_ids=stack("block_ids"),
                        tile_nnz=stack("tile_nnz"), shape=tuple(w.shape[-2:]),
                        tile=tuple(tile), br=br)
    if w.ndim != 2:
        raise ValueError(f"expected >=2-D matrix, got {tuple(w.shape)}")
    shape = tuple(w.shape)
    wp = _pad_to_tiles(w, tile)
    kp, np_ = wp.shape
    kt_n, nt_n = kp // bk, np_ // bn
    nb = bk // br
    blocks = wp.reshape(kt_n, nb, br, nt_n, bn).permute(0, 3, 1, 2, 4)
    # (Kt, Nt, nb, br, bn)
    nz = (blocks != 0).any(dim=4).any(dim=3)                 # (Kt, Nt, nb)
    tile_nnz = nz.sum(dim=2).to(torch.int32)
    if bcap is None:
        bcap = max(int(tile_nnz.max()) if wp.numel() else 0, 1)
    else:
        tile_nnz = tile_nnz.clamp(max=bcap)    # count what is stored
    # Largest-L2 sub-blocks first, then ascending id order within the kept
    # set (padding last) — the reference's two stable sorts on its keys.
    norms = (blocks.float() ** 2).sum(dim=(3, 4))
    key = torch.where(nz, -norms, torch.full_like(norms, float("inf")))
    sel = torch.argsort(key, dim=2, stable=True)[:, :, :bcap]
    sel_valid = torch.gather(nz, 2, sel)
    asc = torch.argsort(torch.where(sel_valid, sel, torch.full_like(sel, nb)),
                        dim=2, stable=True)
    order = torch.gather(sel, 2, asc)
    valid = torch.gather(sel_valid, 2, asc)
    idx = order[:, :, :, None, None].expand(-1, -1, -1, br, bn)
    block_vals = torch.gather(blocks, 2, idx)
    block_vals = torch.where(valid[:, :, :, None, None], block_vals,
                             torch.zeros_like(block_vals)).to(w.dtype)
    block_ids = torch.where(valid, order, torch.full_like(order, -1))
    return BlockCSR(block_vals=block_vals.contiguous(),
                    block_ids=block_ids.to(torch.int32).contiguous(),
                    tile_nnz=tile_nnz.contiguous(), shape=shape, tile=(bk, bn),
                    br=br)


# ---------------------------------------------------------------------------
# Bitmap — SIGMA-style
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Bitmap:
    """Bitmap + row-major packed non-zero values (padded to ``cap``)."""

    mask: torch.Tensor   # (K, N) bool
    vals: torch.Tensor   # (cap,) packed row-major non-zeros
    shape: tuple[int, int]

    def nbytes_compressed(self, value_bits: int = 16) -> int:
        """Bitmap bytes (1 bit/element) plus the stored value list."""
        bits = self.mask.numel()  # 1 bit/element bitmap
        return bits // 8 + self.vals.shape[0] * value_bits // 8

    def nbytes_dense(self, value_bits: int = 16) -> int:
        """Dense-equivalent bytes at ``value_bits``."""
        return int(np.prod(self.shape)) * value_bits // 8

    def to_dense(self) -> torch.Tensor:
        """Reconstruct the dense matrix (bitmap-guided scatter)."""
        flat_mask = self.mask.reshape(-1)
        pos = torch.cumsum(flat_mask.long(), 0) - 1
        gathered = self.vals[pos.clamp(0, self.vals.shape[0] - 1)]
        out = torch.where(flat_mask, gathered, torch.zeros_like(gathered))
        return out.reshape(self.shape)


def pack_bitmap(w: torch.Tensor, cap: int | None = None) -> Bitmap:
    """Pack into :class:`Bitmap`: 1-bit mask + row-major value list (the
    first ``cap`` non-zeros; zeros pad a list shorter than ``cap``)."""
    mask = w != 0
    flat = w.reshape(-1)
    flat_mask = mask.reshape(-1)
    if cap is None:
        cap = max(int(flat_mask.sum()), 1)
    # a stable sort puts the non-zeros first, in row-major order
    order = torch.argsort((~flat_mask).to(torch.uint8), stable=True)[:cap]
    vals = torch.where(flat_mask[order], flat[order], torch.zeros_like(flat[order]))
    return Bitmap(mask=mask, vals=vals, shape=tuple(w.shape))


# ---------------------------------------------------------------------------
# Classic pointer CSC (numpy) — exact footprint accounting for the cost model
# ---------------------------------------------------------------------------
def pack_csc(w) -> dict[str, np.ndarray]:
    """Classic CSC: values, row indices, column pointers (numpy, exact; a
    tensor is read through the host)."""
    w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    k, n = w.shape
    rows = []
    vals = []
    ptr = [0]
    for j in range(n):
        nz = np.nonzero(w[:, j])[0]
        rows.append(nz)
        vals.append(w[nz, j])
        ptr.append(ptr[-1] + len(nz))
    return {
        "values": np.concatenate(vals) if vals else np.zeros((0,), w.dtype),
        "row_indices": np.concatenate(rows).astype(np.int32)
        if rows
        else np.zeros((0,), np.int32),
        "col_pointers": np.asarray(ptr, np.int64),
        "shape": np.asarray([k, n]),
    }


def unpack_csc(csc: dict[str, np.ndarray]) -> np.ndarray:
    """Reconstruct the dense matrix from a :func:`pack_csc` dict."""
    k, n = (int(x) for x in csc["shape"])
    out = np.zeros((k, n), csc["values"].dtype)
    ptr = csc["col_pointers"]
    for j in range(n):
        lo, hi = int(ptr[j]), int(ptr[j + 1])
        out[csc["row_indices"][lo:hi], j] = csc["values"][lo:hi]
    return out


def csc_nbytes(csc: dict[str, np.ndarray], value_bits: int = 16,
               index_bits: int = 8, pointer_bits: int = 32) -> int:
    """Byte footprint of a pointer-CSC dict at the given bit widths."""
    nnz = csc["values"].shape[0]
    ncols = csc["col_pointers"].shape[0]
    return (nnz * (value_bits + index_bits) + ncols * pointer_bits) // 8
