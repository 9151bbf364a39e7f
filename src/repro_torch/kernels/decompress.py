"""Wrapper of the standalone decompression CUDA kernel (``csrc/decompress.cu``).

Twin of :mod:`repro.kernels.decompress` (``decompress_pallas``), in every
qmode.  A CPU tensor goes to the plain version
:func:`repro_torch.kernels.ref.decompress_tiled_ref`; a CUDA tensor goes to
the hand-written kernel, or the call raises.  Either way the result has the
logical (K, N) shape and is bit-equal to ``TiledCSC.to_dense()`` cast to the
output dtype (float32 by default for a quantized operand).

How a call is launched is one pure function, :func:`plan_launch`: the
persistent grid, the threads of a CTA, the stages of the ring of tile slabs
and the dense tiles each CTA keeps in shared memory, and the dynamic shared
memory that takes.  The kernel fills its ring with bulk copies, which need
``vals`` and ``rows`` to start 16-byte aligned: a misaligned operand (a view
into a stacked tensor at an odd offset) raises
(:func:`~repro_torch.kernels.sod_matmul.check_bulk_aligned`); there is no
other path.

``launches`` counts the kernel launches this wrapper made (plain-version
calls do not count).  Callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.formats import TiledCSC
from repro_torch.kernels import build, ref
from repro_torch.kernels.sod_matmul import (DTYPE_CODE, MAX_STAGES, SMEM_PER_BLOCK,
                                            SMEM_PER_SM, SMEM_RESERVED, STATIC_SMEM,
                                            check_bulk_aligned, side_args, side_band,
                                            sm_count)

__all__ = ["decompress", "launches", "DecompressPlan", "plan_launch", "plan_of",
           "CTAS_PER_SM", "THREADS"]

launches = 0

# The CTAs per SM a plan aims for (fewer where two stages and one dense tile
# do not fit), and the threads of a CTA (rounded to a multiple of bn; a CTA
# has at most MAX_THREADS).  Two CTAs of 512 threads an SM were the fastest
# of the plans swept on an H100, in every qmode (PERF.md).
CTAS_PER_SM = 2
THREADS = 512
MAX_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class DecompressPlan:
    """How one call launches: ``grid`` persistent CTAs of ``threads``
    threads, ``ctas_per_sm`` of them planned to share an SM, each with a
    ring of ``stages`` tile slabs and ``dense_buffers`` dense tiles in
    ``smem_bytes`` of dynamic shared memory."""
    grid: int
    threads: int
    stages: int
    dense_buffers: int
    ctas_per_sm: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def plan_launch(kt: int, nt: int, cap: int, tile: tuple[int, int], value_bytes: int,
                out_bytes: int, sms: int) -> DecompressPlan:
    """The launch plan of a (kt, nt)-tile operand of ``cap`` slots per tile
    column, ``value_bytes`` per stored value, densified into ``out_bytes``
    per output value on a card of ``sms`` SMs.  Cached: a training step
    calls it with a handful of argument sets.

    A stage of the ring holds one tile's slab, ``cap * bn * (value_bytes +
    1)`` bytes; a dense tile takes ``bk * bn * out_bytes``.  The plan tries
    CTAS_PER_SM CTAs per SM down to one, and at each two dense tiles, then
    one, and takes the first at which two stages fit beside them in a CTA's
    share of the SM; the ring then takes as many stages as fit, up to
    MAX_STAGES and the tiles a CTA densifies, and never fewer than 2.  The
    grid is ``min(tiles, sms * CTAs per SM)``; a CTA has THREADS (at most
    MAX_THREADS) rounded down to a multiple of bn, at least bn.  Raises
    ValueError when two stages and one dense tile do not fit in one CTA's
    shared memory."""
    bk, bn = tile
    tiles = kt * nt
    stage = cap * bn * (value_bytes + 1)
    dense = bk * bn * out_bytes
    threads = bn * max(1, min(THREADS, MAX_THREADS) // bn)
    for per_sm in range(CTAS_PER_SM, 0, -1):
        budget = (min(SMEM_PER_BLOCK, SMEM_PER_SM // per_sm - SMEM_RESERVED)
                  - STATIC_SMEM)
        grid = min(tiles, sms * per_sm)
        for buffers in (2, 1):
            fit = (budget - buffers * dense) // stage
            if fit >= 2:
                stages = max(2, min(fit, -(-tiles // grid), MAX_STAGES))
                return DecompressPlan(grid, threads, stages, buffers, per_sm,
                                      buffers * dense + stages * stage)
    raise ValueError(
        f"decompress: two stages of {stage} bytes and a dense tile of {dense} "
        f"bytes do not fit in one CTA's {SMEM_PER_BLOCK - STATIC_SMEM} bytes of "
        "shared memory")


def plan_of(packed: TiledCSC, out_dtype: torch.dtype) -> DecompressPlan:
    """:func:`plan_launch` for this operand on its card."""
    return plan_launch(*packed.grid, packed.cap, tuple(packed.tile),
                       packed.vals.element_size(), out_dtype.itemsize,
                       sm_count(packed.device.index or 0))


@functools.lru_cache(maxsize=1)
def _entry():
    fn = build.load("decompress").decompress_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decompress(packed: TiledCSC, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The dense (K, N) matrix of one unstacked ``TiledCSC`` operand in
    ``out_dtype``: by default the value dtype, float32 for a quantized
    operand (its stored codes are not values), as the reference."""
    global launches
    out_dtype = out_dtype or (torch.float32 if packed.qmode != "none"
                              else packed.dtype)
    if packed.lead:
        raise ValueError(f"one (unstacked) operand expected, got lead dims "
                         f"{packed.lead}")
    if out_dtype not in DTYPE_CODE or (packed.qmode == "none"
                                       and packed.dtype not in DTYPE_CODE):
        raise TypeError(f"value dtype {packed.dtype} / out dtype {out_dtype}: "
                        "float32 and bfloat16 are supported")
    side = side_band(packed)
    buffers = [packed.vals, packed.rows, *side.values()]
    if not all(t.is_contiguous() for t in buffers):
        raise ValueError("the operand's buffers must be contiguous")
    if any(t.device != packed.device for t in buffers):
        raise ValueError("the buffers of the operand lie on different devices")
    if packed.device.type == "cpu":
        return ref.decompress_tiled_ref(packed, out_dtype)
    if packed.device.type != "cuda":
        raise RuntimeError(f"decompress runs on cuda or cpu tensors, not "
                           f"{packed.device.type}")
    bk, bn = packed.tile
    if packed.rows.dtype != torch.int8 or bk > 128 or bn % 32 or bn > 1024:
        raise NotImplementedError(
            f"tile {packed.tile} with {packed.rows.dtype} rows: the kernel "
            "takes int8 rows (bk <= 128) and bn a multiple of 32 up to 1024")
    check_bulk_aligned({"vals": packed.vals, "rows": packed.rows})
    k, n = packed.shape
    kt, nt = packed.grid
    out = torch.empty((k, n), dtype=out_dtype, device=packed.device)
    if out.numel() == 0:
        return out
    plan = plan_of(packed, out_dtype)
    scale_ptr, book_ptr, qcode, ncodes = side_args(side, packed.qmode)
    err = _entry()(
        packed.vals.data_ptr(), packed.rows.data_ptr(), scale_ptr, book_ptr,
        out.data_ptr(), k, n, kt, nt, packed.cap, bk, bn, plan.grid, plan.threads,
        plan.stages, plan.dense_buffers, plan.smem_bytes,
        DTYPE_CODE.get(packed.dtype, 0), DTYPE_CODE[out_dtype], qcode, ncodes,
        torch.cuda.current_stream(packed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decompress kernel launch failed: cudaError {err}")
    launches += 1
    return out
