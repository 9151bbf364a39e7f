"""Wrapper of the block Sparse-on-Dense matmul CUDA kernel
(``csrc/block_matmul.cu``).

Twin of :mod:`repro.kernels.block_matmul` (``block_matmul_pallas``), in
every qmode.  A CPU tensor goes to the plain version
:func:`repro_torch.kernels.ref.block_matmul_ref`; a CUDA tensor goes to the
hand-written kernel, or the call raises.

The kernel reads only the slots ``s < tile_nnz[kt, nt]`` of each macro tile,
which holds for every operand :func:`repro_torch.core.formats.pack_block_csr`
made (the stored sub-blocks come first): one bulk copy a tile brings them
into a ring of stages in shared memory.  How a call is launched is one pure
function, :func:`plan_launch`; the copies need ``block_vals`` to start
16-byte aligned, and a misaligned operand raises.  Split-K is reduced inside
the launch, with the arrival counters of
:func:`repro_torch.kernels.sod_matmul.split_counters`.

``launches`` counts the kernel launches this wrapper made (plain-version
calls do not count).  Callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.formats import BlockCSR
from repro_torch.kernels import build, ref
from repro_torch.kernels.sod_matmul import (DTYPE_CODE, LaunchPlan, check_bulk_aligned,
                                            check_operands, ring_plan, side_args,
                                            sm_count, split_counters)

__all__ = ["block_matmul", "launches", "plan_launch", "plan_of", "ids_stage_bytes",
           "CTAS_PER_SM", "M_GROUPS", "MAX_THREADS"]

launches = 0

# CTAs per SM the launch plan aims for (fewer where two stages do not fit),
# the most groups of 16 rows of M one CTA holds above 8 rows, and the most
# threads of a CTA (csrc/block_matmul.cu:kMaxThreads).
CTAS_PER_SM = 2
M_GROUPS = 4
MAX_THREADS = 512


def ids_stage_bytes(bcap: int) -> int:
    """Bytes of a ring stage's block ids: ``bcap`` int32 ids and up to 12
    leading bytes of the 16-byte granule they start in, rounded up to 16
    (``csrc/block_matmul.cu:ids_stage_bytes``)."""
    return (4 * bcap + 12 + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def plan_launch(m: int, kt: int, nt: int, bcap: int, br: int,
                tile: tuple[int, int], value_bytes: int, x_bytes: int,
                sms: int) -> LaunchPlan:
    """The launch plan of an (M, K) x of ``x_bytes`` per element against a
    (kt, nt)-tile BlockCSR of ``bcap`` stored (``br``, bn) sub-blocks per
    macro tile, ``value_bytes`` per stored value, on a card of ``sms`` SMs
    (:func:`repro_torch.kernels.sod_matmul.ring_plan`, CTAS_PER_SM per SM).
    Cached: a model calls it with a handful of argument sets, every step.

    The M block ``bm`` is 4 rows (decode at batch 4), 8, or above 8 rows
    16, where a thread owns two columns and a CTA holds up to M_GROUPS
    groups of 16 rows (at most MAX_THREADS threads) sharing its ring.  A
    stage of the ring holds one macro tile's stored sub-blocks, at most
    ``bcap * br * bn * value_bytes`` bytes, and their ids; staging x takes
    ``bk * bm * m_groups`` values a K tile, in x's dtype at ``bm`` <= 8 and
    in f32 at 16; the list of the split's non-empty tiles 8 bytes a K
    tile."""
    bk, bn = tile
    bm = 4 if m <= 4 else 8 if m <= 8 else 16
    mg = max(1, min(M_GROUPS, -(-m // bm), MAX_THREADS // (bn // 2))) if bm == 16 else 1
    staged = 4 if bm == 16 else x_bytes
    return ring_plan("block_matmul", bm, kt, nt * -(-m // (bm * mg)), sms,
                     bcap * br * bn * value_bytes + ids_stage_bytes(bcap),
                     bk * bm * mg * staged, per_tile=8, per_sm_max=CTAS_PER_SM,
                     m_groups=mg)


def plan_of(x: torch.Tensor, packed: BlockCSR) -> LaunchPlan:
    """:func:`plan_launch` for these operands on x's card."""
    return plan_launch(x.shape[0], *packed.grid, packed.bcap, packed.br,
                       tuple(packed.tile), packed.block_vals.element_size(),
                       x.element_size(), sm_count(x.device.index or 0))


@functools.lru_cache(maxsize=1)
def _entry():
    fn = build.load("block_matmul").block_matmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 19
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def block_matmul(x: torch.Tensor, packed: BlockCSR,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ decompress(packed)`` for 2-D ``x`` of shape (M, K): (M, N).

    The kernel masks the ragged M, K and N edges itself, so ``x`` is passed
    as it is and the output comes out at its logical shape.
    """
    global launches
    out_dtype = out_dtype or x.dtype
    side = check_operands("block_matmul", x, packed, out_dtype,
                          {"block_vals": packed.block_vals,
                           "block_ids": packed.block_ids,
                           "tile_nnz": packed.tile_nnz})
    if packed.block_ids.dtype != torch.int32 or packed.tile_nnz.dtype != torch.int32:
        raise TypeError("block_ids and tile_nnz must be int32")
    if x.device.type == "cpu":
        return ref.block_matmul_ref(x, packed, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"block_matmul runs on cuda or cpu tensors, not "
                           f"{x.device.type}")
    bk, bn = packed.tile
    if bk > 256 or bn % 32 or bn > MAX_THREADS:
        raise NotImplementedError(
            f"tile {packed.tile}: the kernel takes bk <= 256 and bn a "
            f"multiple of 32 up to {MAX_THREADS}")
    check_bulk_aligned({"block_vals": packed.block_vals})
    m, (k, n) = x.shape[0], packed.shape
    kt, nt = packed.grid
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    plan = plan_of(x, packed)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    partial = counters = None
    if plan.splits > 1:
        partial = torch.empty((plan.splits, m, n), dtype=torch.float32, device=x.device)
        counters = split_counters(x.device, stream,
                                  nt * -(-m // (plan.bm * plan.m_groups)))
    scale_ptr, book_ptr, qcode, ncodes = side_args(side, packed.qmode)
    err = _entry()(
        x.data_ptr(), packed.block_vals.data_ptr(), packed.block_ids.data_ptr(),
        packed.tile_nnz.data_ptr(), scale_ptr, book_ptr, out.data_ptr(),
        0 if partial is None else partial.data_ptr(),
        0 if counters is None else counters.data_ptr(),
        m, k, n, kt, nt, packed.bcap, packed.br, bk, bn, plan.bm, plan.m_groups,
        plan.splits, plan.stages, plan.x_tiles, plan.smem_bytes,
        DTYPE_CODE[x.dtype], DTYPE_CODE[out_dtype], qcode, ncodes, stream)
    if err != 0:
        raise RuntimeError(f"block_matmul kernel launch failed: cudaError {err}")
    launches += 1
    return out
