"""Wrapper of the fused decompress + matmul CUDA kernel (``csrc/sod_matmul.cu``).

Twin of :mod:`repro.kernels.sod_matmul` (``sod_matmul_pallas``), in every
qmode.  A CPU tensor goes to the plain version
:func:`repro_torch.kernels.ref.sod_matmul_ref`; a CUDA tensor goes to the
hand-written kernel, or the call raises.

How a call is launched is one pure function, :func:`plan_launch`: the M
block, the K splits (:func:`pick_splits`), the stages of the kernel's ring
of tile slabs in shared memory, how much of x it stages at once, and the
dynamic shared memory that takes, within the card's budget.  Two of its
inputs are the autotuner's parameters (:mod:`repro_torch.kernels.registry`):
the M block ``bm`` and the ring's stage cap ``max_stages``, neither of which
changes the K splits and so the order of a row's sums (the splits are
planned for a fixed CTAS_PER_SM).  The kernel
fills its ring with bulk copies, which need ``vals`` and ``rows`` to start
16-byte aligned: a misaligned operand (a view into a stacked tensor at an
odd offset) raises (:func:`check_bulk_aligned`); there is no other path.

Split-K is reduced inside the launch.  The CTA that arrives last at its
output tile sums the splits; it learns that from an int32 arrival counter
in a buffer this module keeps per (device, stream) (:func:`split_counters`),
zeroed once when it is made, grown by reallocation to the largest
``nt * m_blocks`` seen, and left zero by every launch.  The block kernel
(:mod:`repro_torch.kernels.block_matmul`) shares the buffer and the launch
plan's shape (:func:`ring_plan`): launches on one stream run one after
another, so the two never hold a counter at once.

``launches`` counts the kernel launches this wrapper made (plain-version
calls do not count), so a run can show that its matmuls went through the
kernel.  Callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.formats import TiledCSC
from repro_torch.kernels import build, ref

__all__ = ["sod_matmul", "launches", "pick_splits", "sm_count", "DTYPE_CODE",
           "QMODE_CODE", "check_operands", "side_band", "side_args", "LaunchPlan",
           "ring_plan", "m_block", "plan_launch", "plan_of", "check_bulk_aligned",
           "split_counters", "M_BLOCKS", "CTAS_PER_SM", "MAX_STAGES"]

launches = 0

# dtype and qmode codes of the kernels' C entry points (all three kernels
# share them), the stored code dtype of each quantized qmode, and the largest
# codebook the kernels take (int8 indices address at most 128 entries)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
QMODE_CODE = {"none": 0, "int8": 1, "fp8": 2, "codebook": 3}
CODE_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
              "codebook": torch.int8}
MAX_CODES = 128
# The CTAs per SM a launch plan aims for (fewer where two stages do not
# fit), and the M blocks the kernel is compiled for.
CTAS_PER_SM = 2
M_BLOCKS = (4, 8, 32)

# Shared memory of an H100 SM (bytes): 228 KB in all, at most 227 KB for one
# CTA, and 1 KB of each CTA's share kept by the runtime.  The kernel's static
# shared memory (the codebook table, the ring's barriers) stays under
# STATIC_SMEM.  Its ring has at most MAX_STAGES stages; a bulk copy needs
# BULK_ALIGN-byte aligned operands.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_RESERVED = 1024
STATIC_SMEM = 1024
MAX_STAGES = 8
BULK_ALIGN = 16

_counters: dict[tuple[int, int], torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of one CUDA device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=1)
def _entry():
    fn = build.load("sod_matmul").sod_matmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 17
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def pick_splits(kt: int, ctas: int, sms: int, per_sm: int = CTAS_PER_SM) -> int:
    """K splits so that ``ctas`` CTAs become about ``per_sm`` per SM, with no
    empty split."""
    want = max(1, min(kt, -(-per_sm * sms // max(ctas, 1))))
    per = -(-kt // want)
    return -(-kt // per)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call launches: M block ``bm``, K ``splits``, ring ``stages``,
    K tiles of x staged at once (``x_tiles``), dynamic shared memory bytes,
    the CTAs per SM the budget was planned for, and the groups of ``bm``
    rows one CTA holds (``m_groups``; the block kernel above 32 rows)."""
    bm: int
    splits: int
    stages: int
    x_tiles: int
    smem_bytes: int
    ctas_per_sm: int
    m_groups: int = 1


def ring_plan(name: str, bm: int, kt: int, ctas: int, sms: int, stage: int,
              x_tile: int, fixed: int = 0, per_tile: int = 0,
              per_sm_max: int = CTAS_PER_SM, m_groups: int = 1,
              max_stages: int = MAX_STAGES) -> LaunchPlan:
    """The launch plan of a kernel with a ring of ``stage``-byte slabs in
    shared memory: ``ctas`` CTAs of one M block before K is split, M block
    ``bm``, ``kt`` K tiles, ``x_tile`` bytes of staged x a K tile, and beside
    them ``fixed`` bytes plus ``per_tile`` bytes a K tile of the split; a
    CTA holds ``m_groups`` M blocks.

    The K splits come from ``ctas`` at ``per_sm_max`` CTAs per SM
    (:func:`pick_splits`) and from nothing else: not from the count of M
    blocks, nor from what fits.  A row's sums then run in one order whatever
    other rows share the call (the kernels sum the splits in split order),
    so a row computed alone equals the same row inside a prefill, which the
    serving engine's equality with the static path needs.  The budget then
    plans ``per_sm_max`` CTAs per SM first, then fewer, down to one, until
    two stages fit beside each other.  x is staged for the whole split where
    that leaves room for two stages, else a tile at a time; the ring then
    takes as many stages as the split has tiles, up to what fits and
    ``max_stages`` (at most MAX_STAGES), and never fewer than 2.  Raises
    ValueError when even one CTA per SM cannot hold two stages."""
    splits = pick_splits(kt, ctas, sms, per_sm_max)
    tiles = -(-kt // splits)
    extra = fixed + per_tile * tiles
    for per_sm in range(per_sm_max, 0, -1):
        budget = (min(SMEM_PER_BLOCK, SMEM_PER_SM // per_sm - SMEM_RESERVED)
                  - STATIC_SMEM - extra)
        x_tiles = tiles if budget - tiles * x_tile >= 2 * stage else 1
        fit = (budget - x_tiles * x_tile) // stage
        if fit >= 2:
            stages = max(2, min(fit, tiles, max_stages, MAX_STAGES))
            return LaunchPlan(bm, splits, stages, x_tiles,
                              stages * stage + x_tiles * x_tile + extra, per_sm,
                              m_groups)
    raise ValueError(
        f"{name}: two stages of {stage} bytes and x do not fit in one CTA's "
        f"{SMEM_PER_BLOCK - STATIC_SMEM} bytes of shared memory")


def m_block(m: int, bm: int | None = None, blocks: tuple[int, ...] = M_BLOCKS) -> int:
    """The M block of an M-row call among the compiled ``blocks``: the
    smallest that holds M (the largest above that), or, when ``bm`` is
    asked for, the largest compiled block no wider than both (the smallest
    block below that).  So any requested ``bm``, a TPU plan's 128 too, lands
    on a block the kernel has."""
    fit = next((b for b in blocks if m <= b), blocks[-1])
    if bm is None:
        return fit
    return max((b for b in blocks if b <= min(bm, fit)), default=blocks[0])


@functools.lru_cache(maxsize=None)
def plan_launch(m: int, kt: int, nt: int, cap: int, tile: tuple[int, int],
                value_bytes: int, x_bytes: int, sms: int, bm: int | None = None,
                max_stages: int | None = None) -> LaunchPlan:
    """The launch plan of an (M, K) x of ``x_bytes`` per element against a
    (kt, nt)-tile operand of ``cap`` slots per tile column, ``value_bytes``
    per stored value, on a card of ``sms`` SMs (:func:`ring_plan`, two CTAs
    per SM, with at most ``max_stages`` ring stages), M block
    :func:`m_block` of ``bm``.  Cached: a model calls it with a handful of
    argument sets, every step.  The K splits are those of one M block, the
    same at every M, every ``bm`` and every ``max_stages``, so a row's sums
    do not depend on the rows beside it.

    A stage of the ring holds one tile's slab, ``cap * bn * (value_bytes +
    1)`` bytes; staging x takes ``bk * bm * x_bytes`` bytes a K tile, plus
    one zero row of ``bm * x_bytes``."""
    bk, bn = tile
    bm = m_block(m, bm)
    return ring_plan("sod_matmul", bm, kt, nt, sms,
                     cap * bn * (value_bytes + 1), bk * bm * x_bytes,
                     fixed=bm * x_bytes, max_stages=max_stages or MAX_STAGES)


def plan_of(x: torch.Tensor, packed: TiledCSC, **launch) -> LaunchPlan:
    """:func:`plan_launch` for these operands on x's card, with the launch
    parameters ``launch`` (``bm``, ``max_stages``)."""
    return plan_launch(x.shape[0], *packed.grid, packed.cap, tuple(packed.tile),
                       packed.vals.element_size(), x.element_size(),
                       sm_count(x.device.index or 0), **launch)


def check_bulk_aligned(buffers: dict[str, torch.Tensor]) -> None:
    """Raise ValueError unless every buffer starts BULK_ALIGN-byte aligned,
    as the kernel's bulk copies need."""
    bad = {name: t.data_ptr() % BULK_ALIGN for name, t in buffers.items()
           if t.data_ptr() % BULK_ALIGN}
    if bad:
        raise ValueError(f"{', '.join(bad)} must start {BULK_ALIGN}-byte aligned "
                         f"for the kernel's bulk copies (offsets {bad}); pass a "
                         "contiguous copy")


def split_counters(device: torch.device, stream: int, size: int) -> torch.Tensor:
    """The int32 arrival counters of in-launch split-K for one (device,
    stream): at least ``size`` of them, all zero between launches."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def side_band(packed) -> dict[str, torch.Tensor]:
    """The quantization side band of one unstacked operand, checked: ``{}``
    for qmode ``none``; else ``{"scale": (Kt, Nt) f32}`` (int8, fp8) or
    ``{"codebook": (ncodes,) f32}`` (codebook), after checking the stored
    codes' dtype.  Raises for an unknown qmode, codes of the wrong dtype, or
    a side band of the wrong dtype or shape."""
    qmode = packed.qmode
    if qmode not in QMODE_CODE:
        raise ValueError(f"unknown qmode {qmode!r} (expected one of "
                         f"{tuple(QMODE_CODE)})")
    if qmode == "none":
        return {}
    if packed.dtype != CODE_DTYPE[qmode]:
        raise TypeError(f"qmode {qmode!r} stores {CODE_DTYPE[qmode]} codes, "
                        f"got {packed.dtype}")
    name = "codebook" if qmode == "codebook" else "scale"
    t = getattr(packed, name)
    if t is None or t.dtype != torch.float32:
        raise TypeError(f"qmode {qmode!r} needs a float32 {name}, got "
                        f"{None if t is None else t.dtype}")
    if qmode == "codebook":
        if t.ndim != 1 or not 1 <= t.numel() <= MAX_CODES:
            raise ValueError(f"codebook of shape {tuple(t.shape)}: want "
                             f"(ncodes,) with ncodes <= {MAX_CODES}")
    elif tuple(t.shape) != tuple(packed.grid):
        raise ValueError(f"scale of shape {tuple(t.shape)}: want the tile "
                         f"grid {tuple(packed.grid)}")
    return {name: t}


def side_args(side: dict[str, torch.Tensor], qmode: str) -> tuple[int, int, int, int]:
    """(scale pointer, codebook pointer, qmode code, ncodes) for a launch."""
    scale, book = side.get("scale"), side.get("codebook")
    return (0 if scale is None else scale.data_ptr(),
            0 if book is None else book.data_ptr(), QMODE_CODE[qmode],
            0 if book is None else book.numel())


def check_operands(name: str, x: torch.Tensor, packed, out_dtype: torch.dtype,
                   buffers: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Raise for what the matmul kernel ``name`` does not take: a stacked
    operand, mismatched shapes or dtypes, a bad quantization side band, or
    buffers (the operand's, named in ``buffers``, and its side band) that
    are not contiguous on x's device.  Returns the side band
    (:func:`side_band`)."""
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (M, K), got {tuple(x.shape)}")
    if packed.lead:
        raise ValueError(f"one (unstacked) operand expected, got lead dims "
                         f"{packed.lead}")
    if x.shape[1] != packed.shape[0]:
        raise ValueError(f"x K dim {x.shape[1]} != W K {packed.shape[0]}")
    if x.dtype not in DTYPE_CODE or out_dtype not in DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} / out dtype {out_dtype}: float32 "
                        "and bfloat16 are supported")
    if packed.qmode == "none" and packed.dtype != x.dtype:
        raise TypeError(f"weight dtype {packed.dtype} != activation dtype "
                        f"{x.dtype}")
    side = side_band(packed)
    buffers = {**buffers, **side}
    if not (x.is_contiguous() and all(t.is_contiguous() for t in buffers.values())):
        raise ValueError(f"x, {', '.join(buffers)} must be contiguous")
    if any(t.device != x.device for t in buffers.values()):
        raise ValueError(f"x on {x.device}, W on {packed.device}")
    return side


def sod_matmul(x: torch.Tensor, packed: TiledCSC,
               out_dtype: torch.dtype | None = None, **launch) -> torch.Tensor:
    """``x @ decompress(packed)`` for 2-D ``x`` of shape (M, K): (M, N).

    The kernel masks the ragged M, K and N edges itself, so ``x`` is passed
    as it is (no padded copy) and the output comes out at its logical shape.
    ``launch`` holds the tuned launch parameters of :func:`plan_launch`
    (``bm``, ``max_stages``); the plain version on a CPU tensor ignores
    them.
    """
    global launches
    out_dtype = out_dtype or x.dtype
    side = check_operands("sod_matmul", x, packed, out_dtype,
                          {"vals": packed.vals, "rows": packed.rows})
    if x.device.type == "cpu":
        return ref.sod_matmul_ref(x, packed, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"sod_matmul runs on cuda or cpu tensors, not "
                           f"{x.device.type}")
    bk, bn = packed.tile
    if packed.rows.dtype != torch.int8 or bk > 128 or bn % 32 or bn > 1024:
        raise NotImplementedError(
            f"tile {packed.tile} with {packed.rows.dtype} rows: the kernel "
            "takes int8 rows (bk <= 128) and bn a multiple of 32 up to 1024")
    check_bulk_aligned({"vals": packed.vals, "rows": packed.rows})
    m, (k, n) = x.shape[0], packed.shape
    kt, nt = packed.grid
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    plan = plan_of(x, packed, **launch)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    partial = counters = None
    if plan.splits > 1:
        partial = torch.empty((plan.splits, m, n), dtype=torch.float32, device=x.device)
        counters = split_counters(x.device, stream, nt * -(-m // plan.bm))
    scale_ptr, book_ptr, qcode, ncodes = side_args(side, packed.qmode)
    err = _entry()(
        x.data_ptr(), packed.vals.data_ptr(), packed.rows.data_ptr(),
        scale_ptr, book_ptr, out.data_ptr(),
        0 if partial is None else partial.data_ptr(),
        0 if counters is None else counters.data_ptr(),
        m, k, n, kt, nt, packed.cap, bk, bn, plan.bm, plan.splits, plan.stages,
        plan.x_tiles, plan.smem_bytes,
        DTYPE_CODE[x.dtype], DTYPE_CODE[out_dtype], qcode, ncodes, stream)
    if err != 0:
        raise RuntimeError(f"sod_matmul kernel launch failed: cudaError {err}")
    launches += 1
    return out
