"""Wrapper of the fused decompress + matmul CUDA kernel (``csrc/sod_matmul.cu``).

Twin of :mod:`repro.kernels.sod_matmul` (``sod_matmul_pallas``).  A CPU
tensor goes to the plain version :func:`repro_torch.kernels.ref.sod_matmul_ref`;
a CUDA tensor goes to the hand-written kernel, or the call raises.

``launches`` counts the kernel launches this wrapper made (plain-version
calls do not count), so a run can show that its matmuls went through the
kernel.  Callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.formats import TiledCSC
from repro_torch.kernels import build, ref

__all__ = ["sod_matmul", "launches", "pick_splits", "sm_count", "DTYPE_CODE",
           "check_operands"]

launches = 0

# dtype codes of the kernels' C entry points (all three kernels share them)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CTAS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of one CUDA device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=1)
def _entry():
    fn = build.load("sod_matmul").sod_matmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def pick_splits(kt: int, ctas: int, sms: int, per_sm: int = _CTAS_PER_SM) -> int:
    """K splits so that ``ctas`` CTAs become about ``per_sm`` per SM, with no
    empty split."""
    want = max(1, min(kt, -(-per_sm * sms // max(ctas, 1))))
    per = -(-kt // want)
    return -(-kt // per)


def check_operands(name: str, x: torch.Tensor, packed, out_dtype: torch.dtype,
                   buffers: dict[str, torch.Tensor]) -> None:
    """Raise for what the matmul kernel ``name`` does not take: a quantized
    or stacked operand, mismatched shapes or dtypes, or buffers (the
    operand's, named in ``buffers``) that are not contiguous on x's device."""
    if packed.qmode != "none":
        raise NotImplementedError(
            f"qmode={packed.qmode!r}: the dequant branches of {name} are "
            "not ported yet")
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
    if packed.dtype != x.dtype:
        raise TypeError(f"weight dtype {packed.dtype} != activation dtype "
                        f"{x.dtype}")
    if not (x.is_contiguous() and all(t.is_contiguous() for t in buffers.values())):
        raise ValueError(f"x, {', '.join(buffers)} must be contiguous")
    if any(t.device != x.device for t in buffers.values()):
        raise ValueError(f"x on {x.device}, W on {packed.device}")


def sod_matmul(x: torch.Tensor, packed: TiledCSC,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ decompress(packed)`` for 2-D ``x`` of shape (M, K): (M, N).

    The kernel masks the ragged M, K and N edges itself, so ``x`` is passed
    as it is (no padded copy) and the output comes out at its logical shape.
    """
    global launches
    out_dtype = out_dtype or x.dtype
    check_operands("sod_matmul", x, packed, out_dtype,
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
    m, (k, n) = x.shape[0], packed.shape
    kt, nt = packed.grid
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    bm = 8 if m <= 8 else 32            # the kernel's M block (csrc/sod_matmul.cu)
    splits = pick_splits(kt, nt * -(-m // bm), sm_count(x.device.index or 0))
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    err = _entry()(
        x.data_ptr(), packed.vals.data_ptr(), packed.rows.data_ptr(),
        out.data_ptr(), 0 if partial is None else partial.data_ptr(),
        m, k, n, kt, nt, packed.cap, bk, bn, splits,
        DTYPE_CODE[x.dtype], DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sod_matmul kernel launch failed: cudaError {err}")
    launches += 1
    return out
