"""Wrapper of the standalone decompression CUDA kernel (``csrc/decompress.cu``).

Twin of :mod:`repro.kernels.decompress` (``decompress_pallas``).  A CPU
tensor goes to the plain version
:func:`repro_torch.kernels.ref.decompress_tiled_ref`; a CUDA tensor goes to
the hand-written kernel, or the call raises.  Either way the result has the
logical (K, N) shape and is bit-equal to ``TiledCSC.to_dense()``.

``launches`` counts the kernel launches this wrapper made (plain-version
calls do not count).  Callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.formats import TiledCSC
from repro_torch.kernels import build, ref
from repro_torch.kernels.sod_matmul import DTYPE_CODE

__all__ = ["decompress", "launches"]

launches = 0

_SMEM_BYTES = 232448   # shared memory one block may use on sm_90 (the tile)


@functools.lru_cache(maxsize=1)
def _entry():
    fn = build.load("decompress").decompress_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decompress(packed: TiledCSC) -> torch.Tensor:
    """The dense (K, N) matrix of one unstacked ``TiledCSC`` operand, in its
    value dtype."""
    global launches
    if packed.qmode != "none":
        raise NotImplementedError(
            f"qmode={packed.qmode!r}: the dequant branch of decompress is not "
            "ported yet")
    if packed.lead:
        raise ValueError(f"one (unstacked) operand expected, got lead dims "
                         f"{packed.lead}")
    if packed.dtype not in DTYPE_CODE:
        raise TypeError(f"value dtype {packed.dtype}: float32 and bfloat16 "
                        "are supported")
    if not (packed.vals.is_contiguous() and packed.rows.is_contiguous()):
        raise ValueError("vals and rows must be contiguous")
    if packed.rows.device != packed.device:
        raise ValueError(f"vals on {packed.device}, rows on {packed.rows.device}")
    if packed.device.type == "cpu":
        return ref.decompress_tiled_ref(packed)
    if packed.device.type != "cuda":
        raise RuntimeError(f"decompress runs on cuda or cpu tensors, not "
                           f"{packed.device.type}")
    bk, bn = packed.tile
    if (packed.rows.dtype != torch.int8 or bk > 128 or bn % 32 or bn > 1024
            or bk * bn * packed.vals.element_size() > _SMEM_BYTES):
        raise NotImplementedError(
            f"tile {packed.tile} with {packed.rows.dtype} rows: the kernel "
            "takes int8 rows (bk <= 128), bn a multiple of 32 up to 1024, "
            f"and a tile of at most {_SMEM_BYTES} bytes")
    k, n = packed.shape
    kt, nt = packed.grid
    out = torch.empty((k, n), dtype=packed.dtype, device=packed.device)
    if out.numel() == 0:
        return out
    err = _entry()(
        packed.vals.data_ptr(), packed.rows.data_ptr(), out.data_ptr(),
        k, n, kt, nt, packed.cap, bk, bn, DTYPE_CODE[packed.dtype],
        torch.cuda.current_stream(packed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decompress kernel launch failed: cudaError {err}")
    launches += 1
    return out
