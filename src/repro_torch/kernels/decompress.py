"""Wrapper of the standalone decompression CUDA kernel (``csrc/decompress.cu``).

Twin of :mod:`repro.kernels.decompress` (``decompress_pallas``), in every
qmode.  A CPU tensor goes to the plain version
:func:`repro_torch.kernels.ref.decompress_tiled_ref`; a CUDA tensor goes to
the hand-written kernel, or the call raises.  Either way the result has the
logical (K, N) shape and is bit-equal to ``TiledCSC.to_dense()`` cast to the
output dtype (float32 by default for a quantized operand).

``launches`` counts the kernel launches this wrapper made (plain-version
calls do not count).  Callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.formats import TiledCSC
from repro_torch.kernels import build, ref
from repro_torch.kernels.sod_matmul import DTYPE_CODE, side_args, side_band

__all__ = ["decompress", "launches"]

launches = 0

# shared memory one block may use on sm_90, less the kernels' codebook table
_SMEM_BYTES = 232448 - 512


@functools.lru_cache(maxsize=1)
def _entry():
    fn = build.load("decompress").decompress_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
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
    tile_bytes = bk * bn * out_dtype.itemsize
    if (packed.rows.dtype != torch.int8 or bk > 128 or bn % 32 or bn > 1024
            or tile_bytes > _SMEM_BYTES):
        raise NotImplementedError(
            f"tile {packed.tile} with {packed.rows.dtype} rows: the kernel "
            "takes int8 rows (bk <= 128), bn a multiple of 32 up to 1024, "
            f"and a tile of at most {_SMEM_BYTES} bytes")
    k, n = packed.shape
    kt, nt = packed.grid
    out = torch.empty((k, n), dtype=out_dtype, device=packed.device)
    if out.numel() == 0:
        return out
    scale_ptr, book_ptr, qcode, ncodes = side_args(side, packed.qmode)
    err = _entry()(
        packed.vals.data_ptr(), packed.rows.data_ptr(), scale_ptr, book_ptr,
        out.data_ptr(), k, n, kt, nt, packed.cap, bk, bn,
        DTYPE_CODE.get(packed.dtype, 0), DTYPE_CODE[out_dtype], qcode, ncodes,
        torch.cuda.current_stream(packed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decompress kernel launch failed: cudaError {err}")
    launches += 1
    return out
