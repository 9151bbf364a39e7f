"""Wrapper of the block Sparse-on-Dense matmul CUDA kernel
(``csrc/block_matmul.cu``).

Twin of :mod:`repro.kernels.block_matmul` (``block_matmul_pallas``), in
every qmode.  A CPU tensor goes to the plain version
:func:`repro_torch.kernels.ref.block_matmul_ref`; a CUDA tensor goes to the
hand-written kernel, or the call raises.

The kernel walks only the slots ``s < tile_nnz[kt, nt]`` of each macro tile,
which holds for every operand :func:`repro_torch.core.formats.pack_block_csr`
made (the stored sub-blocks come first).

``launches`` counts the kernel launches this wrapper made (plain-version
calls do not count).  Callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.formats import BlockCSR
from repro_torch.kernels import build, ref
from repro_torch.kernels.sod_matmul import (DTYPE_CODE, check_operands, pick_splits,
                                            side_args, sm_count)

__all__ = ["block_matmul", "launches"]

launches = 0

# CTAs per SM that split-K aims for.  A CTA's work is a chain of dependent
# loads (tile_nnz, then the ids, then the gathered x and the sub-blocks), so
# more CTAs in flight hide more of its latency: on an H100 the decode-shape
# time fell from 2 to 8 CTAs per SM and stayed flat beyond.
CTAS_PER_SM = 8


@functools.lru_cache(maxsize=1)
def _entry():
    fn = build.load("block_matmul").block_matmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
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
    if bk > 256 or bn % 32 or bn > 1024:
        raise NotImplementedError(
            f"tile {packed.tile}: the kernel takes bk <= 256 and bn a "
            "multiple of 32 up to 1024")
    m, (k, n) = x.shape[0], packed.shape
    kt, nt = packed.grid
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    bm = 8 if m <= 8 else 32            # the kernel's M block (csrc/block_matmul.cu)
    splits = pick_splits(kt, nt * -(-m // bm), sm_count(x.device.index or 0),
                         CTAS_PER_SM)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    scale_ptr, book_ptr, qcode, ncodes = side_args(side, packed.qmode)
    err = _entry()(
        x.data_ptr(), packed.block_vals.data_ptr(), packed.block_ids.data_ptr(),
        packed.tile_nnz.data_ptr(), scale_ptr, book_ptr, out.data_ptr(),
        0 if partial is None else partial.data_ptr(),
        m, k, n, kt, nt, packed.bcap, packed.br, bk, bn, splits,
        DTYPE_CODE[x.dtype], DTYPE_CODE[out_dtype], qcode, ncodes,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_matmul kernel launch failed: cudaError {err}")
    launches += 1
    return out
