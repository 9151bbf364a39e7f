"""The port's ``ops.decompress`` against the JAX package's (the Pallas
``decompress_pallas`` kernel in interpret mode for TiledCSC, the scatter for
BlockCSR), on the CPU; the CUDA kernel itself is held against its plain
version in tests/test_torch_cuda.py.

Tolerance: none.  Decompression places each stored value once, so the dense
matrices are compared bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import pruning as jpruning
from repro.kernels import ops as jops
from repro_torch.core import formats
from repro_torch.interop import block_csr_from_numpy, tiled_csc_from_numpy, to_torch
from repro_torch.kernels import decompress as dk
from repro_torch.kernels import ops, ref

DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _sparse(shape, density, dtype, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[rng.random(shape) >= density] = 0.0
    return w.astype(DTYPES[dtype])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("shape,tile,density,dtype", [
    ((128, 128), (128, 128), 0.2, "float32"),
    ((300, 260), (128, 128), 0.4, "float32"),      # ragged: logical shape out
    ((300, 260), (128, 128), 0.3, "bfloat16"),
    ((64, 512), (128, 128), 0.05, "float32"),
    ((256, 384), (128, 128), 0.9, "bfloat16"),     # cap above most columns' count
    ((200, 130), (64, 128), 0.3, "float32"),
])
def test_decompress_tiled_equal(shape, tile, density, dtype):
    w = _sparse(shape, density, dtype, seed=shape[0] + int(density * 10))
    jp = jformats.pack_tiled_csc(jnp.asarray(w), tile=tile)
    tp = tiled_csc_from_numpy(np.asarray(jp.vals), np.asarray(jp.rows), jp.shape,
                              jp.tile, device="cpu")
    dj = np.asarray(jops.decompress(jp))
    dt = ops.decompress(tp)
    assert dt.shape == shape and dt.dtype == tp.dtype
    np.testing.assert_array_equal(_np(dt), dj.astype(np.float32))
    np.testing.assert_array_equal(_np(dt), w.astype(np.float32))


def test_decompress_with_interleaved_padding():
    """cap < bk: -1 sentinels sit between real rows, and every slot after
    one is still placed."""
    w = _sparse((256, 256), 0.3, "float32", seed=3)
    tp = formats.pack_tiled_csc(to_torch(w, "cpu"))
    col = tp.rows[0, 0, :, 0].tolist()
    first_real = next(i for i, r in enumerate(col) if r >= 0)
    assert -1 in col[first_real:]
    np.testing.assert_array_equal(ops.decompress(tp).numpy(), w)
    np.testing.assert_array_equal(
        ops.decompress(tp).numpy(),
        np.asarray(jops.decompress(jformats.pack_tiled_csc(jnp.asarray(w)))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decompress_block_csr_equal(dtype):
    w = _sparse((300, 260), 1.0, dtype, seed=4)
    w = np.asarray(jpruning.block_prune(jnp.asarray(w), 0.3))
    jp = jformats.pack_block_csr(jnp.asarray(w))
    tp = block_csr_from_numpy(np.asarray(jp.block_vals), np.asarray(jp.block_ids),
                              np.asarray(jp.tile_nnz), jp.shape, jp.tile, jp.br,
                              device="cpu")
    np.testing.assert_array_equal(_np(ops.decompress(tp)),
                                  np.asarray(jops.decompress(jp)).astype(np.float32))


def test_decompress_dense_passes_through():
    w = to_torch(_sparse((64, 32), 0.5, "float32", seed=5), "cpu")
    assert ops.decompress(w) is w
    assert np.asarray(jops.decompress(jnp.asarray(w.numpy()))).shape == (64, 32)


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    p = formats.pack_tiled_csc(to_torch(_sparse((300, 260), 0.3, "float32", 6),
                                        "cpu"))
    before = dk.launches
    d = dk.decompress(p)
    assert dk.launches == before
    assert torch.equal(d, ref.decompress_tiled_ref(p))
    assert torch.equal(d, p.to_dense())


def test_wrapper_rejects_bad_inputs():
    w = to_torch(_sparse((256, 256), 0.3, "float32", 7), "cpu")
    with pytest.raises(ValueError):          # stacked operand
        dk.decompress(formats.pack_tiled_csc(torch.stack([w, w])))
    p = formats.pack_tiled_csc(w)
    with pytest.raises(ValueError, match="unknown qmode"):
        dk.decompress(dataclasses.replace(p, qmode="int4"))
    with pytest.raises(TypeError):           # int8 qmode over float values
        dk.decompress(dataclasses.replace(p, qmode="int8"))
    q = formats.quantize_packed(p, "codebook")   # a quantized operand runs
    assert dk.decompress(q).dtype == torch.float32
    with pytest.raises(TypeError):
        dk.decompress(dataclasses.replace(p, vals=p.vals.double()))
