"""The port's ``ops.decompress`` against the JAX package's (the Pallas
``decompress_pallas`` kernel in interpret mode for TiledCSC, the scatter for
BlockCSR), on the CPU, and the CUDA kernel's launch plan
(``decompress.plan_launch``); the CUDA kernel itself is held against its
plain version in tests/test_torch_cuda.py.

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
from repro_torch import configs
from repro_torch.core import formats
from repro_torch.interop import block_csr_from_numpy, tiled_csc_from_numpy, to_torch
from repro_torch.kernels import decompress as dk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sod_matmul as sm

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


# ---------------------------------------------------------------------------
# the CUDA kernel's launch plan (pure: no card needed)
# ---------------------------------------------------------------------------
H100_SMS = 132


def _projections():
    """(name, K, N) of every packed projection of llama3.2-1b."""
    c = configs.get_config("llama3.2-1b")
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return [("wq", c.d_model, q), ("wk", c.d_model, kv), ("wv", c.d_model, kv),
            ("wo", q, c.d_model), ("w_gate", c.d_model, c.d_ff),
            ("w_up", c.d_model, c.d_ff), ("w_down", c.d_ff, c.d_model)]


# stored value bytes of each (qmode, value dtype): the kernel's cases
VALUE_BYTES = {"none-bfloat16": 2, "none-float32": 4, "int8": 1, "fp8": 1, "codebook": 1}


def _check_plan(plan, kt, nt, cap, tile, value_bytes, out_bytes, sms=H100_SMS):
    bk, bn = tile
    stage, dense = cap * bn * (value_bytes + 1), bk * bn * out_bytes
    assert plan.smem_bytes == plan.dense_buffers * dense + plan.stages * stage
    assert plan.smem_bytes + sm.STATIC_SMEM <= sm.SMEM_PER_BLOCK
    assert plan.ctas_per_sm * (plan.smem_bytes + sm.STATIC_SMEM + sm.SMEM_RESERVED) \
        <= sm.SMEM_PER_SM
    assert 2 <= plan.stages <= sm.MAX_STAGES and plan.dense_buffers in (1, 2)
    assert 1 <= plan.grid <= kt * nt
    assert plan.grid <= sms * plan.ctas_per_sm
    assert plan.threads % bn == 0 and plan.threads % 32 == 0 and plan.threads <= 1024


@pytest.mark.parametrize("values", list(VALUE_BYTES))
@pytest.mark.parametrize("name,k,n", _projections())
def test_plan_fits_every_projection(name, k, n, values):
    """Every llama3.2-1b projection, in every qmode and both output dtypes,
    at any cap a 128-row tile can have, gets a plan that fits a CTA's and
    an SM's shared memory."""
    tile = (128, 128)
    kt, nt = -(-k // 128), -(-n // 128)
    for out_bytes in (2, 4):
        for cap in (1, 38, 64, 100, 128):
            plan = dk.plan_launch(kt, nt, cap, tile, VALUE_BYTES[values], out_bytes,
                                  H100_SMS)
            _check_plan(plan, kt, nt, cap, tile, VALUE_BYTES[values], out_bytes)
            assert plan.grid == min(kt * nt, H100_SMS * plan.ctas_per_sm)


@pytest.mark.parametrize("kt,nt", [(1, 1), (1, 3), (16, 4), (16, 16), (64, 16),
                                   (16, 64), (3, 260)])
@pytest.mark.parametrize("launch", [{}, {"CTAS_PER_SM": 1}, {"CTAS_PER_SM": 4},
                                    {"sms": 1}, {"CTAS_PER_SM": 1, "sms": 114},
                                    {"THREADS": 96}, {"THREADS": 2048}])
def test_plan_grid_never_exceeds_the_tiles(kt, nt, launch, monkeypatch):
    """At the module's plan constants, other settings of them, and cards of
    other SM counts."""
    sms = launch.get("sms", H100_SMS)
    for name in ("CTAS_PER_SM", "THREADS"):
        monkeypatch.setattr(dk, name, launch.get(name, getattr(dk, name)))
    dk.plan_launch.cache_clear()
    try:
        for tile, cap in (((128, 128), 64), ((64, 128), 64), ((128, 32), 9),
                          ((128, 256), 32)):
            for value_bytes, out_bytes in ((2, 2), (1, 4), (4, 4)):
                plan = dk.plan_launch(kt, nt, cap, tile, value_bytes, out_bytes, sms)
                _check_plan(plan, kt, nt, cap, tile, value_bytes, out_bytes, sms)
                assert plan.ctas_per_sm <= dk.CTAS_PER_SM
                assert plan.stages <= max(2, -(-kt * nt // plan.grid))
                want = min(dk.THREADS, dk.MAX_THREADS)
                assert plan.threads == tile[1] * max(1, want // tile[1])
    finally:
        dk.plan_launch.cache_clear()


def test_plan_is_cached_and_prefers_two_dense_tiles():
    a = dk.plan_launch(16, 64, 64, (128, 128), 2, 2, H100_SMS)
    assert a is dk.plan_launch(16, 64, 64, (128, 128), 2, 2, H100_SMS)
    assert (a.dense_buffers, a.ctas_per_sm, a.grid) == (2, dk.CTAS_PER_SM,
                                                        H100_SMS * dk.CTAS_PER_SM)
    # two CTAs of an SM cannot both hold two f32 tiles: each keeps one
    b = dk.plan_launch(16, 64, 64, (128, 128), 1, 4, H100_SMS)
    assert (b.dense_buffers, b.ctas_per_sm, b.grid) == (1, 2, 2 * H100_SMS)


@pytest.mark.parametrize("tile,cap,value_bytes,out_bytes", [
    ((128, 1024), 1, 2, 2),        # a bf16 dense tile of 256 KB
    ((128, 512), 8, 1, 4),         # an f32 tile of 256 KB
    ((128, 512), 128, 4, 2),       # two slabs of 320 KB
    ((128, 256), 128, 4, 4),       # a 128 KB f32 tile beside two 160 KB slabs
])
def test_plan_raises_when_the_slabs_do_not_fit(tile, cap, value_bytes, out_bytes):
    with pytest.raises(ValueError, match="do not fit"):
        dk.plan_launch(4, 4, cap, tile, value_bytes, out_bytes, H100_SMS)


@pytest.mark.parametrize("qmode", ["none", "int8", "fp8", "codebook"])
def test_cpu_path_takes_no_plan_and_launches_nothing(qmode, monkeypatch):
    """On a CPU tensor the wrapper runs the plain version: it asks for no
    launch plan and counts no launch."""
    p = formats.pack_tiled_csc(to_torch(_sparse((300, 260), 0.3, "bfloat16", 8), "cpu"))
    if qmode != "none":
        p = formats.quantize_packed(p, qmode)

    def no_plan(*args):
        raise AssertionError("the CPU path asked for a launch plan")

    monkeypatch.setattr(dk, "plan_of", no_plan)
    before = dk.launches
    d = dk.decompress(p)
    db = dk.decompress(p, torch.bfloat16)
    assert dk.launches == before
    assert torch.equal(d, ref.decompress_tiled_ref(p))
    assert torch.equal(db, ref.decompress_tiled_ref(p, torch.bfloat16))
