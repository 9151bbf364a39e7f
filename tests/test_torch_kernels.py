"""The port's sod_matmul against the JAX package's (jnp oracle and the Pallas
kernel in interpret mode), on the CPU, with the launch plans of both matmul
kernels; the CUDA kernels themselves are held against their plain versions
in tests/test_torch_cuda.py.

Tolerance: in float32 both sides accumulate in f32, in different orders;
atol 5e-4 / rtol 1e-4 is the bound the JAX package's own kernel tests use
(tests/test_kernels.py).
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.kernels import ops as jops
from repro_torch.core import formats
from repro_torch.interop import tiled_csc_from_numpy, to_torch
from repro_torch.kernels import block_matmul as bmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sod_matmul as sm

ATOL, RTOL = 5e-4, 1e-4


def _case(kn, m, density, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(kn).astype(np.float32)
    w[rng.random(kn) >= density] = 0.0
    x = rng.standard_normal((m, kn[0])).astype(np.float32)
    return w, x


def _carry(jp):
    return tiled_csc_from_numpy(np.asarray(jp.vals), np.asarray(jp.rows),
                                jp.shape, jp.tile, device="cpu")


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("kn,m,density,tile", [
    ((256, 256), 128, 0.3, (128, 128)),
    ((300, 260), 77, 0.15, (128, 128)),
    ((512, 384), 4, 0.5, (128, 128)),
    ((200, 130), 33, 0.08, (64, 128)),
])
def test_sod_matmul_matches_reference(kn, m, density, tile, impl):
    w, x = _case(kn, m, density)
    jp = jformats.pack_tiled_csc(jnp.asarray(w), tile=tile)
    yj = np.asarray(jops.sod_matmul(jnp.asarray(x), jp, impl=impl))
    yt = ops.sod_matmul(to_torch(x, "cpu"), _carry(jp))
    assert yt.shape == (m, kn[1]) and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, atol=ATOL, rtol=RTOL)


def test_sod_matmul_nd_batch_and_bypass():
    w, _ = _case((300, 260), 1, 0.2, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 5, 300)).astype(np.float32)
    p = formats.pack_tiled_csc(to_torch(w, "cpu"))
    y = ops.sod_matmul(to_torch(x, "cpu"), p)
    assert y.shape == (2, 5, 260)
    np.testing.assert_allclose(y.numpy(), x @ w, atol=ATOL, rtol=RTOL)
    yj = np.asarray(jops.sod_matmul(jnp.asarray(x), jnp.asarray(w)))
    yd = ops.sod_matmul(to_torch(x, "cpu"), to_torch(w, "cpu"))
    np.testing.assert_allclose(yd.numpy(), yj, atol=ATOL, rtol=RTOL)


def test_sod_matmul_out_dtype():
    w, x = _case((256, 128), 8, 0.3, seed=6)
    p = formats.pack_tiled_csc(to_torch(w, "cpu"))
    y = ops.sod_matmul(to_torch(x, "cpu"), p, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), x @ w, rtol=2**-7, atol=1e-2)


def test_wrapper_rejects_bad_inputs():
    w, x = _case((256, 256), 8, 0.3, seed=7)
    p = formats.pack_tiled_csc(to_torch(w, "cpu"))
    with pytest.raises(ValueError):          # wrong K
        sm.sod_matmul(torch.zeros(8, 200), p)
    with pytest.raises(TypeError):           # weight dtype != activation dtype
        sm.sod_matmul(to_torch(x, "cpu").bfloat16(), p)
    with pytest.raises(ValueError):          # non-contiguous activations
        sm.sod_matmul(torch.zeros(256, 8).T, p)
    stacked = formats.pack_tiled_csc(torch.stack([to_torch(w, "cpu")] * 2))
    with pytest.raises(ValueError):          # stacked operand
        sm.sod_matmul(to_torch(x, "cpu"), stacked)
    with pytest.raises(ValueError, match="unknown qmode"):
        sm.sod_matmul(to_torch(x, "cpu"), dataclasses.replace(p, qmode="int4"))
    with pytest.raises(TypeError):           # int8 qmode over float values
        sm.sod_matmul(to_torch(x, "cpu"), dataclasses.replace(p, qmode="int8"))
    q = formats.quantize_packed(p, "int8")   # a quantized operand runs
    assert sm.sod_matmul(to_torch(x, "cpu"), q).shape == (8, 256)


@pytest.mark.parametrize("x_dtype,w_dtype,out_dtype", [
    ("bfloat16", "bfloat16", "float32"),   # the f32 sums are the output
    ("bfloat16", "float32", "bfloat16"),   # bf16 activations meet an f32 weight
    ("bfloat16", "float32", "float32"),
])
def test_dense_bypass_matches_reference(x_dtype, w_dtype, out_dtype):
    """The dense bypass is the reference's ``jnp.dot(x, w,
    preferred_element_type=float32).astype(out_dtype)``: operands promoted,
    f32 sums, one cast.  Exact up to the order of the f32 sums."""
    dt = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}
    w, x = _case((256, 192), 8, 0.5, seed=9)
    x, w = x.astype(dt[x_dtype][0]), w.astype(dt[w_dtype][0])
    yj = np.asarray(jops.sod_matmul(jnp.asarray(x), jnp.asarray(w),
                                    out_dtype=dt[out_dtype][1]))
    yt = ops.sod_matmul(to_torch(x, "cpu"), to_torch(w, "cpu"),
                        out_dtype=dt[out_dtype][2])
    assert yt.dtype == dt[out_dtype][2]
    np.testing.assert_allclose(yt.float().numpy(), yj.astype(np.float32),
                               atol=1e-5, rtol=1e-5 if out_dtype == "float32" else 2**-8)


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    w, x = _case((256, 256), 8, 0.3, seed=8)
    p = formats.pack_tiled_csc(to_torch(w, "cpu"))
    before = sm.launches
    y = sm.sod_matmul(to_torch(x, "cpu"), p)
    assert sm.launches == before
    assert torch.equal(y, ref.sod_matmul_ref(to_torch(x, "cpu"), p))


@pytest.mark.parametrize("kt,ctas,sms", [
    (16, 16, 132), (64, 16, 132), (16, 256, 132), (16, 64, 132), (3, 1, 132),
    (1, 1, 132), (64, 4, 132), (16, 300, 132),
])
def test_pick_splits_leaves_no_split_empty(kt, ctas, sms):
    s = sm.pick_splits(kt, ctas, sms)
    per = -(-kt // s)
    assert 1 <= s <= kt
    assert (s - 1) * per < kt       # the last split starts inside K
    if ctas >= 2 * sms:             # the card is full without splitting K
        assert s == 1


@pytest.mark.parametrize("kt,ctas,sms,per_sm,splits", [
    (16, 16, 132, 2, 16), (16, 4, 132, 2, 16), (16, 64, 132, 2, 4),
    (64, 16, 132, 2, 16), (16, 256, 132, 2, 2), (64, 4, 132, 2, 64),
    (16, 300, 132, 2, 1), (3, 1, 132, 2, 3), (1, 1, 132, 2, 1),
    (16, 16, 132, 8, 16), (16, 4, 132, 8, 16), (64, 16, 132, 8, 64),
    (16, 64, 132, 8, 16), (64, 64, 132, 8, 16), (16, 1024, 132, 8, 2),
    (16, 16, 132, 1, 8), (64, 16, 132, 1, 8), (16, 64, 78, 2, 3),
])
def test_pick_splits_values_unchanged(kt, ctas, sms, per_sm, splits):
    """block_matmul (8 CTAs per SM) and the launch plan both split K with
    pick_splits; its values stay those it has always given."""
    assert sm.pick_splits(kt, ctas, sms, per_sm) == splits


# (K, N) of the serving path's projections (chip_smoke.PATH_SHAPES)
PATH_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]


@pytest.mark.parametrize("act_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("qmode", ["none", "int8", "fp8", "codebook"])
@pytest.mark.parametrize("kn", PATH_SHAPES)
def test_launch_plan_fits_the_smem_budget(kn, qmode, act_dtype):
    """For caps 8-128 and M from decode to prefill: dynamic shared memory
    within one CTA's 227 KB, the planned CTAs per SM fitting in the SM's
    228 KB together, a ring of at least 2 stages, and the bytes the plan
    reports being the ring, the staged x and its zero row."""
    bk, bn = tile = (128, 128)
    kt, nt = kn[0] // bk, kn[1] // bn
    xb = act_dtype.itemsize
    vb = xb if qmode == "none" else 1
    for cap in range(8, 129, 8):
        for m in (1, 4, 5, 8, 9, 77, 128):
            plan = sm.plan_launch(m, kt, nt, cap, tile, vb, xb, 132)
            tiles = -(-kt // plan.splits)
            assert plan.bm == (4 if m <= 4 else 8 if m <= 8 else 32)
            assert plan.splits == sm.pick_splits(kt, nt * -(-m // plan.bm), 132,
                                                 plan.ctas_per_sm)
            assert 2 <= plan.stages <= sm.MAX_STAGES
            assert plan.x_tiles in (1, tiles)
            assert plan.smem_bytes == (plan.stages * cap * bn * (vb + 1)
                                       + (plan.x_tiles * bk + 1) * plan.bm * xb)
            assert plan.smem_bytes + sm.STATIC_SMEM <= sm.SMEM_PER_BLOCK
            assert plan.ctas_per_sm * (plan.smem_bytes + sm.STATIC_SMEM
                                       + sm.SMEM_RESERVED) <= sm.SMEM_PER_SM
            if vb < 4 and cap <= 72:          # the path's caps: two CTAs per SM
                assert plan.ctas_per_sm == 2
            if vb == 1 and cap <= 72 and m <= 8:   # every slab of a split in flight
                assert plan.stages >= tiles


def test_launch_plan_raises_over_budget():
    with pytest.raises(ValueError, match="do not fit"):
        sm.plan_launch(4, 16, 16, 128, (128, 1024), 2, 2, 132)


def test_bulk_alignment_check_raises_on_offset_view():
    w, _ = _case((256, 256), 1, 0.3, seed=10)
    p = formats.pack_tiled_csc(to_torch(w, "cpu").bfloat16())
    sm.check_bulk_aligned({"vals": p.vals, "rows": p.rows})
    flat = torch.empty(p.vals.numel() + 1, dtype=p.vals.dtype)
    off = flat[1:].view(p.vals.shape)             # one element past an aligned start
    off.copy_(p.vals)
    with pytest.raises(ValueError, match="vals must start 16-byte aligned"):
        sm.check_bulk_aligned({"vals": off, "rows": p.rows})
    # a layer of a stacked operand starts a whole number of slabs in: aligned
    stacked = formats.pack_tiled_csc(torch.stack([to_torch(w, "cpu").bfloat16()] * 3))
    layer = stacked.layer(1)
    assert layer.vals.data_ptr() != stacked.vals.data_ptr()
    sm.check_bulk_aligned({"vals": layer.vals, "rows": layer.rows})


def test_split_counters_keyed_by_stream_and_grown():
    dev = torch.device("cpu")
    try:
        a = sm.split_counters(dev, 1, 4)
        assert a.dtype == torch.int32 and a.numel() == 4 and not a.any()
        assert sm.split_counters(dev, 1, 3) is a          # large enough: reused
        b = sm.split_counters(dev, 2, 4)                  # another stream
        assert b.data_ptr() != a.data_ptr()
        c = sm.split_counters(dev, 1, 9)                  # grown by reallocation
        assert c.numel() == 9 and not c.any()
        assert sm.split_counters(dev, 1, 9) is c
    finally:
        for key in [k for k in sm._counters if k[0] is None]:
            del sm._counters[key]


# ---------------------------------------------------------------------------
# a packed operand whose value dtype differs from x's (ops promotes)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
@pytest.mark.parametrize("x_dtype,w_dtype", [("bfloat16", "float32"),
                                             ("float32", "bfloat16")])
def test_mixed_dtype_packed_matches_reference(fmt, x_dtype, w_dtype):
    """A qmode-none TiledCSC or BlockCSR in another dtype than x: the
    reference's ``impl="jnp"`` promotes both to f32, sums in f32 and casts
    once to x's dtype.  Tolerance: f32 output as the rest of this file; a
    bf16 output may round one bf16 step (2**-7 relative) apart, since the
    f32 sums are taken in another order."""
    dt = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
    w, x = _case((256, 256), 4, 0.3, seed=11)
    x, w = x.astype(dt[x_dtype][0]), w.astype(dt[w_dtype][0])
    jpack = jformats.pack_tiled_csc if fmt == "tiled_csc" else jformats.pack_block_csr
    tpack = formats.pack_tiled_csc if fmt == "tiled_csc" else formats.pack_block_csr
    yj = np.asarray(jops.sod_matmul(jnp.asarray(x), jpack(jnp.asarray(w)), impl="jnp"))
    p = tpack(to_torch(w, "cpu"))
    assert p.dtype == dt[w_dtype][1]
    yt = ops.sod_matmul(to_torch(x, "cpu"), p)
    assert yt.shape == (4, 256) and yt.dtype == dt[x_dtype][1]
    if x_dtype == "float32":
        np.testing.assert_allclose(yt.numpy(), yj, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(yt.float().numpy(), yj.astype(np.float32),
                                   atol=1e-5, rtol=2**-7)


def test_mixed_dtype_keeps_quantized_checks():
    """Promotion is for qmode none only: codes of the wrong dtype still
    raise, and a same-dtype operand reaches the wrapper as it is."""
    w, x = _case((256, 256), 4, 0.3, seed=12)
    p = formats.pack_tiled_csc(to_torch(w, "cpu"))
    with pytest.raises(TypeError):           # int8 qmode over float values
        ops.sod_matmul(to_torch(x, "cpu").bfloat16(), dataclasses.replace(p, qmode="int8"))
    xt = to_torch(x, "cpu")
    assert ops._promote(xt, p) == (xt, p)


# ---------------------------------------------------------------------------
# block_matmul's launch plan (csrc/block_matmul.cu runs only on the card)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("qmode", ["none", "int8", "fp8", "codebook"])
@pytest.mark.parametrize("kn", PATH_SHAPES)
def test_block_launch_plan_fits_the_smem_budget(kn, qmode, act_dtype):
    """For every bcap a (128, 128) tile of (8, 128) sub-blocks can have and M
    from decode to prefill: the M block, its groups and the threads of a
    CTA, dynamic shared memory within one CTA's 227 KB,
    the planned CTAs per SM fitting in the SM's 228 KB together, a ring of
    at least 2 stages, no empty K split, and the bytes the plan reports
    being the ring, the staged x (of every M group) and the list of
    non-empty tiles."""
    bk, bn = tile = (128, 128)
    br = 8
    kt, nt = kn[0] // bk, kn[1] // bn
    xb = act_dtype.itemsize
    vb = xb if qmode == "none" else 1
    for bcap in range(1, bk // br + 1):
        stage = bcap * br * bn * vb + bmm.ids_stage_bytes(bcap)
        for m in (1, 4, 5, 8, 9, 77, 128):
            plan = bmm.plan_launch(m, kt, nt, bcap, br, tile, vb, xb, 132)
            tiles = -(-kt // plan.splits)
            rows = plan.bm * plan.m_groups
            assert plan.bm == (4 if m <= 4 else 8 if m <= 8 else 16)
            assert plan.m_groups == (min(bmm.M_GROUPS, -(-m // plan.bm)) if m > 8 else 1)
            assert plan.splits == sm.pick_splits(kt, nt * -(-m // rows), 132,
                                                 plan.ctas_per_sm)
            assert (plan.splits - 1) * tiles < kt      # the last split starts inside K
            assert 2 <= plan.stages <= sm.MAX_STAGES
            assert plan.x_tiles in (1, tiles)
            staged = 4 if m > 8 else xb             # x staged in f32 at BM = 16
            assert plan.smem_bytes == (plan.stages * stage + plan.x_tiles * bk * rows * staged
                                       + 8 * tiles)
            cols = 2 if plan.bm == 16 else 1        # columns a thread
            assert bn // cols * plan.m_groups <= bmm.MAX_THREADS
            assert plan.smem_bytes + sm.STATIC_SMEM <= sm.SMEM_PER_BLOCK
            assert plan.ctas_per_sm * (plan.smem_bytes + sm.STATIC_SMEM
                                       + sm.SMEM_RESERVED) <= sm.SMEM_PER_SM
            if vb < 4:                                  # bf16 values or codes: two CTAs per SM
                assert plan.ctas_per_sm == bmm.CTAS_PER_SM
            if vb == 1 and m <= 8:                      # every slab of a split in flight
                assert plan.stages >= tiles
                assert plan.x_tiles == tiles            # x staged once, beside the slabs


def test_block_launch_plan_raises_over_budget():
    with pytest.raises(ValueError, match="block_matmul: two stages"):
        bmm.plan_launch(4, 16, 16, 32, 8, (256, 1024), 4, 4, 132)


@pytest.mark.parametrize("bcap", [1, 2, 3, 4, 5, 11, 16, 32])
def test_block_ids_stage_holds_every_copy(bcap):
    """The ids' copy starts at the 16-byte boundary at or below the tile's
    first id (0-3 ids before it) and is a multiple of 16 bytes: it fits the
    stage's ids area for every lead and stored count."""
    for lead in range(4):
        for nnz in range(1, bcap + 1):
            copy = (4 * (lead + nnz) + 15) // 16 * 16
            assert copy % 16 == 0 and copy <= bmm.ids_stage_bytes(bcap)
    assert bmm.ids_stage_bytes(bcap) % 16 == 0


def test_block_bulk_alignment_raises_on_offset_view():
    """block_vals must start 16-byte aligned; a layer of a stacked operand
    does (a whole number of 32-byte slabs in)."""
    w = np.random.default_rng(13).standard_normal((256, 256)).astype(np.float32)
    p = formats.pack_block_csr(to_torch(w, "cpu").bfloat16())
    sm.check_bulk_aligned({"block_vals": p.block_vals})
    flat = torch.empty(p.block_vals.numel() + 1, dtype=p.block_vals.dtype)
    off = flat[1:].view(p.block_vals.shape)
    off.copy_(p.block_vals)
    with pytest.raises(ValueError, match="block_vals must start 16-byte aligned"):
        sm.check_bulk_aligned({"block_vals": off})
    stacked = formats.pack_block_csr(torch.stack([to_torch(w, "cpu").bfloat16()] * 3))
    for i in range(3):
        sm.check_bulk_aligned({"block_vals": stacked.layer(i).block_vals})
