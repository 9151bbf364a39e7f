"""The port's sod_matmul against the JAX package's (jnp oracle and the Pallas
kernel in interpret mode), on the CPU; the CUDA kernel itself is held
against its plain version in tests/test_torch_cuda.py.

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
