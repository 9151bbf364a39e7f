"""TiledCSC packing, to_dense, byte accounting and magnitude pruning of the
PyTorch port are equal, bit for bit, to the JAX package's."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import pruning as jpruning
from repro_torch.core import formats, pruning
from repro_torch.interop import tiled_csc_from_numpy, to_torch

DTYPES = {"float32": (jnp.float32, np.float32),
          "bfloat16": (jnp.bfloat16, ml_dtypes.bfloat16)}


def _sparse(shape, density, dtype, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[rng.random(shape) >= density] = 0.0
    return w.astype(DTYPES[dtype][1])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_packed_equal(tp, jp):
    assert tp.shape == tuple(jp.shape) and tp.tile == tuple(jp.tile)
    assert tp.cap == jp.cap
    assert str(tp.rows.dtype).split(".")[-1] == str(jp.rows.dtype)
    np.testing.assert_array_equal(_np(tp.rows), np.asarray(jp.rows))
    np.testing.assert_array_equal(_np(tp.vals),
                                  np.asarray(jp.vals).astype(np.float32))


@pytest.mark.parametrize("shape,tile,density,dtype", [
    ((256, 256), (128, 128), 0.1, "float32"),
    ((256, 256), (128, 128), 0.3, "float32"),
    ((256, 256), (128, 128), 0.7, "float32"),
    ((256, 256), (128, 128), 0.3, "bfloat16"),
    ((300, 260), (128, 128), 0.3, "float32"),     # not tile multiples
    ((300, 260), (128, 128), 0.1, "bfloat16"),
    ((300, 260), (128, 128), 0.7, "bfloat16"),
    ((200, 130), (64, 128), 0.7, "float32"),
    ((200, 130), (64, 128), 0.3, "bfloat16"),
    ((2, 3, 192, 136), (128, 128), 0.3, "float32"),   # stacked (G, P, K, N)
    ((2, 3, 192, 136), (128, 128), 0.7, "float32"),   # leaf: one shared cap
    ((2, 3, 192, 136), (128, 128), 0.1, "bfloat16"),
])
def test_pack_tiled_csc_equal(shape, tile, density, dtype):
    w = _sparse(shape, density, dtype, seed=len(shape) * 7 + int(density * 10))
    jp = jformats.pack_tiled_csc(jnp.asarray(w), tile=tile)
    tp = formats.pack_tiled_csc(to_torch(w, "cpu"), tile=tile)
    _assert_packed_equal(tp, jp)
    assert tp.lead == tuple(shape[:-2])
    # to_dense, nbytes_* and the observed cap agree too
    np.testing.assert_array_equal(_np(tp.to_dense()),
                                  np.asarray(jp.to_dense()).astype(np.float32))
    np.testing.assert_array_equal(_np(tp.to_dense()), w.astype(np.float32))
    assert tp.nbytes_compressed() == jp.nbytes_compressed()
    assert tp.nbytes_dense() == jp.nbytes_dense()
    assert (formats.observed_tiled_cap(to_torch(w, "cpu"), tile)
            == jformats.observed_tiled_cap(jnp.asarray(w), tile))


def test_padding_interleaves_real_rows():
    """With cap < bk the kept slots are re-sorted by row id with the padding
    slots, so -1 sentinels sit between real rows — in both packages."""
    w = _sparse((256, 256), 0.3, "float32", seed=3)
    tp = formats.pack_tiled_csc(to_torch(w, "cpu"))
    assert tp.cap < 128
    col = tp.rows[0, 0, :, 0].tolist()
    first_real = next(i for i, r in enumerate(col) if r >= 0)
    assert -1 in col[first_real:], col
    _assert_packed_equal(tp, jformats.pack_tiled_csc(jnp.asarray(w)))


@pytest.mark.parametrize("cap", [8, 136])
def test_pack_explicit_cap_equal(cap):
    """Lossy (cap < nnz: largest magnitudes kept) and degenerate (cap > bk)
    explicit capacities."""
    w = _sparse((256, 128), 0.5, "float32", seed=11)
    jp = jformats.pack_tiled_csc(jnp.asarray(w), cap=cap)
    tp = formats.pack_tiled_csc(to_torch(w, "cpu"), cap=cap)
    _assert_packed_equal(tp, jp)
    np.testing.assert_array_equal(_np(tp.to_dense()), np.asarray(jp.to_dense()))


def test_tiled_csc_from_numpy_roundtrip():
    w = _sparse((300, 260), 0.2, "bfloat16", seed=5)
    jp = jformats.pack_tiled_csc(jnp.asarray(w))
    tp = tiled_csc_from_numpy(np.asarray(jp.vals), np.asarray(jp.rows),
                              jp.shape, jp.tile, device="cpu")
    assert tp.dtype == torch.bfloat16 and tp.rows.dtype == torch.int8
    np.testing.assert_array_equal(_np(tp.to_dense()), w.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("density", [0.1, 0.3, 0.7])
def test_magnitude_prune_equal(dtype, density):
    w = np.random.default_rng(1).standard_normal((192, 160)).astype(np.float32)
    w = w.astype(DTYPES[dtype][1])
    jw = np.asarray(jpruning.magnitude_prune(jnp.asarray(w), density))
    tw = pruning.magnitude_prune(to_torch(w, "cpu"), density)
    np.testing.assert_array_equal(_np(tw), jw.astype(np.float32))


def test_magnitude_prune_keeps_ties_as_reference():
    """bf16 weights drawn from 8 magnitudes: the k-th largest value is tied
    many times over, and every tied entry stays — more than k survive."""
    rng = np.random.default_rng(2)
    w = (rng.choice([-4, -2, -1, -0.5, 0.5, 1, 2, 4], size=(128, 96))
         * rng.choice([1.0, 0.25], size=(128, 96))).astype(ml_dtypes.bfloat16)
    density = 0.3
    jw = np.asarray(jpruning.magnitude_prune(jnp.asarray(w), density))
    tw = _np(pruning.magnitude_prune(to_torch(w, "cpu"), density))
    np.testing.assert_array_equal(tw, jw.astype(np.float32))
    assert np.count_nonzero(tw) > round(w.size * density)


def test_pack_param_equal():
    """pack_param prunes then packs like the reference's, and leaves small
    matrices and dense configs alone."""
    from repro.core import sod as jsod
    from repro_torch.core import sod

    w = np.random.default_rng(3).standard_normal((256, 192)).astype(np.float32)
    jcfg = jsod.SoDConfig(mode="tiled_csc", density=0.3, min_dim=64)
    tcfg = sod.SoDConfig(mode="tiled_csc", density=0.3, min_dim=64)
    _assert_packed_equal(sod.pack_param(to_torch(w, "cpu"), tcfg),
                         jsod.pack_param(jnp.asarray(w), jcfg))
    small = to_torch(w[:48], "cpu")
    assert sod.pack_param(small, tcfg) is small
    assert sod.pack_param(small, sod.DENSE) is small
