"""The port's block_csr path against the JAX package's, on the CPU: block
pruning, BlockCSR packing, the block matmul (plain version, held against the
Pallas kernel in interpret mode and the jnp oracle) and the reduced llama
served with ``--sod block_csr``.  The CUDA kernel itself is held against its
plain version in tests/test_torch_cuda.py.

Tolerances: pruning masks and packed buffers are compared exactly.  Matmuls
and logits: atol 5e-4 / rtol 1e-4 for one matmul (the bound the JAX
package's kernel tests use, tests/test_kernels.py) and atol = rtol = 1e-4
for a served model's logits (tests/test_torch_model.py): float32 on both
sides, sums in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import formats as jformats
from repro.core import pruning as jpruning
from repro.core import sod as jsod
from repro.data.pipeline import SyntheticLMData as JData
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models.model import LM as JLM
from repro_torch import configs
from repro_torch.core import formats, pruning, sod
from repro_torch.interop import block_csr_from_numpy, params_from_numpy, to_torch
from repro_torch.kernels import block_matmul as bm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sod_matmul as sm
from repro_torch.launch import serve, steps
from repro_torch.models.model import LM

ATOL, RTOL = 5e-4, 1e-4
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _dense(shape, dtype="float32", seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return w.astype(DTYPES[dtype])


def _block_sparse(shape, density, dtype="float32", seed=0, block=(8, 128)):
    """A weight block-pruned by the JAX package (so both sides pack the same
    matrix)."""
    w = _dense(shape, dtype, seed)
    return np.asarray(jpruning.block_prune(jnp.asarray(w), density, block))


def _assert_packed_equal(tp, jp):
    assert tp.shape == tuple(jp.shape) and tp.tile == tuple(jp.tile)
    assert tp.br == jp.br and tp.bcap == jp.bcap
    assert tp.block_ids.dtype == tp.tile_nnz.dtype == torch.int32
    np.testing.assert_array_equal(tp.block_ids.numpy(), np.asarray(jp.block_ids))
    np.testing.assert_array_equal(tp.tile_nnz.numpy(), np.asarray(jp.tile_nnz))
    np.testing.assert_array_equal(_np(tp.block_vals),
                                  np.asarray(jp.block_vals).astype(np.float32))


def _carry(jp):
    return block_csr_from_numpy(np.asarray(jp.block_vals), np.asarray(jp.block_ids),
                                np.asarray(jp.tile_nnz), jp.shape, jp.tile, jp.br,
                                device="cpu")


# ---------------------------------------------------------------------------
# pruning and packing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("density", [0.05, 0.3, 0.7])
@pytest.mark.parametrize("shape,block", [((384, 256), (8, 128)),
                                         ((300, 260), (8, 128)),
                                         ((256, 192), (16, 64))])
def test_block_prune_masks_equal(shape, block, density, dtype):
    w = _dense(shape, dtype, seed=int(density * 100) + shape[0])
    jw = np.asarray(jpruning.block_prune(jnp.asarray(w), density, block))
    tw = pruning.block_prune(to_torch(w, "cpu"), density, block)
    assert tw.shape == shape and tw.dtype == to_torch(w, "cpu").dtype
    np.testing.assert_array_equal(_np(tw) != 0, jw.astype(np.float32) != 0)
    np.testing.assert_array_equal(_np(tw), jw.astype(np.float32))


@pytest.mark.parametrize("shape,tile,br,density,dtype", [
    ((384, 256), (128, 128), 8, 0.3, "float32"),
    ((384, 256), (128, 128), 8, 0.05, "bfloat16"),
    ((384, 256), (128, 128), 8, 1.0, "float32"),       # every sub-block stored
    ((300, 260), (128, 128), 8, 0.3, "float32"),       # not tile multiples
    ((300, 260), (128, 128), 8, 0.3, "bfloat16"),
    ((200, 130), (64, 128), 16, 0.4, "float32"),
    ((2, 3, 192, 136), (128, 128), 8, 0.3, "float32"),  # stacked: one shared bcap
    ((4, 256, 384), (128, 128), 8, 0.2, "bfloat16"),
])
def test_pack_block_csr_equal(shape, tile, br, density, dtype):
    dense = _dense(shape, dtype, seed=len(shape) * 7 + int(density * 10))
    flat = dense.reshape((-1,) + shape[-2:])
    w = np.stack([np.asarray(jpruning.block_prune(jnp.asarray(m), density,
                                                  (br, tile[1])))
                  for m in flat]).reshape(shape)
    jp = jformats.pack_block_csr(jnp.asarray(w), tile=tile, br=br)
    tp = formats.pack_block_csr(to_torch(w, "cpu"), tile=tile, br=br)
    _assert_packed_equal(tp, jp)
    assert tp.lead == tuple(shape[:-2])
    np.testing.assert_array_equal(_np(tp.to_dense()), w.astype(np.float32))
    np.testing.assert_array_equal(_np(tp.to_dense()),
                                  np.asarray(jp.to_dense()).astype(np.float32))
    assert tp.nbytes_compressed() == jp.nbytes_compressed()
    assert tp.nbytes_dense() == jp.nbytes_dense()
    assert (formats.observed_block_cap(to_torch(w, "cpu"), tile, br)
            == jformats.observed_block_cap(jnp.asarray(w), tile, br))
    if tp.lead:   # each layer's slice is the stack's slice
        first = tp.layer(0)
        while first.lead:
            first = first.layer(0)
        np.testing.assert_array_equal(
            _np(first.to_dense()), w.reshape(flat.shape)[0].astype(np.float32))


@pytest.mark.parametrize("bcap", [1, 3, 16, 40])
def test_pack_explicit_bcap_equal(bcap):
    """Truncating (largest-L2 sub-blocks kept, tile_nnz clamped to what is
    stored), exact and over-sized explicit capacities."""
    w = _block_sparse((384, 256), 0.5, seed=11)
    jp = jformats.pack_block_csr(jnp.asarray(w), bcap=bcap)
    tp = formats.pack_block_csr(to_torch(w, "cpu"), bcap=bcap)
    _assert_packed_equal(tp, jp)
    assert int(tp.tile_nnz.max()) <= tp.bcap
    np.testing.assert_array_equal(_np(tp.to_dense()), np.asarray(jp.to_dense()))


@pytest.mark.parametrize("case", ["lossless", "truncating", "stacked",
                                  "magnitude"])
def test_valid_first_invariant(case):
    """The stored sub-blocks come first, in ascending id order: ids are >= 0
    exactly at slots s < tile_nnz, in both packages' packs.  The CUDA kernel
    walks only those slots."""
    if case == "magnitude":    # scattered survivors: almost every sub-block
        w = np.asarray(jpruning.magnitude_prune(jnp.asarray(_dense((384, 256))), 0.02))
    elif case == "stacked":
        w = np.stack([_block_sparse((256, 384), 0.3, seed=s) for s in range(3)])
    else:
        w = _block_sparse((384, 256), 0.4, seed=3)
    bcap = 2 if case == "truncating" else None
    jp = jformats.pack_block_csr(jnp.asarray(w), bcap=bcap)
    tp = formats.pack_block_csr(to_torch(w, "cpu"), bcap=bcap)
    for ids, nnz in ((np.asarray(jp.block_ids), np.asarray(jp.tile_nnz)),
                     (tp.block_ids.numpy(), tp.tile_nnz.numpy())):
        slot = np.arange(ids.shape[-1])
        np.testing.assert_array_equal(ids >= 0, slot < nnz[..., None])
        both_stored = (ids[..., 1:] >= 0) & (ids[..., :-1] >= 0)
        assert (np.diff(ids, axis=-1)[both_stored] > 0).all()   # ascending


def test_block_csr_from_numpy_roundtrip():
    w = _block_sparse((300, 260), 0.3, "bfloat16", seed=5)
    tp = _carry(jformats.pack_block_csr(jnp.asarray(w)))
    assert tp.dtype == torch.bfloat16
    assert tp.block_ids.dtype == tp.tile_nnz.dtype == torch.int32
    np.testing.assert_array_equal(_np(tp.to_dense()), w.astype(np.float32))


# ---------------------------------------------------------------------------
# the block matmul (plain version on the CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("kn,m,density,tile,br", [
    ((384, 256), 96, 0.05, (128, 128), 8),
    ((384, 256), 4, 0.3, (128, 128), 8),
    ((384, 256), 32, 0.7, (128, 128), 8),
    ((300, 260), 77, 0.3, (128, 128), 8),
    ((200, 130), 33, 0.4, (64, 128), 16),
])
def test_block_matmul_matches_reference(kn, m, density, tile, br, impl):
    w = _block_sparse(kn, density, seed=m, block=(br, tile[1]))
    x = np.random.default_rng(m + 1).standard_normal((m, kn[0])).astype(np.float32)
    jp = jformats.pack_block_csr(jnp.asarray(w), tile=tile, br=br)
    yj = np.asarray(jops.sod_matmul(jnp.asarray(x), jp, impl=impl))
    yt = ops.sod_matmul(to_torch(x, "cpu"), _carry(jp))
    assert yt.shape == (m, kn[1]) and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, atol=ATOL, rtol=RTOL)


def test_block_matmul_skips_zero_tiles():
    """The lower half of the macro tiles is zero: tile_nnz is 0 there, and
    the product still equals x @ w (the full-size case runs on the card)."""
    w = _block_sparse((256, 256), 0.5, seed=4).copy()
    w[128:] = 0
    p = formats.pack_block_csr(to_torch(w, "cpu"))
    assert int(p.tile_nnz[1].count_nonzero()) == 0
    x = np.random.default_rng(4).standard_normal((32, 256)).astype(np.float32)
    y = bm.block_matmul(to_torch(x, "cpu"), p)
    np.testing.assert_allclose(y.numpy(), x @ w, atol=ATOL, rtol=RTOL)
    yj = jops.sod_matmul(jnp.asarray(x), jformats.pack_block_csr(jnp.asarray(w)),
                         impl="pallas")
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=ATOL, rtol=RTOL)


def test_block_matmul_nd_batch_and_out_dtype():
    w = _block_sparse((300, 260), 0.3, seed=6)
    x = np.random.default_rng(7).standard_normal((2, 5, 300)).astype(np.float32)
    p = formats.pack_block_csr(to_torch(w, "cpu"))
    y = ops.sod_matmul(to_torch(x, "cpu"), p)
    assert y.shape == (2, 5, 260)
    np.testing.assert_allclose(y.numpy(), x @ w, atol=ATOL, rtol=RTOL)
    yb = ops.sod_matmul(to_torch(x, "cpu"), p, out_dtype=torch.bfloat16)
    assert yb.dtype == torch.bfloat16
    np.testing.assert_allclose(yb.float().numpy(), x @ w, rtol=2**-7, atol=1e-2)


def test_wrapper_rejects_bad_inputs():
    w = _block_sparse((256, 256), 0.3, seed=7)
    p = formats.pack_block_csr(to_torch(w, "cpu"))
    x = torch.zeros(8, 256)
    with pytest.raises(ValueError):          # wrong K
        bm.block_matmul(torch.zeros(8, 200), p)
    with pytest.raises(TypeError):           # weight dtype != activation dtype
        bm.block_matmul(x.bfloat16(), p)
    with pytest.raises(ValueError):          # non-contiguous activations
        bm.block_matmul(torch.zeros(256, 8).T, p)
    with pytest.raises(TypeError):           # ids not int32
        bm.block_matmul(x, dataclasses.replace(p, block_ids=p.block_ids.long()))
    stacked = formats.pack_block_csr(torch.stack([to_torch(w, "cpu")] * 2))
    with pytest.raises(ValueError):          # stacked operand
        bm.block_matmul(x, stacked)
    with pytest.raises(ValueError, match="unknown qmode"):
        bm.block_matmul(x, dataclasses.replace(p, qmode="int4"))
    with pytest.raises(TypeError):           # int8 qmode over float values
        bm.block_matmul(x, dataclasses.replace(p, qmode="int8"))
    q = formats.quantize_packed(p, "fp8")    # a quantized operand runs
    assert bm.block_matmul(x, q).shape == (8, 256)


@pytest.mark.parametrize("kt,nt,m", [(16, 16, 4), (16, 4, 4), (64, 16, 4),
                                     (16, 64, 128), (3, 1, 77)])
def test_split_target_leaves_no_split_empty(kt, nt, m):
    """The block kernel's split-K target: about CTAS_PER_SM CTAs per SM of
    an H100 (132 SMs), never an empty split."""
    ctas = nt * -(-m // sm.m_block(m))
    s = sm.pick_splits(kt, ctas, 132, bm.CTAS_PER_SM)
    per = -(-kt // s)
    assert 1 <= s <= kt and (s - 1) * per < kt
    assert s <= max(1, -(-bm.CTAS_PER_SM * 132 // ctas))   # no more than asked


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    w = _block_sparse((256, 256), 0.3, seed=8)
    x = to_torch(np.random.default_rng(8).standard_normal((8, 256)).astype(np.float32),
                 "cpu")
    p = formats.pack_block_csr(to_torch(w, "cpu"))
    before = bm.launches
    y = bm.block_matmul(x, p)
    assert bm.launches == before
    assert torch.equal(y, ref.block_matmul_ref(x, p))


# ---------------------------------------------------------------------------
# config and the served model
# ---------------------------------------------------------------------------
def test_sod_config_methods():
    cfg = sod.SoDConfig(mode="block_csr", density=0.3, prune_method="block")
    ref_cfg = jsod.SoDConfig(mode="block_csr")
    assert (cfg.br, cfg.tile, cfg.min_dim) == (ref_cfg.br, ref_cfg.tile,
                                              ref_cfg.min_dim)
    assert sod.SoDConfig().prune_method == ref_cfg.prune_method == "magnitude"
    assert sod.SoDConfig(mode="block_csr", prune_method="nm").prune_method == "nm"
    with pytest.raises(ValueError):
        sod.SoDConfig(mode="block_csr", prune_method="random")


@pytest.mark.parametrize("mode,method", [("block_csr", "block"),
                                         ("block_csr", "magnitude"),
                                         ("tiled_csc", "block")])
def test_pack_param_equal(mode, method):
    w = _dense((256, 384), seed=9)
    kw = dict(mode=mode, density=0.3, prune_method=method, min_dim=64)
    tp = sod.pack_param(to_torch(w, "cpu"), sod.SoDConfig(**kw))
    jp = jsod.pack_param(jnp.asarray(w), jsod.SoDConfig(**kw))
    assert type(tp).__name__ == type(jp).__name__
    np.testing.assert_array_equal(_np(tp.to_dense()), np.asarray(jp.to_dense()))


B, S, GEN = 2, 16, 8
SERVE_TOL = 1e-4


@pytest.fixture(scope="module", params=["block", "magnitude"])
def served(request):
    """Both packages' prefill + GEN greedy decode steps of the reduced llama
    in float32 with block_csr weights, on the same weights and tokens."""
    kw = dict(mode="block_csr", density=0.3, prune_method=request.param,
              min_dim=64)
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(
        dtype="float32", sod=jsod.SoDConfig(**kw))
    tcfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        dtype="float32", sod=sod.SoDConfig(**kw))
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.asarray(JData(jcfg, B, S, seed=0).batch(0)["tokens"])

    jmodel = JLM(jcfg)
    jp = jsod.sodify_params(jparams, jcfg.sod)
    last, cache, pos0 = jserve.prefill_cache(
        jmodel, jp, {"tokens": jnp.asarray(tokens)}, S + GEN)
    jout = {"prefill": np.asarray(last), "logits": [], "tokens": []}
    decode = jax.jit(jsteps.make_decode_step(jmodel))
    tok = jnp.argmax(last, axis=-1).reshape(B, 1)
    for t in range(GEN):
        nxt, logits, cache = decode(jp, cache, tok, jnp.asarray(pos0 + t, jnp.int32))
        tok = nxt.reshape(B, 1)
        jout["logits"].append(np.asarray(logits))
        jout["tokens"].append(np.asarray(nxt))

    tmodel = LM(tcfg)
    tp = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"),
                           tcfg.sod)
    with torch.inference_mode():
        last, cache, pos0 = serve.prefill_cache(
            tmodel, tp, to_torch(tokens, "cpu").long(), S + GEN)
        tout = {"prefill": last.numpy(), "logits": [], "tokens": []}
        decode = steps.make_decode_step(tmodel)
        tok = last.argmax(dim=-1).reshape(B, 1)
        for t in range(GEN):
            nxt, logits, cache = decode(tp, cache, tok, pos0 + t)
            tok = nxt.reshape(B, 1)
            tout["logits"].append(logits.numpy())
            tout["tokens"].append(nxt.numpy())
    return {"jax": jout, "torch": tout, "jparams": jp, "tparams": tp}


def test_served_logits_match(served):
    j, t = served["jax"], served["torch"]
    np.testing.assert_allclose(t["prefill"], j["prefill"], atol=SERVE_TOL,
                               rtol=SERVE_TOL)
    for lt, lj in zip(t["logits"], j["logits"]):
        np.testing.assert_allclose(lt, lj, atol=SERVE_TOL, rtol=SERVE_TOL)


def test_served_greedy_tokens_equal(served):
    tt = np.stack(served["torch"]["tokens"]).reshape(GEN, B)
    tj = np.stack(served["jax"]["tokens"]).reshape(GEN, B)
    np.testing.assert_array_equal(tt, tj)


def test_served_packs_and_bytes_equal(served):
    jp, tp = served["jparams"], served["tparams"]
    names = [("attn", n) for n in ("wq", "wk", "wv", "wo")] + \
        [("mlp", n) for n in ("w_gate", "w_up", "w_down")]
    for i, layer in enumerate(tp["layers"]):
        for group, name in names:
            tw, jw = layer[group][name], jp["blocks"][group][name]
            assert isinstance(tw, formats.BlockCSR) and tw.lead == ()
            assert tw.bcap == jw.bcap
            for field in ("block_vals", "block_ids", "tile_nnz"):
                np.testing.assert_array_equal(getattr(tw, field).numpy(),
                                              np.asarray(getattr(jw, field))[i, 0])
    tb, jb = sod.tree_weight_bytes(tp), jsod.tree_weight_bytes(jp)
    assert tb == jb                     # compressed, dense and their ratio


def test_cli_block_csr_on_cpu(capsys):
    summary = serve.main(["--reduced", "--sod", "block_csr", "--density", "0.3",
                          "--batch", "2", "--prompt-len", "8", "--gen", "2",
                          "--device", "cpu"])
    assert summary["logits_finite"] and len(summary["sample"]) == 2
    # no CUDA kernel runs on the CPU: the wrappers take the plain versions
    assert summary["kernel_launches"] == {"sod_matmul": 0, "block_matmul": 0}


def test_serve_takes_a_caller_config(monkeypatch):
    """``sod`` replaces the flags' config: block pruning reaches the packer,
    and every projection goes through the block wrapper (2 layers × 7
    projections × (prefill + 2 decode steps))."""
    calls = []
    plain = ref.block_matmul_ref

    def counting(*a, **kw):
        calls.append(a[1])
        return plain(*a, **kw)

    monkeypatch.setattr(ref, "block_matmul_ref", counting)
    cfg = sod.SoDConfig(mode="block_csr", density=0.3, prune_method="block",
                        min_dim=64)
    summary = serve.main(["--reduced", "--sod", "tiled_csc", "--batch", "2",
                          "--prompt-len", "8", "--gen", "2", "--device", "cpu"],
                         sod=cfg)
    assert len(calls) == 2 * 7 * 3
    assert all(isinstance(w, formats.BlockCSR) for w in calls)
    # block pruning at density 0.3 keeps ~30 % of the sub-blocks
    frac = sum(int(w.tile_nnz.sum()) for w in calls[:14]) / sum(
        w.tile_nnz.numel() * (w.tile[0] // w.br) for w in calls[:14])
    assert 0.25 <= frac <= 0.35
    wb = summary["weight_bytes"]
    assert 0 < wb["compressed"] < wb["dense"]
