"""The port's paged attention, per-row decode positions and the paged model
steps against the JAX package's, in float32; inside the port, paged decode
against dense decode bit for bit; and the matmul kernels' launch plans,
whose K splits must not depend on the row count.

Weights come from the JAX initialisers and are carried across with
``repro_torch.interop``; caches, pools and inputs are seeded with numpy.
Tolerance: atol 1e-4 / rtol 1e-4 (as ``tests/test_torch_model.py``) — both
sides compute in float32 and differ only in the order of their sums.  The
port updates caches and pools in place, so every call gets its own clone.

Pool layout: the JAX package stacks (G, P, n_pages, page, KV, hd) — layer
groups × pattern period — and the port (L, n_pages, page, KV, hd); layer l is
(l // P, l % P), so a reshape converts one into the other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.models.model import LM as JLM
from repro_torch import configs
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import block_matmul as bmm
from repro_torch.kernels import sod_matmul as sm
from repro_torch.models import attention as attn
from repro_torch.models import transformer

ATOL = RTOL = 1e-4
B, PAGE, N_LOGICAL = 3, 4, 4                 # 16 cache positions a row


def _cfgs():
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(
        dtype="float32")
    tcfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        dtype="float32")
    return jcfg, tcfg


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return to_torch(np.asarray(a), "cpu")


@pytest.fixture(scope="module")
def layer():
    """One attention layer's weights from the JAX initialiser, both sides."""
    jcfg, tcfg = _cfgs()
    jspec = jtransformer.attn_spec(jcfg)
    jp = jattn.init_attention(jax.random.PRNGKey(0), jcfg.d_model, jspec,
                              jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    return jcfg, jspec, jp, transformer.attn_spec(tcfg), tp


def _pool(rng, spec, n_pages):
    shape = (n_pages, PAGE, spec.n_kv_heads, spec.head_dim)
    return {"k": _normal(rng, shape), "v": _normal(rng, shape)}


def _clone(tree):
    return {k: _t(v).clone() for k, v in tree.items()}


TABLES = np.asarray([[3, 5, 1, 7], [6, 2, 4, 8], [9, 11, 10, 12]], np.int32)


# ---------------------------------------------------------------------------
# against the JAX package (fp32)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 5])
def test_vector_pos_decode_attention_matches_jax(layer, window):
    jcfg, jspec, jp, tspec, tp = layer
    rng = np.random.default_rng(0)
    shape = (B, PAGE * N_LOGICAL, jspec.n_kv_heads, jspec.head_dim)
    cache = {"k": _normal(rng, shape), "v": _normal(rng, shape)}
    x = _normal(rng, (B, 1, jcfg.d_model))
    pos = np.asarray([2, 7, 13], np.int32)
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    jo, jc = jattn.decode_attention(jp, jnp.asarray(x), jc,
                                    jnp.asarray(pos), jspec, window=window)
    tc = _clone(cache)
    to, tc = attn.decode_attention(tp, _t(x), tc, _t(pos).long(), tspec, window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_valid", [False, True])
def test_paged_decode_attention_matches_jax(layer, with_valid):
    jcfg, jspec, jp, tspec, tp = layer
    rng = np.random.default_rng(1)
    pool = _pool(rng, jspec, 13)
    x = _normal(rng, (B, 1, jcfg.d_model))
    pos = np.asarray([5, 9, 14], np.int32)
    valid = np.asarray([6, 0, 15], np.int32) if with_valid else None
    jo, jpool = jattn.paged_decode_attention(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(TABLES), jnp.asarray(pos), jspec,
        valid_len=None if valid is None else jnp.asarray(valid))
    to, tpool = attn.paged_decode_attention(
        tp, _t(x), _clone(pool), _t(TABLES).long(), _t(pos).long(), tspec,
        valid_len=None if valid is None else _t(valid).long())
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        # page 0 (trash) takes the cut-off rows' writes, in an order neither
        # side fixes when two rows land on one slot; every live page agrees
        np.testing.assert_allclose(tpool[name].numpy()[1:],
                                   np.asarray(jpool[name])[1:], atol=ATOL, rtol=RTOL)
    if with_valid:   # row 1 (cutoff 0) wrote to the trash page, not its page
        np.testing.assert_array_equal(tpool["k"].numpy()[TABLES[1, 9 // PAGE]],
                                      pool["k"][TABLES[1, 9 // PAGE]])


@pytest.mark.parametrize("start,valid_len", [(0, 16), (4, 7), (8, 10)])
def test_paged_prefill_attention_matches_jax(layer, start, valid_len):
    jcfg, jspec, jp, tspec, tp = layer
    rng = np.random.default_rng(2)
    pool = _pool(rng, jspec, 13)
    c = 4
    x = _normal(rng, (1, c, jcfg.d_model))
    tables = TABLES[:1]
    jo, jpool = jattn.paged_prefill_attention(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(tables), jnp.asarray(start), jnp.asarray(valid_len), jspec)
    to, tpool = attn.paged_prefill_attention(
        tp, _t(x), _clone(pool), _t(tables).long(), start, valid_len, tspec)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy()[1:],
                                   np.asarray(jpool[name])[1:], atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def model():
    """The reduced llama from the JAX initialiser, both sides."""
    jcfg, tcfg = _cfgs()
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, params_from_numpy(np_params, tcfg, device="cpu")


def _model_pool(rng, tcfg, n_pages):
    shape = (tcfg.n_layers, n_pages, PAGE, tcfg.n_kv_heads, tcfg.head_dim)
    return {"k": _normal(rng, shape), "v": _normal(rng, shape)}


def _jax_pool(pool, jcfg):
    """(L, ...) → the JAX package's (G, P, ...)."""
    g, p = jcfg.n_layers // jcfg.pattern_period, jcfg.pattern_period
    return {k: jnp.asarray(v.reshape(g, p, *v.shape[1:])) for k, v in pool.items()}


def _from_jax_pool(pool):
    return {k: np.asarray(v).reshape(-1, *v.shape[2:]) for k, v in pool.items()}


def test_transformer_decode_paged_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(3)
    pool = _model_pool(rng, tcfg, 13)
    tokens = rng.integers(0, tcfg.vocab, (B, 1)).astype(np.int32)
    pos = np.asarray([3, 10, 15], np.int32)
    valid = np.asarray([4, 11, 0], np.int32)
    jl, jpool = jtransformer.transformer_decode_paged(
        jparams, _jax_pool(pool, jcfg), jnp.asarray(TABLES), jnp.asarray(tokens),
        jnp.asarray(pos), jcfg, valid_len=jnp.asarray(valid))
    tl, tpool = transformer.transformer_decode_paged(
        tparams, _clone(pool), _t(TABLES).long(), _t(tokens).long(),
        _t(pos).long(), tcfg, valid_len=_t(valid).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    jpool = _from_jax_pool(jpool)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy()[:, 1:], jpool[name][:, 1:],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("start,valid_len", [(0, 6), (4, 7)])
def test_transformer_prefill_chunk_matches_jax(model, start, valid_len):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(4)
    pool = _model_pool(rng, tcfg, 13)
    tokens = rng.integers(0, tcfg.vocab, (1, 4)).astype(np.int32)
    tables = TABLES[1:2]
    jl, jpool = jtransformer.transformer_prefill_chunk(
        jparams, _jax_pool(pool, jcfg), jnp.asarray(tables), jnp.asarray(tokens),
        jnp.asarray(start), jnp.asarray(valid_len), jcfg)
    tl, tpool = transformer.transformer_prefill_chunk(
        tparams, _clone(pool), _t(tables).long(), _t(tokens).long(), start,
        valid_len, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    jpool = _from_jax_pool(jpool)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy()[:, 1:], jpool[name][:, 1:],
                                   atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# inside the port, bit for bit
# ---------------------------------------------------------------------------
def _dense_and_paged(rng, spec):
    """A dense (B, S, KV, hd) cache and a pool holding the same rows at the
    scrambled page ids of TABLES."""
    shape = (B, PAGE * N_LOGICAL, spec.n_kv_heads, spec.head_dim)
    cache = {"k": _normal(rng, shape), "v": _normal(rng, shape)}
    pool = {k: np.zeros((13, PAGE) + shape[2:], np.float32) for k in cache}
    for row in range(B):
        for j in range(N_LOGICAL):
            for name in ("k", "v"):
                pool[name][TABLES[row, j]] = cache[name][row, j * PAGE:(j + 1) * PAGE]
    return cache, pool


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 5])
def test_paged_decode_equals_dense_decode(layer, dtype, window):
    """With pages holding the dense cache's contents, paged decode is
    bit-equal to dense vector-``pos`` decode, and the written slot lands in
    the right page."""
    _, _, _, spec, tp = layer
    tp = {k: v.to(dtype) for k, v in tp.items()}
    rng = np.random.default_rng(5)
    cache, pool = _dense_and_paged(rng, spec)
    x = _t(_normal(rng, (B, 1, tp["wq"].shape[0]))).to(dtype)
    pos = torch.tensor([5, 9, 14])
    tc = {k: v.to(dtype) for k, v in _clone(cache).items()}
    tpool = {k: v.to(dtype) for k, v in _clone(pool).items()}
    od, tc = attn.decode_attention(tp, x, tc, pos, spec, window=window)
    op, tpool = attn.paged_decode_attention(tp, x, tpool, _t(TABLES).long(), pos,
                                            spec, window=window)
    assert torch.equal(od, op)
    for row, p in enumerate(pos.tolist()):
        assert torch.equal(tpool["k"][TABLES[row, p // PAGE], p % PAGE], tc["k"][row, p])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_pos_equals_scalar(layer, dtype):
    """A (B,) ``pos`` of equal entries gives the scalar path's output and
    cache, bit for bit."""
    _, _, _, spec, tp = layer
    tp = {k: v.to(dtype) for k, v in tp.items()}
    rng = np.random.default_rng(6)
    cache, _ = _dense_and_paged(rng, spec)
    x = _t(_normal(rng, (B, 1, tp["wq"].shape[0]))).to(dtype)
    c1 = {k: v.to(dtype) for k, v in _clone(cache).items()}
    c2 = {k: v.to(dtype) for k, v in _clone(cache).items()}
    os_, c1 = attn.decode_attention(tp, x, c1, 6, spec)
    ov, c2 = attn.decode_attention(tp, x, c2, torch.full((B,), 6), spec)
    assert torch.equal(os_, ov)
    for name in ("k", "v"):
        assert torch.equal(c1[name], c2[name])


# ---------------------------------------------------------------------------
# launch plans: K splits independent of the row count (the CPU half of the
# kernels' row invariance; tests/test_torch_cuda.py holds the card's half)
# ---------------------------------------------------------------------------
PATH_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
ROWS = (1, 4, 16, 32, 40, 64, 128)


@pytest.mark.parametrize("act_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kn", PATH_SHAPES)
def test_sod_matmul_splits_do_not_depend_on_m(kn, act_dtype):
    kt, nt = kn[0] // 128, kn[1] // 128
    xb = act_dtype.itemsize
    for vb in sorted({xb, 1}):
        for cap in (24, 48, 56, 72, 128):
            splits = {m: sm.plan_launch(m, kt, nt, cap, (128, 128), vb, xb, 132).splits
                      for m in ROWS}
            assert len(set(splits.values())) == 1, (cap, vb, splits)


@pytest.mark.parametrize("act_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kn", PATH_SHAPES)
def test_block_matmul_splits_do_not_depend_on_m(kn, act_dtype):
    kt, nt = kn[0] // 128, kn[1] // 128
    xb = act_dtype.itemsize
    for vb in sorted({xb, 1}):
        for bcap in (4, 8, 12, 16):
            plans = {m: bmm.plan_launch(m, kt, nt, bcap, 8, (128, 128), vb, xb, 132)
                     for m in ROWS}
            assert len({p.splits for p in plans.values()}) == 1, (bcap, vb, plans)
            assert {p.m_groups for p in plans.values()} != {1}   # groups do vary
