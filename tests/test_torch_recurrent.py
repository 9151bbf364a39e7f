"""The recurrent blocks of the port against the JAX package.

``repro_torch.models.ssm`` (Mamba2: the causal conv, the chunked SSD
forward, the decode step) and ``repro_torch.models.xlstm`` (mLSTM, full and
decode; sLSTM) at the reduced configs' widths, in float32, with weights
from the reference's own init converted leaf by leaf.  Tolerances: atol /
rtol 1e-4 against the reference; the port's chunked forward against its
own stepped decode 1e-4 as well (the same sums in another order);
gradients through each block atol 1e-6 / rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro_torch import configs
from repro_torch.interop import to_torch
from repro_torch.models import ssm, transformer, xlstm
from repro_torch.models.cache import CacheAxes

ATOL = RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The blocks' CPU ops gain nothing from intra-op threads, and under the
    suite's parallel workers every worker's threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs():
    zj = jconfigs.reduced(jconfigs.get_config("zamba2-2.7b"))
    xj = jconfigs.reduced(jconfigs.get_config("xlstm-125m"))
    zt = configs.reduced(configs.get_config("zamba2-2.7b"))
    xt = configs.reduced(configs.get_config("xlstm-125m"))
    return (jtransformer.mamba_spec(zj), transformer.mamba_spec(zt),
            jtransformer.xlstm_spec(xj), transformer.xlstm_spec(xt))


JM, TM, JX, TX = _specs()


def _tree(params):
    """A JAX parameter tree as the port's float32 CPU tensors, and as numpy."""
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    return jax.tree_util.tree_map(lambda a: to_torch(a, "cpu"), np_tree), np_tree


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **{"atol": ATOL, "rtol": RTOL, **kw})


@pytest.fixture(scope="module")
def mamba_params():
    return _tree(jssm.init_mamba(jax.random.PRNGKey(1), JM, jnp.float32))


@pytest.fixture(scope="module")
def mlstm_params():
    return _tree(jxlstm.init_mlstm(jax.random.PRNGKey(2), JX, jnp.float32))


@pytest.fixture(scope="module")
def slstm_params():
    return _tree(jxlstm.init_slstm(jax.random.PRNGKey(3), JX, jnp.float32))


# ---------------------------------------------------------------------------
# specs, inits, cache axes
# ---------------------------------------------------------------------------
def test_specs_equal_the_references():
    assert dataclasses.asdict(TM) == dataclasses.asdict(JM)
    assert dataclasses.asdict(TX) == dataclasses.asdict(JX)
    for spec, ref in ((TM, JM), (TX, JX)):
        for prop in ("d_inner", "n_heads", "conv_dim", "head_dim"):
            if hasattr(ref, prop):
                assert getattr(spec, prop) == getattr(ref, prop), prop
    full = transformer.xlstm_spec(configs.get_config("xlstm-125m"))
    assert (full.d_inner, full.head_dim) == (1536, 384)   # not the config's 192


@pytest.mark.parametrize("what", ["mamba", "mlstm", "slstm"])
def test_init_shapes_and_dtypes_equal_the_references(what):
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cpu")
    if what == "mamba":
        got = ssm.init_mamba(gen, TM, torch.bfloat16, dev)
        want = jssm.init_mamba(jax.random.PRNGKey(0), JM, jnp.bfloat16)
    elif what == "mlstm":
        got = xlstm.init_mlstm(gen, TX, torch.bfloat16, dev)
        want = xlstm_init = jxlstm.init_mlstm(jax.random.PRNGKey(0), JX, jnp.bfloat16)
        np.testing.assert_array_equal(got["b_if"].numpy(), np.asarray(xlstm_init["b_if"]))
    else:
        got = xlstm.init_slstm(gen, TX, torch.bfloat16, dev)
        want = jxlstm.init_slstm(jax.random.PRNGKey(0), JX, jnp.bfloat16)
        np.testing.assert_array_equal(got["b_gates"].numpy(), np.asarray(want["b_gates"]))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    if what == "mamba":
        for k in ("a_log", "d_skip"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
        dt = torch.nn.functional.softplus(got["dt_bias"])
        assert bool(((dt > 9e-4) & (dt < 0.11)).all())


def test_cache_inits_and_axes_equal_the_references():
    dev = torch.device("cpu")
    pairs = [(ssm.init_mamba_cache(3, TM, torch.float32, dev),
              jssm.init_mamba_cache(3, JM, jnp.float32)),
             (xlstm.init_mlstm_cache(3, TX, torch.float32, dev),
              jxlstm.init_mlstm_cache(3, JX, jnp.float32)),
             (xlstm.init_slstm_cache(3, TX, dev), jxlstm.init_slstm_cache(3, JX))]
    for got, want in pairs:
        g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
        # torch tensors are leaves to jax's walk: one per array
        assert len(g) == len(w)
        for a, b in zip(sorted(g, key=lambda t: tuple(t.shape)),
                        sorted(w, key=lambda t: t.shape)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for got, want in ((ssm.mamba_cache_axes(), jssm.mamba_cache_axes()),
                      (xlstm.mlstm_cache_axes(), jxlstm.mlstm_cache_axes()),
                      (xlstm.slstm_cache_axes(), jxlstm.slstm_cache_axes())):
        flat = lambda t: [(a.batch, a.seq) for a in jax.tree_util.tree_leaves(t)]  # noqa: E731
        assert flat(got) == flat(want)
        assert all(isinstance(a, CacheAxes) for a in jax.tree_util.tree_leaves(got))


@pytest.mark.parametrize("x", [-60.0, -3.0, 0.0, 0.5, 19.0, 21.0, 40.0, 90.0])
def test_softplus_and_log_sigmoid_are_jaxs(x):
    """``logaddexp(x, 0)`` everywhere, where torch's ``F.softplus`` turns
    into the identity above 20."""
    t = torch.tensor([x], dtype=torch.float32)
    j = jnp.asarray([x], jnp.float32)
    np.testing.assert_array_equal(ssm.softplus(t).numpy(), np.asarray(jax.nn.softplus(j)))
    np.testing.assert_allclose(xlstm.log_sigmoid(t).numpy(),
                               np.asarray(jax.nn.log_sigmoid(j)), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    u, w, b = _rand(0, B, 7, 24), _rand(1, 4, 24, scale=0.3), _rand(2, 24, scale=0.1)
    st = _rand(3, B, 3, 24) if with_state else None
    (uj, ut), (wj, wt), (bj, bt) = _both(u), _both(w), _both(b)
    yj, sj = jssm._causal_conv(uj, wj, bj, None if st is None else jnp.asarray(st))
    yt, stt = ssm._causal_conv(ut, wt, bt, None if st is None else torch.from_numpy(st))
    _close(yt, yj)
    np.testing.assert_array_equal(stt.numpy(), np.asarray(sj))


@pytest.mark.parametrize("s", [16, 64])
def test_mamba_forward_matches(mamba_params, s):
    """One chunk shorter than the spec's (16 < 32) and two whole chunks."""
    tp, npp = mamba_params
    x = _rand(4, B, s, TM.d_model)
    want = jssm.mamba_forward(jax.tree_util.tree_map(jnp.asarray, npp), jnp.asarray(x), JM)
    _close(ssm.mamba_forward(tp, torch.from_numpy(x), TM), want)


def test_mamba_forward_rejects_a_ragged_chunk(mamba_params):
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ssm.mamba_forward(mamba_params[0], torch.zeros(1, 40, TM.d_model), TM)


def _mamba_state(seed, batch):
    w = TM.conv_width - 1
    return {"ssm": _rand(seed, batch, TM.n_heads, TM.d_state, TM.headdim, scale=0.5),
            "conv": {"x": _rand(seed + 1, batch, w, TM.d_inner),
                     "b": _rand(seed + 2, batch, w, TM.d_state),
                     "c": _rand(seed + 3, batch, w, TM.d_state)}}


def test_mamba_decode_step_matches(mamba_params):
    """Three steps from a non-zero state, the state carried in each package."""
    tp, npp = mamba_params
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    st = _mamba_state(10, B)
    jst = jax.tree_util.tree_map(jnp.asarray, st)
    tst = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), st)
    for t in range(3):
        x = _rand(20 + t, B, 1, TM.d_model)
        yj, jst = jssm.mamba_decode_step(jp, jnp.asarray(x), jst, JM)
        yt, tst = ssm.mamba_decode_step(tp, torch.from_numpy(x), tst, TM)
        _close(yt, yj)
        _close(tst["ssm"], jst["ssm"])
        for k in ("x", "b", "c"):
            _close(tst["conv"][k], jst["conv"][k])


def test_mamba_chunked_forward_equals_its_stepped_decode(mamba_params):
    """The port's chunked SSD over 64 positions (two chunks) against its own
    decode step run position by position from a zeroed state."""
    tp, _ = mamba_params
    x = torch.from_numpy(_rand(5, B, 64, TM.d_model))
    full = ssm.mamba_forward(tp, x, TM)
    state = ssm.init_mamba_cache(B, TM, torch.float32, torch.device("cpu"))
    steps = []
    for t in range(64):
        y, state = ssm.mamba_decode_step(tp, x[:, t:t + 1], state, TM)
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=ATOL,
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def test_mlstm_block_full_matches(mlstm_params):
    tp, npp = mlstm_params
    x = _rand(6, B, 64, TX.d_model)
    yj, cj = jxlstm.mlstm_block(jax.tree_util.tree_map(jnp.asarray, npp),
                                jnp.asarray(x), JX)
    yt, ct = xlstm.mlstm_block(tp, torch.from_numpy(x), TX)
    _close(yt, yj)
    assert ct is None and cj is None


def _mlstm_cache(seed):
    c = xlstm.init_mlstm_cache(B, TX, torch.float32, torch.device("cpu"))
    c = {k: v.numpy().copy() for k, v in c.items()}
    c["c"] = _rand(seed, *c["c"].shape, scale=0.1)
    c["n"] = _rand(seed + 1, *c["n"].shape, scale=0.1)
    c["m"] = _rand(seed + 2, *c["m"].shape)
    c["conv"] = _rand(seed + 3, *c["conv"].shape)
    return c


@pytest.mark.parametrize("fresh", [True, False])
def test_mlstm_block_decode_matches(mlstm_params, fresh):
    """Three decode steps from the zeroed cache (stabiliser -1e30) or a
    random one, the cache carried in each package."""
    tp, npp = mlstm_params
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    c = ({k: v.numpy() for k, v in xlstm.init_mlstm_cache(
        B, TX, torch.float32, torch.device("cpu")).items()} if fresh else _mlstm_cache(30))
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
    for t in range(3):
        x = _rand(40 + t, B, 1, TX.d_model)
        yj, jc = jxlstm.mlstm_block(jp, jnp.asarray(x), JX, cache=jc, decode=True)
        yt, tc = xlstm.mlstm_block(tp, torch.from_numpy(x), TX, cache=tc, decode=True)
        _close(yt, yj)
        for k in ("c", "n", "m", "conv"):
            _close(tc[k], jc[k], err_msg=k)


def test_mlstm_chunked_equals_its_stepped_decode(mlstm_params):
    """The port's chunked form over 64 positions (two chunks) against the
    chunk-1 form position by position: outputs and the final state."""
    q, k, v = (torch.from_numpy(_rand(50 + i, B, 64, TX.n_heads, TX.head_dim))
               for i in range(3))
    li = torch.from_numpy(_rand(53, B, 64, TX.n_heads))
    lf = xlstm.log_sigmoid(torch.from_numpy(_rand(54, B, 64, TX.n_heads)) + 3)
    y, (c, n, m) = xlstm.mlstm_chunked(q, k, v, li, lf, chunk=TX.chunk)
    state, ys = None, []
    for t in range(64):
        yt, state = xlstm.mlstm_chunked(q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                                        li[:, t:t + 1], lf[:, t:t + 1], 1, state)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(), atol=ATOL, rtol=RTOL)
    # the two forms keep the state at different stabilisers: compare C / e^-m
    for a, b in ((state[0] * torch.exp(state[2])[..., None, None],
                  c * torch.exp(m)[..., None, None]),
                 (state[1] * torch.exp(state[2])[..., None], n * torch.exp(m)[..., None])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-3)


def test_mlstm_chunked_rejects_a_ragged_chunk():
    q = torch.zeros(1, 40, TX.n_heads, TX.head_dim)
    li = torch.zeros(1, 40, TX.n_heads)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        xlstm.mlstm_chunked(q, q, q, li, li, chunk=32)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches(slstm_params, with_state):
    tp, npp = slstm_params
    x = _rand(60, B, 12, TX.d_model)
    hd = TX.d_model // TX.n_heads
    st = None
    if with_state:
        st = tuple(_rand(61 + i, B, TX.n_heads, hd) for i in range(4))
        st = (st[0], st[1], np.abs(st[2]) + 0.5, st[3])
    yj, sj = jxlstm.slstm_scan(jax.tree_util.tree_map(jnp.asarray, npp), jnp.asarray(x),
                               JX, None if st is None else tuple(map(jnp.asarray, st)))
    yt, stt = xlstm.slstm_scan(tp, torch.from_numpy(x), TX,
                               None if st is None else tuple(
                                   torch.from_numpy(np.array(a)) for a in st))
    _close(yt, yj)
    for a, b in zip(stt, sj, strict=True):
        _close(a, b)


# ---------------------------------------------------------------------------
# gradients through each block (autograd against jax.grad)
# ---------------------------------------------------------------------------
BLOCKS = {
    "mamba": (lambda p, x: jssm.mamba_forward(p, x, JM),
              lambda p, x: ssm.mamba_forward(p, x, TM), "mamba_params"),
    "mlstm": (lambda p, x: jxlstm.mlstm_block(p, x, JX)[0],
              lambda p, x: xlstm.mlstm_block(p, x, TX)[0], "mlstm_params"),
    "slstm": (lambda p, x: jxlstm.slstm_scan(p, x, JX)[0],
              lambda p, x: xlstm.slstm_scan(p, x, TX)[0], "slstm_params"),
}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_gradients_match(block, request):
    """d(0.01 · Σ y²) by every weight and by x, over 32 positions (one
    chunk): the port's autograd through the plain-torch scans against
    ``jax.grad`` of the reference."""
    jf, tf, fixture = BLOCKS[block]
    tp, npp = request.getfixturevalue(fixture)
    x = _rand(70, B, 32, TM.d_model)
    jgp, jgx = jax.jit(jax.grad(lambda p, x: jnp.sum(jf(p, x) ** 2) * 0.01,
                                argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, npp), jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ((tf(live, xt) ** 2).sum() * 0.01).backward()
    _close(xt.grad, jgx, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg="x")
    for k, v in live.items():
        _close(v.grad, jgp[k], atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)
