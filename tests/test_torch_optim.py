"""The port's AdamW, schedules and gradient compression against the JAX
package's (``repro.optim``), on the same parameters and gradients.

Parameters and gradients are made by the JAX side (packed leaves in every
qmode, their gradients from ``jax.grad`` of a loss over the packed tree)
and carried across as numpy.  Tolerance: atol 1e-6 / rtol 1e-5 on float32
state (the same formula; the port sums the global norm in another order
and takes the bias corrections in float64); fp8 and bf16 parameters within
one rounding of their dtype (rtol 2**-3, 2**-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import pruning as jpruning
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_schedule as jcosine
from repro.optim import grad as jgrad
from repro.optim.schedule import constant_schedule as jconstant
from repro_torch.core.formats import BlockCSR, TiledCSC, pack_tiled_csc
from repro_torch.core.tree import PACKED_FIELDS
from repro_torch.interop import to_torch
from repro_torch.optim import AdamW, AdamWConfig, constant_schedule, cosine_schedule
from repro_torch.optim import grad as G

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-6, 1e-5
PARAM_RTOL = {"float32": RTOL, "bfloat16": 2**-7, "float8_e4m3fn": 2**-3}


def _np(t):
    if t is None:
        return None
    return np.asarray(t.detach().float()) if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _carry_leaf(a):
    if a is None or getattr(a, "dtype", None) == jax.dtypes.float0:
        return None
    return to_torch(np.asarray(a), "cpu")


def _carry(tree):
    """A JAX params or grads tree ({name: array | TiledCSC | BlockCSR}) as the
    port's; float0 gradients become None."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, (jformats.TiledCSC, jformats.BlockCSR)):
            cls = TiledCSC if isinstance(v, jformats.TiledCSC) else BlockCSR
            # the layout fields both packages have (the port's ``shard``,
            # a rank's resident block, is not the reference's)
            static = {f.name: getattr(v, f.name) for f in dataclasses.fields(cls)
                      if f.name not in PACKED_FIELDS[cls] and hasattr(v, f.name)}
            out[name] = cls(**static, **{f: _carry_leaf(getattr(v, f))
                                         for f in PACKED_FIELDS[cls]})
        else:
            out[name] = _carry_leaf(v)
    return out


def _pairs(t, j):
    """(name, port leaf, reference leaf) over two trees of :func:`_carry`'s
    shape, matched by key and field name."""
    for k, jv in j.items():
        tv = t[k]
        if isinstance(tv, (TiledCSC, BlockCSR)):
            for f in PACKED_FIELDS[type(tv)]:
                yield f"{k}.{f}", getattr(tv, f), getattr(jv, f)
        else:
            yield k, tv, jv


def _jax_tree(qmode, fmt, dtype):
    """Params {"w": packed, "d": dense, "g": norm gain} and their grads from
    jax.grad of a loss that uses every leaf."""
    w = jpruning.random_sparse(jax.random.fold_in(KEY, 1), (256, 128), 0.3).astype(dtype)
    if fmt == "block_csr":
        w = jpruning.block_prune(w, 0.3, block=(8, 128))
        p = jformats.pack_block_csr(w, tile=(128, 128), br=8)
    else:
        p = jformats.pack_tiled_csc(w, tile=(128, 128))
    if qmode != "none":
        p = jformats.quantize_packed(p, qmode)
    params = {"w": p,
              "d": jax.random.normal(jax.random.fold_in(KEY, 2), (128, 64)).astype(dtype),
              "g": jnp.zeros((64,), jnp.float32)}
    x = jax.random.normal(jax.random.fold_in(KEY, 3), (8, 256))

    def loss(pr):
        h = x @ pr["w"].to_dense().astype(jnp.float32)
        h = h @ pr["d"].astype(jnp.float32)
        return jnp.sum((h * (1 + pr["g"])) ** 2) * 1e-3

    return params, jax.grad(loss, allow_int=True)


def _assert_tree_close(got, want, where):
    for name, a, b in _pairs(got, want):
        assert (a is None) == (b is None), f"{where}.{name}"
        if a is None:
            continue
        rtol = PARAM_RTOL.get(str(b.dtype), RTOL)
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=rtol,
                                   err_msg=f"{where}.{name}")


@pytest.mark.parametrize("fmt,qmode,dtype", [
    ("tiled_csc", q, "float32") for q in ("none", "int8", "fp8", "codebook")
] + [("block_csr", q, "float32") for q in ("none", "int8", "fp8", "codebook")]
  + [("tiled_csc", "none", "bfloat16")])
@pytest.mark.parametrize("clip", [1e9, 0.05])
def test_adamw_matches_reference(fmt, qmode, dtype, clip):
    """Three updates on dense and packed leaves (moments of the stored
    slots' shape), with and without the global-norm clip biting, under a
    cosine schedule."""
    jparams, jgrad_fn = _jax_tree(qmode, fmt, jnp.dtype(dtype))
    jopt = JAdamW(JAdamWConfig(lr=1e-2, grad_clip=clip), schedule=jcosine(1e-2, 2, 10))
    topt = AdamW(AdamWConfig(lr=1e-2, grad_clip=clip), schedule=cosine_schedule(1e-2, 2, 10))
    jstate, tparams = jopt.init(jparams), _carry(jparams)
    tstate = topt.init(tparams)
    for _ in range(3):
        jg = jgrad_fn(jparams)
        tg = _carry(jg)
        jparams, jstate, jm = jopt.update(jparams, jg, jstate)
        tparams, tstate, tm = topt.update(tparams, tg, tstate)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    _assert_tree_close(tparams, jparams, "params")
    for k in ("m", "v", "master"):
        _assert_tree_close(tstate[k], jstate[k], k)
    # compressed-sized moments; integer leaves pass through as they were
    packed = tparams["w"]
    vals = "vals" if fmt == "tiled_csc" else "block_vals"
    if getattr(packed, vals).is_floating_point():
        assert getattr(tstate["m"]["w"], vals).shape == getattr(packed, vals).shape


def test_grad_clip_scales_update():
    opt = AdamW(AdamWConfig(lr=1e-2, grad_clip=0.1, weight_decay=0.0))
    params = {"w": torch.zeros(4)}
    _, _, metrics = opt.update(params, {"w": torch.full((4,), 100.0)}, opt.init(params))
    assert float(metrics["grad_norm"]) == pytest.approx(200.0, rel=1e-3)


def test_packed_params_train_on_mask_only():
    """Fixed-mask sparse training, as ``tests/test_optim.py``: padding slots
    and integer rows never move, real values do, moments have the
    compressed footprint."""
    w = jpruning.random_sparse(KEY, (256, 128), 0.3)
    packed = pack_tiled_csc(to_torch(np.asarray(w), "cpu"))
    params = {"w": packed}
    opt = AdamW(AdamWConfig(lr=1e-2, weight_decay=0.0))
    state = opt.init(params)
    assert state["m"]["w"].vals.shape == packed.vals.shape
    vals = packed.vals.clone().requires_grad_(True)
    loss = (dataclasses.replace(packed, vals=vals).to_dense() ** 2).sum()
    (gv,) = torch.autograd.grad(loss, [vals])
    grads = {"w": dataclasses.replace(packed, vals=gv, rows=None)}
    p2, _, _ = opt.update(params, grads, state)
    assert torch.equal(p2["w"].rows, packed.rows)
    pad = packed.rows < 0
    assert (p2["w"].vals[pad] == 0).all()
    real = ~pad & (packed.vals != 0)
    assert (p2["w"].vals[real] != packed.vals[real]).any()


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 5), (3, 3)])
def test_cosine_schedule_matches_reference(warmup, total):
    ts, js = cosine_schedule(2e-3, warmup, total), jcosine(2e-3, warmup, total)
    for step in range(0, total + 3):
        assert float(ts(step)) == pytest.approx(float(js(step)), rel=1e-6, abs=1e-12)
    assert float(constant_schedule(0.5)(7)) == float(jconstant(0.5)(7))


def test_topk_matches_reference():
    """Distinct magnitudes (no ties): the same kept set, values and error."""
    g = np.asarray(jax.random.normal(KEY, (64, 32)), np.float32)
    jv, ji, je = jgrad.topk_compress(jnp.asarray(g), 0.25)
    tv, ti, te = G.topk_compress(torch.from_numpy(g), 0.25)
    order_j, order_t = np.argsort(np.asarray(ji)), np.argsort(ti.numpy())
    np.testing.assert_array_equal(ti.numpy()[order_t], np.asarray(ji)[order_j])
    np.testing.assert_array_equal(tv.numpy()[order_t], np.asarray(jv)[order_j])
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(
        G.topk_decompress(tv, ti, (64, 32)).numpy(),
        np.asarray(jgrad.topk_decompress(jv, ji, (64, 32))))


def test_error_feedback_is_unbiased_over_time():
    gs = [torch.from_numpy(np.asarray(jax.random.normal(jax.random.fold_in(KEY, i),
                                                        (128,)))) for i in range(5)]
    err, sent = torch.zeros(128), torch.zeros(128)
    for g in gs:
        vals, idx, err = G.topk_compress(g + err, 0.25)
        sent += G.topk_decompress(vals, idx, (128,))
    np.testing.assert_allclose((sent + err).numpy(), sum(gs).numpy(), atol=1e-4)


def test_compress_tree_and_accumulate_match_reference():
    tree = {"a": np.asarray(jax.random.normal(KEY, (16, 8)), np.float32),
            "b": np.arange(6, dtype=np.int32)}
    jcomp, jerr = jgrad.compress_tree({k: jnp.asarray(v) for k, v in tree.items()}, 0.5)
    tcomp, terr = G.compress_tree({k: torch.from_numpy(v) for k, v in tree.items()}, 0.5)
    assert tcomp["a"][2] == (16, 8) and torch.equal(tcomp["b"], torch.arange(6,
                                                                             dtype=torch.int32))
    np.testing.assert_array_equal(np.sort(tcomp["a"][0].numpy()), np.sort(np.asarray(jcomp["a"][0])))
    np.testing.assert_array_equal(terr["a"].numpy(), np.asarray(jerr["a"]))
    assert terr["b"] is None and jerr["b"] is None
    # a second round feeds the error back
    tcomp2, _ = G.compress_tree({k: torch.from_numpy(v) for k, v in tree.items()}, 0.5,
                                errors=terr)
    jcomp2, _ = jgrad.compress_tree({k: jnp.asarray(v) for k, v in tree.items()}, 0.5,
                                    errors=jerr)
    np.testing.assert_allclose(np.sort(tcomp2["a"][0].numpy()),
                               np.sort(np.asarray(jcomp2["a"][0])), rtol=1e-6)
    a, b = {"w": torch.tensor([2.0])}, {"w": torch.tensor([4.0])}
    acc = G.accumulate(b, G.accumulate(a, None, 1), 2)
    jacc = jgrad.accumulate({"w": jnp.asarray([4.0])},
                            jgrad.accumulate({"w": jnp.asarray([2.0])}, None, 1), 2)
    np.testing.assert_allclose(acc["w"].numpy(), np.asarray(jacc["w"]))
