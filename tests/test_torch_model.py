"""The port's static serving path against the JAX package's, in float32.

The reduced llama3.2-1b is initialised by the JAX model, carried across with
``params_from_numpy``, and both sides are fed the same prompt tokens (the
JAX package's synthetic data).  Dense and ``tiled_csc`` (density 0.3) weights
are each pruned and packed by their own package.

Tolerance: atol 1e-4 / rtol 1e-4 on logits and KV cache — both sides compute
in float32 and differ only in the order of their sums.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import sod as jsod
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models.model import LM as JLM
from repro_torch import configs
from repro_torch.core import sod
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.launch import serve, steps
from repro_torch.models.model import LM

B, S, GEN = 2, 16, 8
ATOL = RTOL = 1e-4


def _configs(mode):
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(
        dtype="float32")
    tcfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        dtype="float32")
    if mode == "tiled_csc":
        jcfg = jcfg.with_(sod=jsod.SoDConfig(mode=mode, density=0.3, min_dim=64))
        tcfg = tcfg.with_(sod=sod.SoDConfig(mode=mode, density=0.3, min_dim=64))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["dense", "tiled_csc"])
def runs(request):
    """Both packages' prefill + GEN greedy decode steps on the same inputs."""
    jcfg, tcfg = _configs(request.param)
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.asarray(JData(jcfg, B, S, seed=0).batch(0)["tokens"])

    # JAX static serve loop (launch/serve.py): prefill_cache, then jit'd
    # greedy decode steps
    jmodel = JLM(jcfg)
    jp = jsod.sodify_params(jparams, jcfg.sod)
    last, cache, pos0 = jserve.prefill_cache(
        jmodel, jp, {"tokens": jnp.asarray(tokens)}, S + GEN)
    jout = {"prefill": np.asarray(last), "cache": jax.tree_util.tree_map(
        lambda t: np.asarray(t).reshape((-1,) + t.shape[2:]), cache),
        "logits": [], "tokens": []}
    decode = jax.jit(jsteps.make_decode_step(jmodel))
    tok = jnp.argmax(last, axis=-1).reshape(B, 1)
    for t in range(GEN):
        nxt, logits, cache = decode(jp, cache, tok,
                                    jnp.asarray(pos0 + t, jnp.int32))
        tok = nxt.reshape(B, 1)
        jout["logits"].append(np.asarray(logits))
        jout["tokens"].append(np.asarray(nxt))

    # the port, fed the same weights and tokens
    tmodel = LM(tcfg)
    tp = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"),
                           tcfg.sod)
    with torch.inference_mode():
        last, cache, pos0 = serve.prefill_cache(
            tmodel, tp, to_torch(tokens, "cpu").long(), S + GEN)
        tout = {"prefill": last.numpy(),
                "cache": {k: v.clone().numpy() for k, v in cache.items()},
                "logits": [], "tokens": []}
        decode = steps.make_decode_step(tmodel)
        tok = last.argmax(dim=-1).reshape(B, 1)
        for t in range(GEN):
            nxt, logits, cache = decode(tp, cache, tok, pos0 + t)
            tok = nxt.reshape(B, 1)
            tout["logits"].append(logits.numpy())
            tout["tokens"].append(nxt.numpy())
    return {"mode": request.param, "jax": jout, "torch": tout,
            "jparams": jp, "tparams": tp, "tokens": tokens, "model": tmodel}


def test_prefill_logits_and_cache_match(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_allclose(t["prefill"], j["prefill"], atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        assert t["cache"][name].shape == j["cache"][name].shape
        np.testing.assert_allclose(t["cache"][name], j["cache"][name],
                                   atol=ATOL, rtol=RTOL)


def test_prefill_step_greedy_tokens(runs):
    step = steps.make_prefill_step(runs["model"])
    with torch.inference_mode():
        nxt, cache = step(runs["tparams"], to_torch(runs["tokens"], "cpu").long())
    np.testing.assert_array_equal(nxt.numpy(),
                                  runs["jax"]["prefill"].argmax(axis=-1))
    assert cache["k"].shape == (2, B, S, 2, 32)


def test_decode_logits_match(runs):
    for lt, lj in zip(runs["torch"]["logits"], runs["jax"]["logits"]):
        np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)


def test_greedy_tokens_equal(runs):
    tt = np.stack(runs["torch"]["tokens"]).reshape(GEN, B)
    tj = np.stack(runs["jax"]["tokens"]).reshape(GEN, B)
    np.testing.assert_array_equal(tt, tj)


def test_packed_layers_and_bytes_equal(runs):
    jp, tp = runs["jparams"], runs["tparams"]
    names = [("attn", n) for n in ("wq", "wk", "wv", "wo")] + \
        [("mlp", n) for n in ("w_gate", "w_up", "w_down")]
    for i, layer in enumerate(tp["layers"]):
        for group, name in names:
            tw, jw = layer[group][name], jp["blocks"][group][name]
            if runs["mode"] == "dense":
                assert isinstance(tw, torch.Tensor)
                continue
            assert tw.cap == jw.cap and tw.lead == ()
            np.testing.assert_array_equal(tw.rows.numpy(),
                                          np.asarray(jw.rows)[i, 0])
            np.testing.assert_array_equal(tw.vals.numpy(),
                                          np.asarray(jw.vals)[i, 0])
    tb, jb = sod.tree_weight_bytes(tp), jsod.tree_weight_bytes(jp)
    assert tb == jb                     # compressed, dense and their ratio


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "sod"}


def test_config_fields_equal():
    jfull = jconfigs.get_config("llama3.2-1b")
    tfull = configs.get_config("llama3.2-1b")
    assert _fields(tfull) == _fields(jfull)
    assert _fields(configs.reduced(tfull)) == _fields(jconfigs.reduced(jfull))
    assert tfull.padded_vocab == jfull.padded_vocab


def test_data_successor_table_equal():
    jcfg, tcfg = _configs("dense")
    td, jd = SyntheticLMData(tcfg, 3, 12, seed=5), JData(jcfg, 3, 12, seed=5)
    np.testing.assert_array_equal(td._succ, jd._succ)
    toks = td.batch(0)["tokens"]
    assert toks.shape == (3, 12) and toks.dtype == np.int32
    # every step walks an edge of the shared chain
    for row in td.batch(1)["tokens"]:
        for a, b in zip(row[:-1], row[1:]):
            assert b in td._succ[a]


@pytest.mark.parametrize("window,softcap", [(None, None), (24, None),
                                            (None, 30.0), (24, 30.0)])
def test_attention_matches_reference(window, softcap):
    """chunked_attention (several chunks, sliding window, soft-cap) and the
    cached one-token attention against the reference's, in float32."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    rng = np.random.default_rng(4)
    b, s, h, kvh, hd = 2, 64, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32)
               for n in (h, kvh, kvh))
    kw = dict(n_heads=h, n_kv_heads=kvh, head_dim=hd, softcap=softcap,
              chunk_q=16, chunk_k=16)
    js, ts = jattn.AttnSpec(**kw), tattn.AttnSpec(**kw)
    yj = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), js, window=window)
    yt = tattn.chunked_attention(*(to_torch(a, "cpu") for a in (q, k, v)), ts,
                                 window=window)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL, rtol=RTOL)
    pos = 40
    q1 = q[:, pos:pos + 1]
    oj = jattn._attend_cached(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v),
                              pos, js, window)
    ot = tattn._attend_cached(to_torch(q1, "cpu"), to_torch(k, "cpu"),
                              to_torch(v, "cpu"), pos, ts, window)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=RTOL)


def test_lm_head_keeps_f32_accumulator_in_bf16():
    """In bfloat16 the tied head's logits are the f32 sums of the bf16
    products, as the reference's dot with preferred_element_type=float32:
    equal within float32 rounding (sums in another order), far inside the
    half bf16 step (2**-9 relative) that rounding the logits to bf16 costs."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer as ttransformer

    # a vocabulary that is not a multiple of the padding, so the mask shows
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(vocab=500)
    tcfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(vocab=500)
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    assert jcfg.padded_vocab == tcfg.padded_vocab > 500
    rng = np.random.default_rng(12)
    d, v = tcfg.d_model, tcfg.padded_vocab
    bf16 = jnp.bfloat16
    embed = jnp.asarray(rng.standard_normal((v, d)), jnp.float32).astype(bf16)
    gamma = jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32)
    x = jnp.asarray(rng.standard_normal((2, 5, d)), jnp.float32).astype(bf16)
    lj = np.asarray(jtransformer.project_logits(
        {"embed": embed, "final_norm": gamma}, x, jcfg))
    tparams = {"embed": to_torch(np.asarray(embed), "cpu"),
               "final_norm": to_torch(np.asarray(gamma), "cpu")}
    lt = ttransformer.project_logits(tparams, to_torch(np.asarray(x), "cpu"), tcfg)
    assert lt.dtype == torch.float32 and lt.shape == lj.shape
    live = slice(0, tcfg.vocab)
    scale = np.abs(lj[..., live]).max()
    np.testing.assert_allclose(lt.numpy()[..., live], lj[..., live], rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_array_equal(lt.numpy()[..., tcfg.vocab:], np.float32(-1e30))
