"""The rest of the dense family in the port against the JAX package.

internlm2-1.8b and yi-34b (untied LM head, a packed ``head`` leaf run by
``sod.apply`` with float32 out) and gemma2-27b (post norms, final logit
soft-cap, local/global layers, ``attn_scale``) at their reduced sizes, in
float32.  Weights come from the JAX model (``repro.models.model.build_model``)
through ``params_from_numpy``; each package prunes and packs its own copy.

Tolerances: logits and KV cache atol 1e-4 / rtol 1e-4, as in
``tests/test_torch_model.py`` (float32 on both sides, sums in another
order); losses rtol 1e-5 and first-step gradients atol 1e-6 / rtol 1e-4, as
in ``tests/test_torch_train.py``; greedy tokens, packs and plans exactly.
The engine's tokens equal ``static_generate``'s, and speculative decoding
plain decoding's, bit for bit inside the port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import formats as jformats
from repro.core import sod as jsod
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import model as jmodel_mod
from repro.models import transformer as jtransformer
from repro.runtime import planner as jplanner
from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import sod
from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.tree import PACKED_FIELDS, leaves_with_path
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import autotune
from repro_torch.launch import serve, steps
from repro_torch.models import attention as tattn
from repro_torch.models import transformer
from repro_torch.models.model import LM, build_model
from repro_torch.runtime import planner
from repro_torch.serving import Engine, poisson_trace, static_generate

B, S, GEN = 2, 16, 6
ATOL = RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
ARCHS = ("internlm2-1.8b", "yi-34b", "gemma2-27b")
UNTIED = ("internlm2-1.8b", "yi-34b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' CPU ops gain nothing from intra-op threads, and
    under the suite's parallel workers every worker's threads contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    autotune.set_cache(None)
    yield
    autotune.set_cache(None)


SOD = {"dense": None,
       "tiled_csc": dict(mode="tiled_csc", density=0.3, min_dim=64),
       "block_csr": dict(mode="block_csr", density=0.3, min_dim=64)}


def _configs(arch: str, mode: str = "dense", **kw):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).with_(dtype="float32", **kw)
    tcfg = configs.reduced(configs.get_config(arch)).with_(dtype="float32", **kw)
    if SOD[mode] is not None:
        jcfg = jcfg.with_(sod=jsod.SoDConfig(**SOD[mode]))
        tcfg = tcfg.with_(sod=sod.SoDConfig(**SOD[mode]))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _reference_init(arch: str, head_dim: int | None = None):
    """The JAX model's float32 weights of the reduced ``arch`` as numpy,
    built through the reference's ``build_model``."""
    kw = {} if head_dim is None else {"head_dim": head_dim}
    jcfg, _ = _configs(arch, **kw)
    jparams = jmodel_mod.build_model(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jparams)


def _serve_both(arch: str, mode: str, **kw):
    """Both packages' prefill and GEN greedy decode steps on the same weights
    and prompt tokens, each side pruning and packing its own copy."""
    jcfg, tcfg = _configs(arch, mode, **kw)
    np_params = _reference_init(arch, kw.get("head_dim"))
    tokens = np.asarray(JData(jcfg, B, S, seed=0).batch(0)["tokens"])

    jmodel = jmodel_mod.build_model(jcfg)
    jp = jsod.sodify_params(jax.tree_util.tree_map(jnp.asarray, np_params), jcfg.sod)
    last, cache, pos0 = jserve.prefill_cache(
        jmodel, jp, {"tokens": jnp.asarray(tokens)}, S + GEN)
    jout = {"prefill": np.asarray(last), "cache": jax.tree_util.tree_map(
        lambda t: np.asarray(t).reshape((-1,) + t.shape[2:]), cache),
        "logits": [], "tokens": []}
    decode = jax.jit(jsteps.make_decode_step(jmodel))
    tok = jnp.argmax(last, axis=-1).reshape(B, 1)
    for t in range(GEN):
        nxt, logits, cache = decode(jp, cache, tok, jnp.asarray(pos0 + t, jnp.int32))
        tok = nxt.reshape(B, 1)
        jout["logits"].append(np.asarray(logits))
        jout["tokens"].append(np.asarray(nxt))

    tmodel = build_model(tcfg)
    tp = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"), tcfg.sod)
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
    return {"jax": jout, "torch": tout, "jparams": jp, "tparams": tp, "tcfg": tcfg}


SERVE_CASES = [(a, m) for a in ARCHS for m in ("dense", "tiled_csc")] + [
    ("internlm2-1.8b", "block_csr")]


@pytest.fixture(scope="module", params=SERVE_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def runs(request):
    return _serve_both(*request.param)


def _assert_served_equal(r):
    j, t = r["jax"], r["torch"]
    np.testing.assert_allclose(t["prefill"], j["prefill"], atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        assert t["cache"][name].shape == j["cache"][name].shape
        np.testing.assert_allclose(t["cache"][name], j["cache"][name],
                                   atol=ATOL, rtol=RTOL)
    for lt, lj in zip(t["logits"], j["logits"], strict=True):
        np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(np.stack(t["tokens"]), np.stack(j["tokens"]))


def test_prefill_logits_and_cache_match(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_allclose(t["prefill"], j["prefill"], atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        assert t["cache"][name].shape == j["cache"][name].shape
        np.testing.assert_allclose(t["cache"][name], j["cache"][name],
                                   atol=ATOL, rtol=RTOL)


def test_decode_logits_match(runs):
    for lt, lj in zip(runs["torch"]["logits"], runs["jax"]["logits"], strict=True):
        np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)


def test_greedy_tokens_equal(runs):
    np.testing.assert_array_equal(np.stack(runs["torch"]["tokens"]),
                                  np.stack(runs["jax"]["tokens"]))


def test_logits_finite_and_soft_capped(runs):
    """Finite logits over the padded vocabulary; gemma2's within its cap."""
    cfg = runs["tcfg"]
    logits = np.concatenate([runs["torch"]["prefill"][:, None],
                             *runs["torch"]["logits"]], 1)
    assert logits.shape[-1] == cfg.padded_vocab
    assert np.isfinite(logits).all()
    if cfg.final_softcap is not None:
        assert np.abs(logits).max() <= cfg.final_softcap
    else:
        assert np.abs(logits).max() > 0


def test_head_equals_the_reference(runs):
    """An untied head is packed like any projection, with no lead dims, and
    its buffers equal the reference's bit for bit (dense: the same tensor);
    a tied model has no head leaf in either package."""
    th, jh = runs["tparams"].get("head"), runs["jparams"].get("head")
    if runs["tcfg"].tie_embeddings:
        assert th is None and jh is None
        return
    if not runs["tcfg"].sod.enabled:
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        return
    assert isinstance(th, (TiledCSC, BlockCSR)) and not th.lead
    assert type(th).__name__ == type(jh).__name__
    assert th.shape == tuple(jh.shape) and th.tile == tuple(jh.tile)
    if isinstance(th, TiledCSC):
        assert th.cap == jh.cap
    else:
        assert th.bcap == jh.bcap
    for field in PACKED_FIELDS[type(th)]:
        t, j = getattr(th, field), getattr(jh, field)
        assert (t is None) == (j is None), field
        if t is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=field)


@pytest.mark.parametrize("mode", ["dense", "tiled_csc"])
def test_gemma2_head_dim_apart_from_d_model(mode):
    """gemma2-27b's q and o widths (32 × 128 = 4096) differ from d_model
    (4608); the reduced config ties them (4 × 32 = 128) unless head_dim is
    set: 4 × 48 = 192 against 128, in both packages."""
    r = _serve_both("gemma2-27b", mode, head_dim=48)
    assert tuple(r["tparams"]["layers"][0]["attn"]["wq"].shape) == (128, 192)
    assert tuple(r["tparams"]["layers"][0]["attn"]["wo"].shape) == (192, 128)
    _assert_served_equal(r)


# ---------------------------------------------------------------------------
# training: loss and first-step gradients against jax.grad of LM.loss
# ---------------------------------------------------------------------------
def _stack_to_reference(tparams, np_params):
    """The reference's tree with the port's packed leaves: each projection's
    per-layer packs stacked to (G, P, ...), a packed head as it is."""
    def ref_pack(ws, lead):
        w0 = ws[0]
        fields = {}
        for f in PACKED_FIELDS[type(w0)]:
            ts = [getattr(w, f) for w in ws]
            fields[f] = None if ts[0] is None else jnp.asarray(
                np.stack([t.numpy() for t in ts]).reshape(lead + tuple(ts[0].shape)))
        if isinstance(w0, TiledCSC):
            return jformats.TiledCSC(**fields, shape=w0.shape, tile=w0.tile,
                                     qmode=w0.qmode)
        return jformats.BlockCSR(**fields, shape=w0.shape, tile=w0.tile, br=w0.br,
                                 qmode=w0.qmode)

    blocks = jax.tree_util.tree_map(jnp.asarray, np_params["blocks"])
    lead = np_params["blocks"]["norm1"].shape[:2]
    layers = tparams["layers"]
    for group in ("attn", "mlp"):
        for name, w0 in layers[0][group].items():
            if isinstance(w0, (TiledCSC, BlockCSR)):
                blocks[group][name] = ref_pack([layer[group][name] for layer in layers],
                                               lead)
    out = {k: jnp.asarray(v) for k, v in np_params.items() if k != "blocks"}
    if isinstance(tparams.get("head"), (TiledCSC, BlockCSR)):
        out["head"] = ref_pack([tparams["head"]], ())
    return {**out, "blocks": blocks}


def _leaf_at(node, path: str):
    """The array at a ``leaves_with_path`` path (``['attn']['wq'].vals``)."""
    parts = path.replace("]", "").replace("[", ".").split(".")
    for part in [p.strip("'") for p in parts if p]:
        node = getattr(node, part) if hasattr(node, part) else node[part]
    return np.asarray(node)


GRAD_CASES = [("gemma2-27b", "dense"), ("internlm2-1.8b", "tiled_csc")]


@pytest.fixture(scope="module", params=GRAD_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def grads(request):
    arch, mode = request.param
    jcfg, tcfg = _configs(arch, mode)
    np_params = _reference_init(arch)
    tparams = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"),
                                tcfg.sod)
    batch = JData(jcfg, B, 32, seed=0).batch(0)
    jloss, _, jg = jax.jit(jsteps.make_loss_and_grads(jmodel_mod.build_model(jcfg)))(
        _stack_to_reference(tparams, np_params), batch)
    tbatch = {k: to_torch(np.asarray(v), "cpu").long() for k, v in batch.items()}
    tloss, _, tg = steps.make_loss_and_grads(LM(tcfg))(tparams, tbatch)
    jg = jax.tree_util.tree_map(
        lambda g: None if g.dtype == jax.dtypes.float0 else np.asarray(g), jg)
    return {"arch": arch, "mode": mode, "loss": (float(tloss), float(jloss)),
            "grads": (tg, jg), "params": tparams}


def test_loss_matches_reference(grads):
    np.testing.assert_allclose(*grads["loss"], rtol=LOSS_RTOL)


def test_first_step_gradients_match_reference(grads):
    """Every float leaf's gradient: the top-level ones (embed, final_norm,
    and the packed head's vals) and every layer's, the post norms among
    them; the port's integer leaves have None where the reference's have
    float0."""
    tg, jg = grads["grads"]
    checked = 0
    for name in ("embed", "final_norm", "head"):
        if name not in tg:
            continue
        for path, leaf in leaves_with_path(tg[name]):
            want = _leaf_at(jg[name], path)
            np.testing.assert_allclose(leaf.float().numpy(), want, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=f"{name}{path}")
            checked += 1
    for i, layer in enumerate(tg["layers"]):
        for path, leaf in leaves_with_path(layer):
            want = _leaf_at(jg["blocks"], path)
            want = want.reshape((-1,) + want.shape[2:])[i]
            np.testing.assert_allclose(leaf.float().numpy(), want, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=f"layer {i} {path}")
            checked += 1
    if grads["arch"] == "gemma2-27b":
        assert "norm1_post" in tg["layers"][0] and "norm2_post" in tg["layers"][0]
        assert float(tg["layers"][0]["norm2_post"].abs().max()) > 0
    else:
        head = grads["params"]["head"]
        assert isinstance(head, TiledCSC)
        assert (tg["head"].vals[head.rows < 0] == 0).all()
    assert checked


# ---------------------------------------------------------------------------
# the engine inside the port: tokens equal static_generate bit for bit
# ---------------------------------------------------------------------------
def _port_model(arch: str, mode: str = "dense", dtype: str = "bfloat16", **kw):
    cfg = configs.reduced(configs.get_config(arch)).with_(dtype=dtype, **kw)
    if SOD[mode] is not None:
        cfg = cfg.with_(sod=sod.SoDConfig(**SOD[mode]))
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    raw = model.init(gen, "cpu")
    return model, raw, sod.sodify_params(raw, cfg.sod)


def test_engine_matches_static_serve_windowed_paged():
    """gemma2's sliding-window layers through the paged path, as the
    reference's twin test: the window mask clips gathered pages as it clips
    the dense cache; post norms and the soft-cap on every step."""
    model, _, params = _port_model("gemma2-27b", sliding_window=6)
    trace = poisson_trace(3, 0.6, max_prompt=10, max_new=8, vocab=model.cfg.vocab,
                          seed=1)
    with torch.inference_mode():
        res = Engine(model, params, max_slots=2, page_size=4, max_len=24).run(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req)


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_matches_static_generate_untied_sod_head(chunk):
    """internlm2 with every projection and the head packed: the head runs
    the SoD path at 1 row in static serving and at the engine's rows."""
    model, _, params = _port_model("internlm2-1.8b", "tiled_csc")
    assert isinstance(params["head"], TiledCSC)
    trace = poisson_trace(4, 0.7, max_prompt=20, max_new=7, vocab=model.cfg.vocab,
                          seed=3)
    with torch.inference_mode():
        res = Engine(model, params, max_slots=3, page_size=4, max_len=32,
                     prefill_chunk=chunk).run(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req)


@pytest.mark.parametrize("arch", ["gemma2-27b", "internlm2-1.8b"])
def test_spec_decode_equals_plain_decode(arch):
    """k = 2 with a draft of the same raw weights at density 0.12: the
    verify pass (post norms one window position at a time) gives plain
    decoding's tokens."""
    model, raw, params = _port_model(arch, "tiled_csc")
    draft = sod.sodify_params(raw, planner._draft_sod_cfg(model.cfg.sod, 0.12))
    trace = poisson_trace(3, 0.7, max_prompt=10, max_new=6, vocab=model.cfg.vocab,
                          seed=3)
    kw = dict(max_slots=2, page_size=4, max_len=24)
    with torch.inference_mode():
        spec = Engine(model, params, spec_k=2, draft_params=draft, **kw).run(trace)
        plain = Engine(model, params, **kw).run(trace)
    assert spec["stats"]["spec_windows"] > 0
    assert spec["tokens"] == plain["tokens"]


# ---------------------------------------------------------------------------
# the planner: the reference's plan paths and entries
# ---------------------------------------------------------------------------
PLAN_FIELDS = ("mode", "shape", "lead", "density", "prune_method", "tile", "br",
               "cap", "bcap", "dtype", "qmode", "impl", "dispatch_params")


@pytest.mark.parametrize("arch,lead", [("gemma2-27b", (2, 2)),
                                       ("internlm2-1.8b", (2, 1))])
def test_plan_auto_matches_reference(arch, lead):
    jcfg, tcfg = _configs(arch)
    np_params = _reference_init(arch)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    jsc, tsc = jsod.SoDConfig(**SOD["tiled_csc"]), sod.SoDConfig(**SOD["tiled_csc"])
    jplan = jplanner.build_plan(jparams, jsc, cfg=jcfg, m_values=(32, 2))
    tplan = planner.build_plan(tparams, tsc, cfg=tcfg, m_values=(32, 2))
    fields = lambda e: {f: getattr(e, f) for f in PLAN_FIELDS}  # noqa: E731
    assert {p: fields(e) for p, e in tplan.entries.items()} == {
        p: fields(e) for p, e in jplan.entries.items()}
    blocks = [e for p, e in tplan.entries.items() if p.startswith(".blocks.")]
    assert len(blocks) == 7 and all(e.lead == lead for e in blocks)
    assert (".head" in tplan.entries) == (arch in UNTIED)
    if arch in UNTIED:
        assert tplan.entries[".head"].lead == ()
    packed = sod.sodify_params(tparams, tsc, plan=tplan)
    want = jsod.sodify_params(jparams, jsc, plan=jplan)
    if arch in UNTIED:
        for f in ("vals", "rows"):
            np.testing.assert_array_equal(getattr(packed["head"], f).numpy(),
                                          np.asarray(getattr(want["head"], f)))


# ---------------------------------------------------------------------------
# configs, counts, and the model facade's pieces
# ---------------------------------------------------------------------------
def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "sod"}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch):
    jfull, tfull = jconfigs.get_config(arch), configs.get_config(arch)
    assert _fields(tfull) == _fields(jfull)
    assert _fields(configs.reduced(tfull)) == _fields(jconfigs.reduced(jfull))
    assert tfull.padded_vocab == jfull.padded_vocab


def test_arch_names():
    assert configs.ARCH_NAMES == ("llama3.2-1b", "internlm2-1.8b", "yi-34b",
                                  "gemma2-27b", "granite-moe-1b-a400m",
                                  "qwen2-moe-a2.7b", "pixtral-12b", "musicgen-medium",
                                  "zamba2-2.7b", "xlstm-125m")
    assert set(configs.ARCH_NAMES) == set(jconfigs.ARCH_NAMES)


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_param_counts_equal(arch):
    """Every reference config's counts, the port's config built from its
    fields (all ten, the families the port does not run yet included)."""
    jcfg = jconfigs.get_config(arch)
    tcfg = ModelConfig(**_fields(jcfg))
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert LM(tcfg).param_count() == jmodel_mod.LM(jcfg).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_and_param_leaves(arch):
    """``build_model`` gives the facade of the config; the counted elements
    of the port's tree equal the reference's for the same weights, and the
    tree holds the reference's top-level leaves."""
    jcfg, tcfg = _configs(arch)
    model = build_model(tcfg)
    assert isinstance(model, LM) and model.cfg == tcfg
    np_params = _reference_init(arch)
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    assert set(tparams) - {"layers"} == set(np_params) - {"blocks"}
    assert model.param_count(tparams) == jmodel_mod.build_model(jcfg).param_count(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    drawn = model.init(torch.Generator().manual_seed(0), "cpu")
    assert set(drawn) == set(tparams)
    assert [set(layer) for layer in drawn["layers"]] == \
        [set(layer) for layer in tparams["layers"]]
    for name, leaf in leaves_with_path(drawn):
        assert leaf.dtype == torch.float32, name


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("arch", ["gemma2-27b", "internlm2-1.8b"])
def test_full_attention_matches_reference(arch, window):
    jcfg, tcfg = _configs(arch)
    layer = jax.tree_util.tree_map(lambda a: a[0, 0], _reference_init(arch)["blocks"])
    jspec, tspec = jtransformer.attn_spec(jcfg), transformer.attn_spec(tcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = jattn.full_attention(jax.tree_util.tree_map(jnp.asarray, layer["attn"]),
                                jnp.asarray(x), jspec, jnp.asarray(pos), window=window)
    tl = {k: to_torch(v, "cpu") for k, v in layer["attn"].items()}
    got = tattn.full_attention(tl, to_torch(x, "cpu"), tspec,
                               to_torch(np.ascontiguousarray(pos), "cpu").long(),
                               window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_cache_matches_reference(dtype):
    jcfg, tcfg = _configs("gemma2-27b")
    jspec, tspec = jtransformer.attn_spec(jcfg), transformer.attn_spec(tcfg)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jattn.init_cache(3, 20, jspec, jdt)
    got = tattn.init_cache(3, 20, tspec, dtype, torch.device("cpu"))
    assert set(got) == set(want) == {"k", "v"}
    for k in got:
        assert tuple(got[k].shape) == want[k].shape == (3, 20, 2, 32)
        assert got[k].dtype == dtype and not got[k].any()


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_check_supported_refuses_only_other_families(arch):
    """Every reference family is admitted; a family the reference does not
    have is refused."""
    jcfg = jconfigs.get_config(arch)
    tcfg = ModelConfig(**_fields(jcfg))
    transformer.check_supported(tcfg)
    with pytest.raises(NotImplementedError, match="retnet"):
        transformer.check_supported(tcfg.with_(family="retnet"))
