"""The MoE family in the port against the JAX package.

granite-moe-1b-a400m (32 routed experts, top-8, tied head) and
qwen2-moe-a2.7b (60 routed experts padded to 64, top-4, a shared expert
behind a sigmoid gate, an untied head) at their reduced sizes, in float32.
Weights come from the JAX model (``repro.models.model.build_model``)
through ``params_from_numpy``; each package prunes and packs its own copy.

The plan route is the one both packages serve MoE through: a plan built by
the planner with the routed experts' entries dropped
(``repro_torch.models.moe.without_routed``), written by the port and
replayed by the reference, so attention, the shared expert and the head
pack and the routed experts stay dense.  Packing the routed experts
(without a plan, or under the full plan) raises in both packages (fault
R4, kept from the reference).

Tolerances: logits atol 1e-4 / rtol 1e-4, losses rtol 1e-5 and gradients
atol 1e-6 / rtol 1e-4, as ``tests/test_torch_dense_family.py``; greedy
tokens, packs and plan entries exactly; the engine's tokens equal
``static_generate``'s bit for bit inside the port.
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
from repro.core import plan as jplan_mod
from repro.core import sod as jsod
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import model as jmodel_mod
from repro.models import transformer as jtransformer
from repro.runtime import planner as jplanner
from repro_torch import configs
from repro_torch.core import sod
from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.tree import PACKED_FIELDS, leaves_with_path
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import autotune
from repro_torch.launch import serve, steps, train
from repro_torch.models import moe, transformer
from repro_torch.models.model import LM, build_model
from repro_torch.runtime import planner
from repro_torch.serving import Engine, poisson_trace, static_generate

B, S, GEN = 2, 16, 4
ATOL = RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
ARCHS = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b")
PACKED = (TiledCSC, BlockCSR)
PLAN_FIELDS = ("mode", "shape", "lead", "density", "prune_method", "tile", "br",
               "cap", "bcap", "dtype", "qmode", "impl", "dispatch_params")


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


SOD = {"tiled_csc": dict(mode="tiled_csc", density=0.3, min_dim=64),
       "block_csr": dict(mode="block_csr", density=0.3, min_dim=64,
                         prune_method="block")}


def _configs(arch: str, mode: str | None = None):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).with_(dtype="float32")
    tcfg = configs.reduced(configs.get_config(arch)).with_(dtype="float32")
    if mode is not None:
        jcfg = jcfg.with_(sod=jsod.SoDConfig(**SOD[mode]))
        tcfg = tcfg.with_(sod=sod.SoDConfig(**SOD[mode]))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _reference_init(arch: str):
    """The JAX model's float32 weights of the reduced ``arch`` as numpy."""
    jcfg, _ = _configs(arch)
    jparams = jmodel_mod.build_model(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jparams)


@functools.lru_cache(maxsize=None)
def _plans(arch: str, mode: str):
    """(the port's full plan, the same without routed entries, that one as
    the reference loads it), built by the port's planner on the reduced
    weights; the file crosses the packages."""
    jcfg, tcfg = _configs(arch, mode)
    tparams = params_from_numpy(_reference_init(arch), tcfg, device="cpu")
    full = planner.build_plan(tparams, tcfg.sod, cfg=tcfg, m_values=(B * S, B))
    filtered = moe.without_routed(full)
    return full, filtered, jplan_mod.ModelPlan.from_json(filtered.to_json())


def _ref_pack(ws, lead):
    """The reference's stacked pack of the port's per-layer packs."""
    w0 = ws[0]
    fields = {}
    for f in PACKED_FIELDS[type(w0)]:
        ts = [getattr(w, f) for w in ws]
        fields[f] = None if ts[0] is None else jnp.asarray(
            np.stack([t.numpy() for t in ts]).reshape(lead + tuple(ts[0].shape)))
    if isinstance(w0, TiledCSC):
        return jformats.TiledCSC(**fields, shape=w0.shape, tile=w0.tile, qmode=w0.qmode)
    return jformats.BlockCSR(**fields, shape=w0.shape, tile=w0.tile, br=w0.br,
                             qmode=w0.qmode)


def _to_reference(tparams, np_params):
    """The reference's tree holding the port's packs: each packed layer leaf
    stacked to (G, P, ...), a packed head as it is, the rest the numpy
    weights."""
    lead = np_params["blocks"]["norm1"].shape[:2]
    layers = tparams["layers"]

    def walk(np_node, t0, path):
        if isinstance(np_node, dict):
            return {k: walk(v, t0[k], path + (k,)) for k, v in np_node.items()}
        if isinstance(t0, PACKED):
            ws = [functools.reduce(lambda n, k: n[k], path, layer) for layer in layers]
            return _ref_pack(ws, lead)
        return jnp.asarray(np_node)

    out = {k: jnp.asarray(v) for k, v in np_params.items() if k != "blocks"}
    if isinstance(tparams.get("head"), PACKED):
        out["head"] = _ref_pack([tparams["head"]], ())
    return {**out, "blocks": walk(np_params["blocks"], layers[0], ())}


def _assert_pack_equal(t, j, lead_index=()):
    assert type(t).__name__ == type(j).__name__
    assert t.shape == tuple(j.shape) and t.tile == tuple(j.tile)
    for field in PACKED_FIELDS[type(t)]:
        a, b = getattr(t, field), getattr(j, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b)[lead_index],
                                          err_msg=field)


# ---------------------------------------------------------------------------
# configs, counts, weights carried across
# ---------------------------------------------------------------------------
def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "sod"}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_specs_equal(arch):
    jfull, tfull = jconfigs.get_config(arch), configs.get_config(arch)
    assert _fields(tfull) == _fields(jfull)
    assert _fields(configs.reduced(tfull)) == _fields(jconfigs.reduced(jfull))
    for jc, tc in ((jfull, tfull), (jconfigs.reduced(jfull), configs.reduced(tfull))):
        assert dataclasses.asdict(transformer.moe_spec(tc)) == \
            dataclasses.asdict(jtransformer.moe_spec(jc))


@pytest.mark.parametrize("arch,billions", [("granite-moe-1b-a400m", 1.33),
                                           ("qwen2-moe-a2.7b", 14.3)])
def test_full_size_param_counts_equal(arch, billions):
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    assert LM(tcfg).param_count() == jmodel_mod.LM(jcfg).param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert round(tcfg.param_count() / 1e9, 2 if billions < 10 else 1) == billions


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carried_across(arch):
    """Every leaf of every layer, the ``moe`` subtree included (router and
    shared gate float32, the (E, d, f) expert stacks, the shared MLP), is
    the reference's slice; the port's init draws the same tree."""
    jcfg, tcfg = _configs(arch)
    np_params = _reference_init(arch)
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    e = transformer.moe_spec(tcfg).n_experts_padded
    d, f = tcfg.d_model, tcfg.d_ff
    for i, layer in enumerate(tparams["layers"]):
        mo = layer["moe"]
        assert mo["router"].dtype == torch.float32
        assert tuple(mo["router"].shape) == (d, e)
        assert tuple(mo["w_gate"].shape) == (e, d, f)
        assert tuple(mo["w_down"].shape) == (e, f, d)
        assert ("shared" in mo) == (tcfg.n_shared_experts > 0)
        if "shared_gate" in mo:
            assert mo["shared_gate"].dtype == torch.float32
            assert tuple(mo["shared_gate"].shape) == (d, 1)
        for path, leaf in leaves_with_path(layer):
            parts = [p.strip("'") for p in path.replace("]", "").split("[") if p]
            want = functools.reduce(lambda n, k: n[k], parts, np_params["blocks"])
            np.testing.assert_array_equal(leaf.numpy(), want.reshape(
                (-1,) + want.shape[2:])[i], err_msg=path)
    assert LM(tcfg).param_count(tparams) == jmodel_mod.LM(jcfg).param_count(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    drawn = LM(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: {p: tuple(v.shape) for p, v in leaves_with_path(t)}  # noqa: E731
    assert [shapes(layer) for layer in drawn["layers"]] == \
        [shapes(layer) for layer in tparams["layers"]]


# ---------------------------------------------------------------------------
# the planner and packing
# ---------------------------------------------------------------------------
CASES = [(a, m) for a in ARCHS for m in ("tiled_csc", "block_csr")]


@pytest.mark.parametrize("arch,mode", CASES)
def test_plan_entries_and_packs_match_reference(arch, mode):
    """The planner's entries equal the reference's, the routed experts' lead
    (G, P, E); packing under the plan gives the reference's buffers, the
    routed experts' (E,)-stacked packs included."""
    jcfg, tcfg = _configs(arch, mode)
    np_params = _reference_init(arch)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    jplan = jplanner.build_plan(jparams, jcfg.sod, cfg=jcfg, m_values=(B * S, B))
    tplan = _plans(arch, mode)[0]
    fields = lambda e: {f: getattr(e, f) for f in PLAN_FIELDS}  # noqa: E731
    assert {p: fields(e) for p, e in tplan.entries.items()} == {
        p: fields(e) for p, e in jplan.entries.items()}
    e = transformer.moe_spec(tcfg).n_experts_padded
    for path in moe.ROUTED_PATHS:
        assert tplan.entries[path].lead == (tcfg.n_layers, 1, e)
    assert (".head" in tplan.entries) == (not tcfg.tie_embeddings)
    packed = sod.sodify_params(tparams, tcfg.sod, plan=tplan)
    want = jsod.sodify_params(jparams, jcfg.sod, plan=jplan)
    n = 0
    for path, entry in tplan.entries.items():
        if entry.mode == "dense":
            continue
        names = path.strip(".").split(".")
        if names[0] != "blocks":
            _assert_pack_equal(packed[names[0]], want[names[0]])
            n += 1
            continue
        jw = functools.reduce(lambda t, k: t[k], names, want)
        for i, layer in enumerate(packed["layers"]):
            tw = functools.reduce(lambda t, k: t[k], names[1:], layer)
            assert tw.lead == tuple(entry.lead[2:])
            _assert_pack_equal(tw, jw, (i, 0))
            n += 1
    assert n >= 3 * tcfg.n_layers


# ---------------------------------------------------------------------------
# serving under the plan without routed entries
# ---------------------------------------------------------------------------
def _serve_both(arch: str, mode: str):
    jcfg, tcfg = _configs(arch, mode)
    _, tplan, jplan = _plans(arch, mode)
    np_params = _reference_init(arch)
    tokens = np.asarray(JData(jcfg, B, S, seed=0).batch(0)["tokens"])

    jmodel = jmodel_mod.build_model(jcfg)
    jp = jsod.sodify_params(jax.tree_util.tree_map(jnp.asarray, np_params), jcfg.sod,
                            plan=jplan)
    last, cache, pos0 = jserve.prefill_cache(
        jmodel, jp, {"tokens": jnp.asarray(tokens)}, S + GEN, plan=jplan)
    jout = {"prefill": np.asarray(last), "logits": [], "tokens": []}
    decode = jax.jit(jsteps.make_decode_step(jmodel, plan=jplan))
    tok = jnp.argmax(last, axis=-1).reshape(B, 1)
    for t in range(GEN):
        nxt, logits, cache = decode(jp, cache, tok, jnp.asarray(pos0 + t, jnp.int32))
        tok = nxt.reshape(B, 1)
        jout["logits"].append(np.asarray(logits))
        jout["tokens"].append(np.asarray(nxt))

    tmodel = build_model(tcfg)
    tp = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"), tcfg.sod,
                           plan=tplan)
    with torch.inference_mode():
        last, cache, pos0 = serve.prefill_cache(
            tmodel, tp, to_torch(tokens, "cpu").long(), S + GEN, plan=tplan)
        tout = {"prefill": last.numpy(), "logits": [], "tokens": []}
        decode = steps.make_decode_step(tmodel, plan=tplan)
        tok = last.argmax(dim=-1).reshape(B, 1)
        for t in range(GEN):
            nxt, logits, cache = decode(tp, cache, tok, pos0 + t)
            tok = nxt.reshape(B, 1)
            tout["logits"].append(logits.numpy())
            tout["tokens"].append(nxt.numpy())
    return {"jax": jout, "torch": tout, "jparams": jp, "tparams": tp, "tcfg": tcfg}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def runs(request):
    return _serve_both(*request.param)


def test_prefill_and_decode_logits_match(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_allclose(t["prefill"], j["prefill"], atol=ATOL, rtol=RTOL)
    for lt, lj in zip(t["logits"], j["logits"], strict=True):
        np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)
    assert np.isfinite(t["prefill"]).all()


def test_greedy_tokens_equal(runs):
    np.testing.assert_array_equal(np.stack(runs["torch"]["tokens"]),
                                  np.stack(runs["jax"]["tokens"]))


def test_routed_experts_dense_and_the_rest_packed(runs):
    """Under the plan without routed entries: the routed experts are the
    dense stacks in both packages; wq/wo, the shared expert and the head
    are packed in both."""
    tp, jp, cfg = runs["tparams"], runs["jparams"], runs["tcfg"]
    for layer in tp["layers"]:
        for name in moe.ROUTED:
            assert isinstance(layer["moe"][name], torch.Tensor)
        assert isinstance(layer["attn"]["wq"], PACKED)
        if cfg.n_shared_experts:
            assert all(isinstance(w, PACKED) for w in layer["moe"]["shared"].values())
    for name in moe.ROUTED:
        assert isinstance(jp["blocks"]["moe"][name], jax.Array)
    assert isinstance(tp.get("head"), PACKED) == (not cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# training: loss (ce + aux) and its gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,mode", [("granite-moe-1b-a400m", None),
                                       ("qwen2-moe-a2.7b", "tiled_csc")])
def test_loss_with_aux_and_gradients_match(arch, mode):
    jcfg, tcfg = _configs(arch, mode)
    np_params = _reference_init(arch)
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    plan = None
    if mode is not None:
        plan = _plans(arch, mode)[1]
        tparams = sod.sodify_params(tparams, tcfg.sod, plan=plan)
    batch = JData(jcfg, B, 32, seed=0).batch(0)
    jmodel = jmodel_mod.build_model(jcfg)
    jref = _to_reference(tparams, np_params)
    jloss, jmet, jg = jax.jit(jsteps.make_loss_and_grads(jmodel))(jref, batch)
    tbatch = {k: to_torch(np.asarray(v), "cpu").long() for k, v in batch.items()}
    tloss, tmet, tg = steps.make_loss_and_grads(LM(tcfg), plan=plan)(tparams, tbatch)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=LOSS_RTOL,
                                   err_msg=key)
    assert float(tmet["aux"]) > 0
    jg = jax.tree_util.tree_map(
        lambda g: None if g.dtype == jax.dtypes.float0 else np.asarray(g), jg)
    checked = 0
    for name in ("embed", "final_norm", "head"):
        for path, leaf in leaves_with_path(tg.get(name, {})):
            want = jg[name]
            for part in [p.strip("'") for p in path.replace("]", "").replace(
                    "[", ".").split(".") if p]:
                want = getattr(want, part) if hasattr(want, part) else want[part]
            np.testing.assert_allclose(leaf.float().numpy(), np.asarray(want),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name + path)
            checked += 1
    for i, layer in enumerate(tg["layers"]):
        for path, leaf in leaves_with_path(layer):
            want = jg["blocks"]
            for part in [p.strip("'") for p in path.replace("]", "").replace(
                    "[", ".").split(".") if p]:
                want = getattr(want, part) if hasattr(want, part) else want[part]
            want = np.asarray(want)
            want = want.reshape((-1,) + want.shape[2:])[i]
            np.testing.assert_allclose(leaf.float().numpy(), want, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=f"layer {i} {path}")
            checked += 1
    router = tg["layers"][0]["moe"]["router"]
    assert float(router.abs().max()) > 0 and checked


# ---------------------------------------------------------------------------
# the engine, the training driver, and fault R4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,chunk", [("granite-moe-1b-a400m", None),
                                        ("granite-moe-1b-a400m", 8),
                                        ("qwen2-moe-a2.7b", None)])
def test_engine_matches_static_generate(arch, chunk):
    """bf16, the plan without routed entries: every request's tokens equal
    ``static_generate``'s under the same plan (no token is dropped at these
    shapes: capacity is at least 128 slots an expert)."""
    cfg = configs.reduced(configs.get_config(arch)).with_(sod=sod.SoDConfig(
        **SOD["tiled_csc"]))
    model = build_model(cfg)
    raw = model.init(torch.Generator().manual_seed(0), "cpu")
    plan = moe.without_routed(planner.build_plan(raw, cfg.sod, cfg=cfg, m_values=(16, 3)))
    params = sod.sodify_params(raw, cfg.sod, plan=plan)
    trace = poisson_trace(4, 0.7, max_prompt=20, max_new=6, vocab=cfg.vocab, seed=3)
    with torch.inference_mode():
        res = Engine(model, params, max_slots=3, page_size=4, max_len=32, plan=plan,
                     prefill_chunk=chunk).run(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req,
                                                             plan=plan)


def test_train_driver_under_the_plan(tmp_path):
    """``launch/train.py --plan P`` trains the reduced granite-moe: two steps,
    finite losses and gradient norms, the router aux loss inside each loss."""
    cfg = configs.reduced(configs.get_config("granite-moe-1b-a400m"))
    raw = LM(cfg).init(torch.Generator().manual_seed(0), "cpu")    # --seed 0
    tplan = moe.without_routed(planner.build_plan(
        raw, sod.SoDConfig(**SOD["tiled_csc"]), cfg=cfg, m_values=(64,)))
    path = tplan.save(tmp_path / "plan.json")
    summary = train.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--sod",
                          "tiled_csc", "--density", "0.3", "--plan", str(path),
                          "--steps", "2", "--batch", "2", "--seq", "32", "--device",
                          "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    assert summary["plan_layers"] == len(tplan)
    assert np.isfinite(summary["losses"] + summary["grad_norms"]).all()
    assert all(0 < a < 1 for a in summary["aux_losses"])
    layer = summary["state"]["params"]["layers"][0]
    assert isinstance(layer["attn"]["wq"], TiledCSC)
    assert isinstance(layer["moe"]["w_gate"], torch.Tensor)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("how", ["global", "full_plan"])
def test_packed_routed_experts_raise_in_both_packages(arch, how):
    """Fault R4, kept: the same weights packed with the routed experts —
    by the global config or under the full plan — fail in the reference's
    expert einsum and in the port's ``moe_mlp``."""
    jcfg, tcfg = _configs(arch, "tiled_csc")
    np_params = _reference_init(arch)
    tokens = np.asarray(JData(jcfg, B, 8, seed=0).batch(0)["tokens"])
    jplan = tplan = None
    if how == "full_plan":
        tplan = _plans(arch, "tiled_csc")[0]
        jplan = jplan_mod.ModelPlan.from_json(tplan.to_json())
    jp = jsod.sodify_params(jax.tree_util.tree_map(jnp.asarray, np_params), jcfg.sod,
                            plan=jplan)
    tp = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"), tcfg.sod,
                           plan=tplan)
    assert isinstance(jp["blocks"]["moe"]["w_gate"], jformats.TiledCSC)
    assert isinstance(tp["layers"][0]["moe"]["w_gate"], TiledCSC)
    assert tp["layers"][0]["moe"]["w_gate"].lead == (transformer.moe_spec(
        tcfg).n_experts_padded,)
    with pytest.raises(ValueError):
        jmodel_mod.build_model(jcfg).apply(jp, {"tokens": jnp.asarray(tokens)})
    with pytest.raises(ValueError, match="R4"):
        build_model(tcfg).apply(tp, to_torch(tokens, "cpu").long())


def test_serve_cli_under_a_plan_file(tmp_path):
    """``serve --arch qwen2-moe-a2.7b --reduced --sod tiled_csc --plan P``
    (static, then ``--engine``) on the CPU."""
    cfg = configs.reduced(configs.get_config("qwen2-moe-a2.7b"))
    model = build_model(cfg)
    sc = sod.SoDConfig(mode="tiled_csc", density=0.3, min_dim=64)
    raw = model.init(torch.Generator().manual_seed(0), "cpu")
    path = moe.without_routed(planner.build_plan(raw, sc, cfg=cfg)).save(
        tmp_path / "plan.json")
    argv = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--sod", "tiled_csc",
            "--density", "0.3", "--plan", str(path), "--batch", "2", "--prompt-len",
            "8", "--gen", "3", "--device", "cpu"]
    static = serve.main(argv)
    assert static["logits_finite"] and static["plan_layers"] == 8
    engine = serve.main(argv + ["--engine", "--requests", "3"])
    assert engine["completed"] == 3 and engine["logits_finite"]
