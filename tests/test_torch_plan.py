"""The port's pack plans and planner (``repro_torch.core.plan``,
``repro_torch.runtime.planner``, the plan path of ``repro_torch.core.sod``)
against the JAX package's, mirroring ``tests/test_planner.py``.

Weights: the reduced llama3.2-1b's JAX initialiser in float32, carried
across with ``repro_torch.interop``.  A plan the reference builds replays in
the port to bit-equal packs; the port's planner gives the reference's
entries field by field (every field but the free-text ``note``, which names
each package's own impls and drifts); the greedy tokens of both packages'
static serving under one plan are equal.  Each test points
``REPRO_TORCH_TUNING_CACHE`` at its own ``tmp_path``.
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import plan as jplan_mod
from repro.core import pruning as jpruning
from repro.core import sod as jsod
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models.model import LM as JLM
from repro.runtime import planner as jplanner
from repro_torch import configs
from repro_torch.core import plan as plan_mod
from repro_torch.core import pruning, sod
from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.plan import ModelPlan, PackPlan
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import autotune, registry
from repro_torch.launch import serve, steps
from repro_torch.models.model import LM
from repro_torch.runtime import planner

B, S, GEN = 2, 16, 6
FIELDS = ("mode", "shape", "lead", "density", "prune_method", "tile", "br", "cap",
          "bcap", "dtype", "qmode", "impl", "dispatch_params", "spmd")


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    autotune.set_cache(None)
    yield autotune.get_cache()
    autotune.set_cache(None)


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX params, port config, port params): the reduced
    llama's JAX weights in float32 on both sides."""
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(dtype="float32")
    tcfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(dtype="float32")
    jparams = JLM(jcfg).init(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, params_from_numpy(np_params, tcfg, device="cpu")


SOD = {
    "tiled_csc": dict(mode="tiled_csc", density=0.3, min_dim=64),
    "block_csr": dict(mode="block_csr", density=0.4, prune_method="block", min_dim=64),
}


def _cfgs(fmt, **kw):
    return jsod.SoDConfig(**SOD[fmt], **kw), sod.SoDConfig(**SOD[fmt], **kw)


def _shapes_of(tree):
    return jax.tree_util.tree_map(
        lambda l: jax.ShapeDtypeStruct(tuple(l.shape), jnp.dtype(l.dtype)), tree)


def _fields(e):
    return {f: getattr(e, f) for f in FIELDS}


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8)
    return a


def _tbits(t):
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        two = t.element_size() == 2
        return t.view(torch.int16 if two else torch.int8).numpy().view(
            np.uint16 if two else np.uint8)
    return t.numpy()


PACK_FIELDS = {TiledCSC: ("vals", "rows", "scale", "codebook"),
               BlockCSR: ("block_vals", "block_ids", "tile_nnz", "scale", "codebook")}


def _assert_packs_equal(tparams, jparams, plan_paths):
    """Every planned leaf of the port's per-layer tree bit-equal to the
    reference's stacked leaf, layer by layer."""
    checked = 0
    for path in plan_paths:
        name = path.strip(".").split(".")[1:]
        jleaf = jparams["blocks"]
        for part in name:
            jleaf = jleaf[part]
        for i, layer in enumerate(tparams["layers"]):
            tleaf = layer
            for part in name:
                tleaf = tleaf[part]
            if isinstance(tleaf, torch.Tensor):
                np.testing.assert_array_equal(
                    _tbits(tleaf), _bits(np.asarray(jleaf).reshape(
                        (-1,) + tleaf.shape)[i]))
                continue
            assert type(tleaf).__name__ == type(jleaf).__name__
            assert tleaf.qmode == jleaf.qmode
            for field in PACK_FIELDS[type(tleaf)]:
                t, j = getattr(tleaf, field), getattr(jleaf, field)
                assert (t is None) == (j is None), field
                if t is not None:
                    j = np.asarray(j)
                    np.testing.assert_array_equal(
                        _tbits(t), _bits(j.reshape((-1,) + j.shape[2:])[i]),
                        err_msg=f"{path} layer {i} {field}")
            checked += 1
    assert checked


# ---------------------------------------------------------------------------
# the plan file: the reference's plans replay in the port, and back
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt,qmode", [("tiled_csc", "none"), ("tiled_csc", "int8"),
                                       ("tiled_csc", "codebook"), ("block_csr", "none"),
                                       ("block_csr", "fp8")])
def test_reference_plan_replays_to_bit_equal_packs(weights, fmt, qmode, tmp_path):
    jcfg, jparams, tcfg, tparams = weights
    jsc, tsc = _cfgs(fmt, qmode=qmode)
    jplan = jplanner.build_plan(jparams, jsc, cfg=jcfg, m_values=(32, 2))
    path = jplan.save(tmp_path / "plan.json")
    tplan = ModelPlan.load(path)
    assert {p: _fields(e) for p, e in tplan.entries.items()} == {
        p: _fields(PackPlan.from_json(e.to_json())) for p, e in jplan.entries.items()}
    _assert_packs_equal(sod.sodify_params(tparams, tsc, plan=tplan),
                        jsod.sodify_params(jparams, jsc, plan=jplan), tplan.entries)


def test_port_plan_file_loads_in_the_reference(weights, tmp_path):
    _, _, tcfg, tparams = weights
    _, tsc = _cfgs("block_csr", qmode="int8")
    tplan = planner.build_plan(tparams, tsc, cfg=tcfg, m_values=(16, 2))
    jplan = jplan_mod.ModelPlan.load(tplan.save(tmp_path / "plan.json"))
    assert json.loads(json.dumps(jplan.to_json())) == json.loads(
        json.dumps(tplan.to_json()))
    assert jplan.compressed_bytes() == tplan.compressed_bytes()
    assert jplan_mod.PLAN_VERSION == plan_mod.PLAN_VERSION


# ---------------------------------------------------------------------------
# the planner: the reference's entries, from concrete and abstract leaves
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def auto_plans(weights):
    """Both packages' ``qmode="auto"`` plans from concrete leaves, per format
    (the drift pass fits codebooks in numpy: built once per module)."""
    jcfg, jparams, tcfg, tparams = weights
    out = {}
    for fmt in SOD:
        jsc, tsc = _cfgs(fmt)
        out[fmt] = (jplanner.build_plan(jparams, jsc, cfg=jcfg, m_values=(32, 2),
                                        qmode="auto"),
                    planner.build_plan(tparams, tsc, cfg=tcfg, m_values=(32, 2),
                                       qmode="auto"))
    return out


@pytest.mark.parametrize("source", ["concrete", "abstract"])
@pytest.mark.parametrize("qmode", ["none", "int8", "auto"])
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
def test_build_plan_matches_reference(weights, auto_plans, fmt, qmode, source):
    jcfg, jparams, tcfg, tparams = weights
    jsc, tsc = _cfgs(fmt)
    if qmode == "auto" and source == "concrete":
        jplan, tplan = auto_plans[fmt]
    else:
        jin, tin = ((jparams, tparams) if source == "concrete" else
                    (_shapes_of(jparams), planner._to_meta(tparams)))
        jplan = jplanner.build_plan(jin, jsc, cfg=jcfg, m_values=(32, 2), qmode=qmode)
        tplan = planner.build_plan(tin, tsc, cfg=tcfg, m_values=(32, 2), qmode=qmode)
    assert len(tplan) == 7
    assert {p: _fields(e) for p, e in tplan.entries.items()} == {
        p: _fields(e) for p, e in jplan.entries.items()}
    for e in tplan.entries.values():
        assert e.lead == (2, 1)
        if qmode == "auto" and e.mode != "dense":
            assert e.note.startswith("qdrift(")
    assert tplan.compressed_bytes() == jplan.compressed_bytes()
    assert tplan.meta["sod"] == jplan.meta["sod"]


def test_auto_qmode_margin_is_clear(auto_plans):
    """The measured drifts sit far from the budget (int8 about 0.006
    against 0.05, codebook above it), so both packages pick int8."""
    for fmt, (jplan, tplan) in auto_plans.items():
        for path, e in tplan.entries.items():
            assert e.qmode == jplan.entries[path].qmode == "int8", (fmt, path)
            drift = float(e.note.split("=")[1].split(";")[0])
            assert drift < 0.05 / 4


@pytest.mark.parametrize("density", [0.3, 0.85])
def test_plan_bytes_never_exceed_global_pack(weights, density):
    _, _, tcfg, tparams = weights
    tsc = sod.SoDConfig(mode="tiled_csc", density=density, min_dim=64)
    plan = planner.build_plan(tparams, tsc, cfg=tcfg, m_values=(32,))
    planned = sod.tree_weight_bytes(sod.sodify_params(tparams, tsc, plan=plan))
    global_ = sod.tree_weight_bytes(sod.sodify_params(tparams, tsc))
    assert planned["compressed"] <= global_["compressed"]
    if density == 0.85:
        assert any(e.mode == "dense" for e in plan.entries.values())
        assert planned["compressed"] < global_["compressed"]


def test_concrete_plan_packs_like_the_global_pack(weights):
    """A plan from concrete weights records the observed capacities: its
    packs are bit-equal to the global-config pack's."""
    _, _, tcfg, tparams = weights
    for fmt in SOD:
        _, tsc = _cfgs(fmt, qmode="int8")
        plan = planner.build_plan(tparams, tsc, cfg=tcfg, m_values=(32,))
        a = sod.sodify_params(tparams, tsc, plan=plan)
        b = sod.sodify_params(tparams, tsc)
        for la, lb in zip(a["layers"], b["layers"]):
            for g in ("attn", "mlp"):
                for n, wa in la[g].items():
                    for field in PACK_FIELDS[type(wa)]:
                        ta, tb = getattr(wa, field), getattr(lb[g][n], field)
                        assert (ta is None and tb is None) or torch.equal(ta, tb)


def test_plan_pack_abstract_parity(weights):
    _, _, tcfg, tparams = weights
    for fmt in SOD:
        for qmode in ("none", "codebook"):
            _, tsc = _cfgs(fmt, qmode=qmode)
            plan = planner.build_plan(planner._to_meta(tparams), tsc, cfg=tcfg,
                                      m_values=(32,))
            concrete = sod.sodify_params(tparams, tsc, plan=plan)
            abstract = sod.sodify_abstract(planner._to_meta(tparams), tsc, plan=plan)
            for lc, la in zip(concrete["layers"], abstract["layers"]):
                for g in ("attn", "mlp"):
                    for n, wc in lc[g].items():
                        wa = la[g][n]
                        assert type(wc) is type(wa)
                        if isinstance(wc, torch.Tensor):     # a dense fallback
                            assert (wc.shape, wc.dtype) == (wa.shape, wa.dtype)
                            continue
                        kc = autotune.key_str(registry.problem_key(wc, 32, "cpu"))
                        ka = autotune.key_str(registry.problem_key(wa, 32, "cpu"))
                        assert kc == ka
                        for field in PACK_FIELDS[type(wc)]:
                            tc, ta = getattr(wc, field), getattr(wa, field)
                            assert (tc is None) == (ta is None)
                            if tc is not None:
                                assert (tc.shape, tc.dtype) == (ta.shape, ta.dtype)


def test_mesh_is_not_ported(weights):
    """The planner's mesh pass, once missing here, now gives the reference's
    ``spmd`` entries (none on stacked leaves) and mesh key on (4, 2)."""
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro_torch.launch.mesh import AbstractMesh

    jcfg, jparams, tcfg, tparams = weights
    jsc, tsc = _cfgs("tiled_csc")
    jp = jplanner.build_plan(jparams, jsc, cfg=jcfg, m_values=(32, 2),
                             mesh=JAbstractMesh((4, 2), ("data", "model")))
    tp = planner.build_plan(tparams, tsc, cfg=tcfg, m_values=(32, 2),
                            mesh=AbstractMesh((4, 2), ("data", "model")))
    assert tp.mesh == jp.mesh == "data=4,model=2"
    assert {k: e.spmd for k, e in tp.entries.items()} == {
        k: e.spmd for k, e in jp.entries.items()}


def test_subplans_and_suffix_lookup(weights):
    _, _, tcfg, tparams = weights
    plan = planner.build_plan(tparams, _cfgs("tiled_csc")[1], cfg=tcfg, m_values=(32,))
    assert set(plan.subplans("mlp")) == {"w_gate", "w_up", "w_down"}
    assert plan.for_suffix("attn.wo") is plan.get(".blocks.attn.wo")
    assert plan.for_suffix("definitely.not.there") is None


# ---------------------------------------------------------------------------
# the draft tier's density
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt,spec_k,draft_qmode", [("tiled_csc", 2, None),
                                                    ("block_csr", 4, None),
                                                    ("tiled_csc", 4, "codebook")])
def test_choose_draft_density_matches_reference(weights, fmt, spec_k, draft_qmode):
    jcfg, jparams, tcfg, tparams = weights
    jsc, tsc = _cfgs(fmt)
    jd, jdiag = jplanner.choose_draft_density(jparams, jsc, spec_k=spec_k, cfg=jcfg,
                                              draft_qmode=draft_qmode)
    td, tdiag = planner.choose_draft_density(tparams, tsc, spec_k=spec_k, cfg=tcfg,
                                             draft_qmode=draft_qmode)
    assert td == jd and tdiag == jdiag


def test_build_draft_plan_matches_reference(weights):
    jcfg, jparams, tcfg, tparams = weights
    jsc, tsc = _cfgs("tiled_csc")
    jdc, jdp = jplanner.build_draft_plan(jparams, jsc, spec_k=2, cfg=jcfg,
                                         m_values=(16, 2))
    tdc, tdp = planner.build_draft_plan(tparams, tsc, spec_k=2, cfg=tcfg,
                                        m_values=(16, 2))
    assert tdc.density == jdc.density and tdc.mode == jdc.mode
    assert {p: _fields(e) for p, e in tdp.entries.items()} == {
        p: _fields(e) for p, e in jdp.entries.items()}
    assert tdp.meta["density_choice"] == jdp.meta["density_choice"]
    assert tdp.meta["tier"] == "draft" and tdp.meta["spec_k"] == 2


# ---------------------------------------------------------------------------
# N:M pruning
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m,axis", [(4, 8, 0), (2, 4, 1), (1, 8, 0)])
def test_nm_prune_matches_reference_ties_included(dtype, n, m, axis):
    """Magnitudes drawn from a few levels (and zeros, and both signs), so
    almost every group has ties: the stable ranks pick the reference's."""
    rng = np.random.default_rng(n * 10 + m)
    w = (rng.integers(-3, 4, size=(64, 48)) * 0.25).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    tw = to_torch(np.asarray(jw), "cpu")
    got = pruning.nm_prune(tw, n=n, m=m, axis=axis)
    want = jpruning.nm_prune(jw, n=n, m=m, axis=axis)
    np.testing.assert_array_equal(_tbits(got), _bits(want))
    assert got.dtype == tw.dtype


def test_nm_prune_weight_pads_k_as_the_reference():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((100, 64)).astype(np.float32)
    got = sod.prune_weight(torch.from_numpy(w), 0.5, "nm")
    want = jsod.prune_weight(jnp.asarray(w), 0.5, "nm")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cfg = sod.SoDConfig(mode="tiled_csc", density=0.5, prune_method="nm", min_dim=64)
    packed = sod.sodify_params({"layers": [{"mlp": {"w_down": torch.from_numpy(w)}}]},
                               cfg)["layers"][0]["mlp"]["w_down"]
    np.testing.assert_array_equal(packed.to_dense().numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# replay rules
# ---------------------------------------------------------------------------
def test_plan_dense_fallback_layers_are_still_pruned():
    w = torch.randn(128, 128, generator=torch.Generator().manual_seed(0))
    entry = PackPlan(mode="dense", shape=(128, 128), lead=(1, 1), density=0.4,
                     dtype="float32")
    plan = ModelPlan({".blocks.mlp.w_down": entry})
    tree = {"layers": [{"mlp": {"w_down": w}}]}
    cfg = sod.SoDConfig(mode="tiled_csc", density=0.4, min_dim=64)
    out = sod.sodify_params(tree, cfg, plan=plan)["layers"][0]["mlp"]["w_down"]
    assert isinstance(out, torch.Tensor)
    assert torch.equal(out, pruning.magnitude_prune(w, 0.4))
    raw = sod.sodify_params(tree, cfg, prune=False, plan=plan)["layers"][0]["mlp"]["w_down"]
    assert torch.equal(raw, w)


def test_plan_cap_truncation_warns():
    w = torch.zeros(128, 128)
    w[:32] = 1.0
    entry = PackPlan(mode="tiled_csc", shape=(128, 128), lead=(1, 1), density=1.0,
                     cap=8, dtype="float32")
    tree = {"layers": [{"mlp": {"w_down": w}}]}
    cfg = sod.SoDConfig(mode="tiled_csc", density=1.0, min_dim=64)
    with pytest.warns(UserWarning, match="truncated"):
        packed = sod.sodify_params(tree, cfg, plan=ModelPlan({".blocks.mlp.w_down": entry})
                                   )["layers"][0]["mlp"]["w_down"]
    assert packed.cap == 8
    ok = ModelPlan({".blocks.mlp.w_down": dataclasses.replace(entry, cap=32)})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        packed = sod.sodify_params(tree, cfg, plan=ok)["layers"][0]["mlp"]["w_down"]
    assert torch.equal(packed.to_dense(), w)


def test_warmup_plan_populates_cache_at_plan_keys(weights, tmp_path):
    _, _, tcfg, tparams = weights
    tsc = _cfgs("tiled_csc")[1]
    plan = planner.build_plan(tparams, tsc, cfg=tcfg, m_values=(16,))
    cache = autotune.TuningCache(tmp_path / "cache.json")
    stats = planner.warmup_plan(plan, (16, 2), backend="cpu", cache=cache)
    dense = sum(e.mode == "dense" for e in plan.entries.values())
    assert stats["tuned"] >= 2 and stats["skipped"] == dense
    packed = sod.sodify_params(tparams, tsc, plan=plan)
    for layer in packed["layers"]:
        for g in ("attn", "mlp"):
            for w in layer[g].values():
                if isinstance(w, torch.Tensor):
                    continue
                for m in (16, 2):
                    assert cache.get(registry.problem_key(w, m, "cpu")) is not None
    assert planner.warmup_plan(plan, (16, 2), backend="cpu", cache=cache)["tuned"] == 0
    warm = planner.build_plan(tparams, tsc, cfg=tcfg, cache=cache, m_values=(16,))
    assert all(e.note.startswith("tuned:torch_oracle") for e in warm.entries.values()
               if e.mode != "dense")


# ---------------------------------------------------------------------------
# the model under a plan, and the serve CLI
# ---------------------------------------------------------------------------
def test_planned_greedy_tokens_equal_the_reference(weights, tmp_path):
    """fp32 static serving of both packages under one plan (the reference's,
    replayed in the port): equal greedy tokens."""
    jcfg, jparams, tcfg, tparams = weights
    jsc, tsc = _cfgs("tiled_csc", qmode="int8")
    jcfg, tcfg = jcfg.with_(sod=jsc), tcfg.with_(sod=tsc)
    jplan = jplanner.build_plan(jparams, jsc, cfg=jcfg, m_values=(B * S, B))
    tplan = ModelPlan.load(jplan.save(tmp_path / "plan.json"))
    tokens = np.asarray(JData(jcfg, B, S, seed=0).batch(0)["tokens"])

    jmodel = JLM(jcfg)
    jp = jsod.sodify_params(jparams, jsc, plan=jplan)
    last, cache, pos0 = jserve.prefill_cache(jmodel, jp, {"tokens": jnp.asarray(tokens)},
                                             S + GEN, plan=jplan)
    decode = jax.jit(jsteps.make_decode_step(jmodel, plan=jplan))
    tok, want = jnp.argmax(last, axis=-1).reshape(B, 1), []
    for t in range(GEN):
        nxt, _, cache = decode(jp, cache, tok, jnp.asarray(pos0 + t, jnp.int32))
        tok = nxt.reshape(B, 1)
        want.append(np.asarray(nxt))

    tmodel = LM(tcfg)
    tp = sod.sodify_params(tparams, tsc, plan=tplan)
    with torch.inference_mode(), registry.record_dispatches() as log:
        last, cache, pos0 = serve.prefill_cache(tmodel, tp, to_torch(tokens, "cpu").long(),
                                                S + GEN, plan=tplan)
        decode = steps.make_decode_step(tmodel, plan=tplan)
        tok, got = last.argmax(dim=-1).reshape(B, 1), []
        for t in range(GEN):
            nxt, _, cache = decode(tp, cache, tok, pos0 + t)
            tok = nxt.reshape(B, 1)
            got.append(nxt.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert registry.dispatch_counts(log) == {"torch_oracle[prior]": 2 * 7 * (1 + GEN)}


SERVE = ["--reduced", "--sod", "tiled_csc", "--density", "0.3", "--batch", "2",
         "--prompt-len", "8", "--gen", "3", "--device", "cpu"]


def test_serve_plan_auto_then_replay(tmp_path):
    """``--plan auto --autotune --plan-json P`` then ``--plan P`` on the warm
    cache: no new measurement, the same packs' bytes and tokens."""
    tc, pj = str(tmp_path / "tc.json"), str(tmp_path / "plan.json")
    first = serve.main([*SERVE, "--plan", "auto", "--autotune", "--tuning-cache", tc,
                        "--plan-json", pj])
    plan = ModelPlan.load(pj)
    dense = sum(e.mode == "dense" for e in plan.entries.values())      # wk, wv
    layouts = len({e.layout_key() for e in plan.entries.values() if e.mode != "dense"})
    assert first["autotune"] == {"tuned": 2 * layouts, "cached": 0, "skipped": dense}
    assert first["plan_layers"] == 7 and first["plan_bytes"] > 0
    assert first["kernel_dispatch"] == {"torch_oracle[tuned]": 2 * (7 - dense) * (1 + 3)}
    replay = serve.main([*SERVE, "--plan", pj, "--autotune", "--tuning-cache", tc])
    assert replay["autotune"] == {"tuned": 0, "cached": 2 * layouts, "skipped": dense}
    assert replay["sample"] == first["sample"]
    assert replay["weight_bytes"] == first["weight_bytes"]
    assert plan.entries == planner.load_or_build(pj, None, None).entries


def test_serve_quantize_auto_and_planner_draft(tmp_path):
    summary = serve.main([*SERVE, "--plan", "auto", "--quantize", "auto"])
    assert summary["plan_layers"] == 7 and summary["logits_finite"]
    plain = serve.main(SERVE)
    assert summary["weight_bytes"]["compressed"] < plain["weight_bytes"]["compressed"]
    eng = serve.main(["--reduced", "--engine", "--device", "cpu", "--requests", "3",
                      "--prompt-len", "12", "--gen", "4", "--max-slots", "2",
                      "--page-size", "4", "--sod", "tiled_csc", "--plan", "auto",
                      "--spec-decode", "2"])
    choice = eng["draft_density_choice"]
    assert eng["draft_density"] == choice["chosen"] in planner.DRAFT_DENSITY_LADDER
    assert choice["spec_k"] == 2 and eng["completed"] == 3


@pytest.mark.parametrize("argv,message", [
    (["--plan", "auto"], "--plan requires Sparse-on-Dense packing"),
    (["--sod", "tiled_csc", "--quantize", "auto", "--plan", "x.json"],
     "--quantize auto needs the planner"),
])
def test_serve_plan_flag_errors_as_reference(argv, message, capsys):
    for main in (jserve.main, serve.main):
        with pytest.raises(SystemExit) as exc:
            main(["--reduced", *argv])
        assert exc.value.code == 2
        assert message in capsys.readouterr().err
