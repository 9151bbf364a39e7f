"""The recurrent families in the port against the JAX package.

zamba2-2.7b (the hybrid: Mamba2 groups and one shared attention + MLP
block) and xlstm-125m (groups of mLSTM blocks and one sLSTM block) at their
reduced sizes, in float32 — the hybrid cut to one group of 6 blocks where
two groups are not needed.  Weights come from the JAX model
(``repro.models.model.build_model``) through ``params_from_numpy``; each
package prunes and packs its own copy.

Tolerances: logits atol 1e-4 / rtol 1e-4, losses rtol 1e-5, gradients
atol 1e-6 / rtol 1e-4, but the xLSTM's whole-model gradients atol 3e-5:
its embedding's gradient (up to 3.2, a sum over the batch's positions of
gradients through exponential gates) carries float32 reordering of up to
1e-5, where each block alone holds 1e-6 (``tests/test_torch_recurrent.py``);
greedy tokens, packs and plan entries exactly; the
engine's tokens equal ``static_generate``'s bit for bit inside the port,
and the JAX engine's on the same weights.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import plan as jplan_mod
from repro.core import sod as jsod
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import cache as jcache
from repro.models import model as jmodel_mod
from repro.models import transformer as jtransformer
from repro.runtime import planner as jplanner
from repro.serving import Engine as JEngine
from repro_torch import configs
from repro_torch.core import sod
from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.tree import PACKED_FIELDS, leaves_with_path
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import autotune
from repro_torch.launch import serve, steps, train
from repro_torch.models import cache as cache_mod
from repro_torch.models import transformer
from repro_torch.models.model import LM, build_model
from repro_torch.runtime import planner
from repro_torch.serving import Engine, poisson_trace, static_generate

B, S, GEN = 2, 16, 4
ATOL = RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
GRAD_ATOL_XLSTM = 3e-5
ARCHS = ("zamba2-2.7b", "xlstm-125m")
PACKED = (TiledCSC, BlockCSR)
PLAN_FIELDS = ("mode", "shape", "lead", "density", "prune_method", "tile", "br",
               "cap", "bcap", "dtype", "qmode", "impl", "dispatch_params")
SOD = {"tiled_csc": dict(mode="tiled_csc", density=0.3, min_dim=64),
       "block_csr": dict(mode="block_csr", density=0.3, min_dim=64,
                         prune_method="block")}


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
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "jax_tuning_cache.json"))
    autotune.set_cache(None)
    yield
    autotune.set_cache(None)


def _configs(arch: str, mode: str | None = None, groups: int = 1):
    """The reduced configs of both packages in float32, cut to ``groups``
    layer groups (the hybrid's of 6 Mamba2 blocks, the xLSTM's of 3 mLSTM
    blocks and 1 sLSTM block)."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).with_(dtype="float32")
    tcfg = configs.reduced(configs.get_config(arch)).with_(dtype="float32")
    period = jcfg.hybrid_attn_every or jcfg.slstm_every
    jcfg, tcfg = jcfg.with_(n_layers=groups * period), tcfg.with_(n_layers=groups * period)
    if mode is not None:
        jcfg = jcfg.with_(sod=jsod.SoDConfig(**SOD[mode]))
        tcfg = tcfg.with_(sod=sod.SoDConfig(**SOD[mode]))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _reference_init(arch: str, groups: int = 1):
    """The JAX model's float32 weights of the reduced ``arch`` as numpy."""
    jcfg, _ = _configs(arch, groups=groups)
    return jax.tree_util.tree_map(
        np.asarray, jmodel_mod.build_model(jcfg).init(jax.random.PRNGKey(0)))


_TOKEN = re.compile(r"\['([^']+)'\]|\[(\d+)\]|\.(\w+)")


def _ref_at(tree, path: str):
    """The reference's value at a port leaf path: the port's list indices
    (``['mamba_blocks'][g][j]``) are the reference's leading stack dims."""
    index = []
    for key, i, attr in _TOKEN.findall(path):
        if i:
            index.append(int(i))
        elif key:
            tree = tree[key]
        else:
            tree = getattr(tree, attr)
    return np.asarray(tree)[tuple(index)]


def _assert_pack_equal(t, j, lead_index=()):
    assert type(t).__name__ == type(j).__name__
    assert t.shape == tuple(j.shape) and t.tile == tuple(j.tile)
    for field in PACKED_FIELDS[type(t)]:
        a, b = getattr(t, field), getattr(j, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b)[lead_index],
                                          err_msg=field)


def _ref_node(tree, path: str):
    """The node of a reference tree at a port path of the same layout (the
    decode caches: list and tuple indices index the node itself)."""
    for key, i, attr in _TOKEN.findall(path):
        tree = tree[int(i)] if i else tree[key] if key else getattr(tree, attr)
    return np.asarray(tree)


def _packed_items(tree, keys=(), index=()):
    """``(dict keys, list indices, packed leaf)`` of every packed leaf."""
    if isinstance(tree, PACKED):
        yield keys, index, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _packed_items(v, keys + (k,), index)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _packed_items(v, keys, index + (i,))


def _assert_packs_equal(tparams, jparams) -> int:
    """Every packed leaf of the port's tree equals the reference's stacked
    pack at its stack index; returns how many were compared."""
    n = 0
    for keys, index, t in _packed_items(tparams):
        assert t.lead == ()
        _assert_pack_equal(t, functools.reduce(lambda node, k: node[k], keys, jparams),
                           index)
        n += 1
    return n


# ---------------------------------------------------------------------------
# configs, counts, weights carried across
# ---------------------------------------------------------------------------
def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "sod"}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_specs_and_counts_equal(arch):
    jfull, tfull = jconfigs.get_config(arch), configs.get_config(arch)
    assert _fields(tfull) == _fields(jfull)
    assert _fields(configs.reduced(tfull)) == _fields(jconfigs.reduced(jfull))
    assert arch in configs.ARCH_NAMES
    spec, jspec = ((transformer.mamba_spec, jtransformer.mamba_spec)
                   if tfull.family == "hybrid" else
                   (transformer.xlstm_spec, jtransformer.xlstm_spec))
    for jc, tc in ((jfull, tfull), (jconfigs.reduced(jfull), configs.reduced(tfull))):
        assert dataclasses.asdict(spec(tc)) == dataclasses.asdict(jspec(jc))
    assert LM(tfull).param_count() == jmodel_mod.LM(jfull).param_count()
    assert round(tfull.param_count() / 1e9, 2) == {"zamba2-2.7b": 2.42,
                                                   "xlstm-125m": 0.2}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carried_across(arch):
    """Every leaf of every block is the reference's stack slice (the
    hybrid's ``shared_attn`` unstacked); the port's init draws the same tree
    of shapes and dtypes."""
    jcfg, tcfg = _configs(arch, groups=2)
    np_params = _reference_init(arch, 2)
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    assert len(tparams["mamba_blocks" if tcfg.family == "hybrid" else "mlstm_blocks"]) == 2
    assert set(tparams) == set(np_params)
    for path, leaf in leaves_with_path(tparams):
        np.testing.assert_array_equal(leaf.numpy(), _ref_at(np_params, path), err_msg=path)
    assert LM(tcfg).param_count(tparams) == jmodel_mod.LM(jcfg).param_count(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    drawn = LM(tcfg.with_(dtype="bfloat16")).init(torch.Generator().manual_seed(0), "cpu")
    jdrawn = jax.eval_shape(jmodel_mod.build_model(jcfg.with_(dtype="bfloat16")).init,
                            jax.random.PRNGKey(1))
    for path, leaf in leaves_with_path(drawn):
        want = functools.reduce(lambda n, k: n[k], [k for k, _, _ in _TOKEN.findall(path)
                                                     if k], jdrawn)
        lead = sum(1 for _, i, _ in _TOKEN.findall(path) if i)
        assert tuple(leaf.shape) == want.shape[lead:], path
        assert str(leaf.dtype).split(".")[-1] == str(want.dtype), path


# ---------------------------------------------------------------------------
# the planner and packing
# ---------------------------------------------------------------------------
CASES = [("zamba2-2.7b", "tiled_csc"), ("xlstm-125m", "tiled_csc")]


@pytest.mark.parametrize("arch,mode", CASES)
def test_packs_and_plan_entries_match_reference(arch, mode):
    """Global-config packing gives the reference's buffers (one shared cap
    a stack); the planner's entries equal the reference's — paths, leads
    ((G, P) for ``.mamba_blocks``, none for ``.shared_attn``), caps — and a
    plan the port writes replays in the reference to the port's packs."""
    jcfg, tcfg = _configs(arch, mode)
    np_params = _reference_init(arch)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    packed = sod.sodify_params(tparams, tcfg.sod)
    n = _assert_packs_equal(packed, jsod.sodify_params(jparams, jcfg.sod))
    assert n == {"zamba2-2.7b": 6 * 3 + 7 + 1, "xlstm-125m": 3 * 5 + 1}[arch]

    tplan = planner.build_plan(tparams, tcfg.sod, cfg=tcfg, m_values=(B * S, B))
    jplan = jplanner.build_plan(jparams, jcfg.sod, cfg=jcfg, m_values=(B * S, B))
    fields = lambda e: {f: getattr(e, f) for f in PLAN_FIELDS}  # noqa: E731
    assert {p: fields(e) for p, e in tplan.entries.items()} == {
        p: fields(e) for p, e in jplan.entries.items()}
    leads = {p: e.lead for p, e in tplan.entries.items()}
    if arch == "zamba2-2.7b":
        assert leads[".mamba_blocks.mamba.w_z"] == (1, 6)
        assert leads[".shared_attn.attn.wq"] == ()
        assert ".mamba_blocks.mamba.w_b" not in leads     # stays dense, as the reference
    else:
        assert leads[".mlstm_blocks.cell.wq"] == (1, 3)
        assert not any(p.startswith(".slstm_blocks") for p in leads)
    replayed = jplan_mod.ModelPlan.from_json(tplan.to_json())
    assert _assert_packs_equal(sod.sodify_params(tparams, tcfg.sod, plan=tplan),
                               jsod.sodify_params(jparams, jcfg.sod, plan=replayed)) == n


def test_plan_leaves_of_the_slstm_stack_keep_its_lead():
    """The xLSTM's sLSTM stack has a lead of its groups and r_gates its
    heads after it, as the reference's stacked leaves."""
    _, tcfg = _configs("xlstm-125m", groups=2)
    params = LM(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    leads = {p: lead for p, _, lead in sod.plan_leaves(params)}
    assert leads[".slstm_blocks.cell.w_out"] == (2,)
    assert leads[".slstm_blocks.cell.r_gates"] == (2, tcfg.n_heads)
    assert leads[".mlstm_blocks.cell.w_up"] == (2, 3) and leads[".head"] == ()


# ---------------------------------------------------------------------------
# the forward, serving, loss and gradients against the reference
# ---------------------------------------------------------------------------
def _serve_both(arch: str, mode: str | None):
    jcfg, tcfg = _configs(arch, mode)
    np_params = _reference_init(arch)
    tokens = np.asarray(JData(jcfg, B, S, seed=0).batch(0)["tokens"])
    jmodel = jmodel_mod.build_model(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, tcfg, device="cpu")
    if mode is not None:
        jp, tp = jsod.sodify_params(jp, jcfg.sod), sod.sodify_params(tp, tcfg.sod)
    jout = {"apply": np.asarray(jmodel.apply(jp, {"tokens": jnp.asarray(tokens)})[0])}
    last, cache, pos0 = jserve.prefill_cache(jmodel, jp, {"tokens": jnp.asarray(tokens)},
                                             S + GEN)
    jout.update(prefill=np.asarray(last), logits=[], tokens=[])
    decode = jax.jit(jsteps.make_decode_step(jmodel))
    tok = jnp.argmax(last, axis=-1).reshape(B, 1)
    for t in range(GEN):
        nxt, logits, cache = decode(jp, cache, tok, jnp.asarray(pos0 + t, jnp.int32))
        tok = nxt.reshape(B, 1)
        jout["logits"].append(np.asarray(logits))
        jout["tokens"].append(np.asarray(nxt))

    tmodel = build_model(tcfg)
    ttokens = to_torch(tokens, "cpu").long()
    with torch.inference_mode():
        tout = {"apply": tmodel.apply(tp, ttokens)[0].numpy()}
        last, cache, pos0 = serve.prefill_cache(tmodel, tp, ttokens, S + GEN)
        tout.update(prefill=last.numpy(), logits=[], tokens=[])
        decode = steps.make_decode_step(tmodel)
        tok = last.argmax(dim=-1).reshape(B, 1)
        for t in range(GEN):
            nxt, logits, cache = decode(tp, cache, tok, pos0 + t)
            tok = nxt.reshape(B, 1)
            tout["logits"].append(logits.numpy())
            tout["tokens"].append(nxt.numpy())
    return {"jax": jout, "torch": tout}


SERVE_CASES = [(a, m) for a in ARCHS for m in (None, "tiled_csc")]


@pytest.fixture(scope="module", params=[(a, "tiled_csc") for a in ARCHS],
                ids=lambda c: f"{c[0]}-{c[1]}")
def runs(request):
    return _serve_both(*request.param)


def test_apply_logits_match(runs):
    """The full forward (the chunked SSD / chunkwise mLSTM)."""
    np.testing.assert_allclose(runs["torch"]["apply"], runs["jax"]["apply"], atol=ATOL,
                               rtol=RTOL)


def test_stepped_prefill_and_decode_logits_match(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_allclose(t["prefill"], j["prefill"], atol=ATOL, rtol=RTOL)
    for lt, lj in zip(t["logits"], j["logits"], strict=True):
        np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=RTOL)
    assert np.isfinite(t["prefill"]).all()


def test_greedy_tokens_equal(runs):
    np.testing.assert_array_equal(np.stack(runs["torch"]["tokens"]),
                                  np.stack(runs["jax"]["tokens"]))


def test_chunked_forward_equals_the_stepped_prefill(runs):
    """The port's full forward at the last prompt position against its own
    prompt replayed through the decode step."""
    np.testing.assert_allclose(runs["torch"]["apply"][:, -1], runs["torch"]["prefill"],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch,mode", [("zamba2-2.7b", "tiled_csc"), ("xlstm-125m", None)])
def test_loss_and_gradients_match(arch, mode):
    jcfg, tcfg = _configs(arch, mode)
    np_params = _reference_init(arch)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, tcfg, device="cpu")
    if mode is not None:
        jp, tp = jsod.sodify_params(jp, jcfg.sod), sod.sodify_params(tp, tcfg.sod)
    batch = JData(jcfg, B, 32, seed=0).batch(0)
    jloss, jmet, jg = jax.jit(jsteps.make_loss_and_grads(
        jmodel_mod.build_model(jcfg)))(jp, batch)
    tbatch = {k: to_torch(np.asarray(v), "cpu").long() for k, v in batch.items()}
    tloss, tmet, tg = steps.make_loss_and_grads(LM(tcfg))(tp, tbatch)
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=LOSS_RTOL,
                                   err_msg=key)
    assert float(tmet["aux"]) == 0.0
    jg = jax.tree_util.tree_map(
        lambda g: None if g.dtype == jax.dtypes.float0 else np.asarray(g), jg)
    checked = 0
    for path, leaf in leaves_with_path(tg):
        np.testing.assert_allclose(
            leaf.float().numpy(), _ref_at(jg, path), rtol=GRAD_RTOL, err_msg=path,
            atol=GRAD_ATOL_XLSTM if tcfg.family == "ssm" else GRAD_ATOL)
        checked += 1
    assert checked > 40


# ---------------------------------------------------------------------------
# cache geometry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_and_init_equal_the_references(arch):
    jcfg, tcfg = _configs(arch, groups=2)
    spec = LM(tcfg).cache_spec()
    jspec = jmodel_mod.LM(jcfg).cache_spec()
    assert [(p, a.batch, a.seq) for p, a in _spec_leaves(spec)] == [
        (p, a.batch, a.seq) for p, a in _spec_leaves_ref(jspec)]
    cache = LM(tcfg).init_cache(3, 8, "cpu")
    jc = jmodel_mod.LM(jcfg).init_cache(3, 8)
    assert len(list(leaves_with_path(cache))) == len(jax.tree_util.tree_leaves(jc))
    for path, leaf in leaves_with_path(cache):
        np.testing.assert_array_equal(leaf.numpy(), _ref_node(jc, path), err_msg=path)


def _spec_leaves(spec, path=""):
    if isinstance(spec, cache_mod.CacheAxes):
        yield path, spec
    elif isinstance(spec, dict):
        for k in sorted(spec):
            yield from _spec_leaves(spec[k], f"{path}['{k}']")
    else:
        for i, v in enumerate(spec):
            yield from _spec_leaves(v, f"{path}[{i}]")


def _spec_leaves_ref(spec, path=""):
    if isinstance(spec, jcache.CacheAxes):
        yield path, spec
    elif isinstance(spec, dict):
        for k in sorted(spec):
            yield from _spec_leaves_ref(spec[k], f"{path}['{k}']")
    else:
        for i, v in enumerate(spec):
            yield from _spec_leaves_ref(v, f"{path}[{i}]")


def test_grow_cache_pads_only_sequence_axes():
    """As ``tests/test_serving_engine.py``: the hybrid's KV grows, its
    recurrent state does not; and a conv leaf whose batch equals the prompt
    length is not grown (the old shape heuristic's fault)."""
    _, cfg = _configs("zamba2-2.7b", groups=2)
    model = LM(cfg)
    cache = model.init_cache(3, 8, "cpu")
    grown = model.grow_cache(cache, 12)
    assert grown["k"].shape[-3] == 12 and grown["v"].shape[-3] == 12
    assert grown["ssm"].shape == cache["ssm"].shape
    assert {k: t.shape for k, t in grown["conv"].items()} == {
        k: t.shape for k, t in cache["conv"].items()}
    assert model.grow_cache(grown, 10)["k"].shape == grown["k"].shape
    s = cfg.ssm_conv - 1                      # batch == a conv leaf's dim
    cache = model.init_cache(s, s, "cpu")
    grown = model.grow_cache(cache, s + 4)
    assert grown["conv"]["x"].shape == cache["conv"]["x"].shape
    assert grown["k"].shape[-3] == s + 4
    xcache = LM(_configs("xlstm-125m")[1]).init_cache(2, 4, "cpu")
    xgrown = LM(_configs("xlstm-125m")[1]).grow_cache(xcache, 16)
    assert all(a.shape == b.shape for (_, a), (_, b) in
               zip(leaves_with_path(xgrown), leaves_with_path(xcache)))


@pytest.mark.parametrize("arch", ARCHS)
def test_write_slot_matches_the_reference(arch):
    """A batch-1 cache written into slot 2 of a batch-4 one, a shorter KV
    prefix included, gives the reference's cache."""
    jcfg, tcfg = _configs(arch)
    tmodel, jmodel = LM(tcfg), jmodel_mod.LM(jcfg)
    rng = np.random.default_rng(7)
    big = {p: rng.standard_normal(t.shape).astype(np.float32)
           for p, t in leaves_with_path(tmodel.init_cache(4, 10, "cpu"))}
    sub = {p: rng.standard_normal(t.shape).astype(np.float32)
           for p, t in leaves_with_path(tmodel.init_cache(1, 6, "cpu"))}

    def fill(cache, values):
        for p, t in leaves_with_path(cache):
            t.copy_(torch.from_numpy(values[p]))
        return cache

    got = cache_mod.write_slot(fill(tmodel.init_cache(4, 10, "cpu"), big),
                               fill(tmodel.init_cache(1, 6, "cpu"), sub),
                               tmodel.cache_spec(), 2)

    def as_ref(values, batch, max_len):
        tree = jmodel.init_cache(batch, max_len)
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [jnp.asarray(values[jax.tree_util.keystr(p)]) for p, _ in leaves])

    want = jcache.write_slot(as_ref(big, 4, 10), as_ref(sub, 1, 6),
                             jmodel.cache_spec(), 2)
    for path, leaf in leaves_with_path(got):
        np.testing.assert_array_equal(leaf.numpy(), _ref_node(want, path), err_msg=path)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
REFUSED = [dict(prefill_chunk=8), dict(preemption=True),
           dict(prefill_chunk=8, prefix_sharing=True),
           dict(prefill_chunk=8, prefix_sharing=True, prefix_cache_budget=1 << 20),
           dict(spec_k=2)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_model_refuse_paged_features(arch):
    """The reference's refusals: the paged-KV scheduler features raise
    ``ValueError`` in the engine, and the paged model methods raise."""
    _, tcfg = _configs(arch)
    model = LM(tcfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    for kw in REFUSED:
        kw = {**kw, **({"draft_params": params} if "spec_k" in kw else {})}
        with pytest.raises(ValueError, match="O\\(1\\) recurrent state per slot"):
            Engine(model, params, max_slots=2, max_len=16, **kw)
    eng = Engine(model, params, max_slots=2, max_len=16)
    assert not eng.paged and not hasattr(eng, "pool")
    with pytest.raises(ValueError, match="only attention-family KV caches are paged"):
        model.init_paged_pool(4, 4, "cpu")
    for call, msg in ((model.paged_decode_step, "no paged decode path"),
                      (model.prefill_chunk, "recurrent prompts replay"),
                      (model.verify_chunk, "needs the paged-KV cache")):
        with pytest.raises(ValueError, match=msg):
            call(params, None, None, None, None, None)


def test_families_admitted_and_frontends_refused():
    """Every family of the reference is admitted and has batches (the VLM's
    text after its patches, audio's a codebook stream each); the frontends
    are refused by the engine only (``tests/test_torch_frontend_family.py``)."""
    families = set()
    for arch in configs.ARCH_NAMES:
        cfg = configs.reduced(configs.get_config(arch))
        transformer.check_supported(cfg)
        batch = SyntheticLMData(cfg, 2, 24).batch(0)
        text = 24 - cfg.n_patches if cfg.family == "vlm" else 24
        lead = (2, text) + ((cfg.n_codebooks,) if cfg.family == "audio" else ())
        assert batch["tokens"].shape == batch["targets"].shape == lead, arch
        assert ("patch_embeds" in batch) == (cfg.family == "vlm"), arch
        families.add(cfg.family)
    assert families == set(transformer.FAMILIES)
    with pytest.raises(NotImplementedError):
        transformer.check_supported(configs.get_config("llama3.2-1b").with_(family="cnn"))


@pytest.mark.parametrize("arch,mode", SERVE_CASES)
def test_engine_equals_static_generate_and_the_reference_engine(arch, mode):
    """A ragged trace (staggered arrivals, mixed lengths) through the slot
    engine: every request's tokens equal the port's ``static_generate`` bit
    for bit, and the JAX engine's on the same weights (each package packs
    its own byte-equal copy)."""
    jcfg, tcfg = _configs(arch, mode)
    np_params = _reference_init(arch)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, tcfg, device="cpu")
    if mode is not None:
        jp, tp = jsod.sodify_params(jp, jcfg.sod), sod.sodify_params(tp, tcfg.sod)
    trace = poisson_trace(4, 0.7, max_prompt=10, max_new=5, vocab=tcfg.vocab, seed=3)
    assert len({r.arrival for r in trace}) > 1 and len({len(r.tokens) for r in trace}) > 1
    model = LM(tcfg)
    with torch.inference_mode():
        res = Engine(model, tp, max_slots=3, max_len=32).run(trace)
        assert res["stats"]["completed"] == len(trace) and res["stats"]["logits_finite"]
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, tp, req), req.rid
    jres = JEngine(jmodel_mod.build_model(jcfg), jp, max_slots=3, max_len=32).run(trace)
    assert res["tokens"] == jres["tokens"]


# ---------------------------------------------------------------------------
# the serve and train entry points on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_and_train_on_the_cpu(arch, tmp_path):
    base = ["--arch", arch, "--reduced", "--sod", "tiled_csc", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "3"]
    static = serve.main(base)
    assert static["logits_finite"] and len(static["generated_ids"][0]) == 3
    assert static["kernel_dispatch"] and static["kernel_launches"] == {
        "sod_matmul": 0, "block_matmul": 0}
    eng = serve.main(base + ["--engine", "--requests", "3"])
    assert eng["completed"] == 3 and eng["page_size"] is None and eng["logits_finite"]
    with pytest.raises(ValueError, match="paged-KV scheduler features"):
        serve.main(base + ["--engine", "--requests", "2", "--prefill-chunk", "4"])
    out = train.main(["--arch", arch, "--reduced", "--sod", "tiled_csc", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "32", "--ckpt-dir",
                      str(tmp_path / "ck"), "--log-every", "1000"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"] + out["grad_norms"]))
