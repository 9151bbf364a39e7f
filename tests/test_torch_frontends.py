"""The VLM and audio frontends of the port against the JAX package.

pixtral-12b (patch embeddings projected by a dense ``patch_proj`` and put
before the text) and musicgen-medium (4 codebook streams: summed
embeddings, one untied head over every codebook) at their reduced sizes,
in float32.  Weights come from the JAX model
(``repro.models.model.build_model``) through ``params_from_numpy``; each
package prunes and packs its own copy.

Tolerances: ``embed_inputs`` and ``project_logits`` atol / rtol 1e-5; the
decode at the prompt's true end against the full forward atol / rtol
1e-4; configs, counts, weights, packs, plan entries and batch shapes
exactly.
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
from repro.models import model as jmodel_mod
from repro.models import transformer as jtransformer
from repro.runtime import planner as jplanner
from repro_torch import configs
from repro_torch.core import sod
from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.tree import PACKED_FIELDS, leaves_with_path
from repro_torch.data.pipeline import SyntheticLMData, to_device
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import autotune
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.model import LM
from repro_torch.runtime import planner

B, S = 2, 32                    # pixtral's S counts its 16 patches
ATOL = RTOL = 1e-5
DECODE_ATOL = DECODE_RTOL = 1e-4
ARCHS = ("pixtral-12b", "musicgen-medium")
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


def _configs(arch: str, mode: str | None = None):
    """The reduced configs of both packages in float32."""
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
    return jax.tree_util.tree_map(
        np.asarray, jmodel_mod.build_model(jcfg).init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference_batch(arch: str, seq: int = S):
    return {k: np.asarray(v) for k, v in JData(_configs(arch)[0], B, seq,
                                                seed=0).batch(0).items()}


_TOKEN = re.compile(r"\['([^']+)'\]|\[(\d+)\]|\.(\w+)")


def _ref_at(tree, path: str):
    """The reference's value at a port leaf path: the port's list indices
    (``['layers'][l]``) are the reference's leading (G, P) stack dims."""
    index = []
    for key, i, attr in _TOKEN.findall(path):
        if i:
            index.append(int(i))
        elif key:
            tree = tree["blocks" if key == "layers" else key]
        else:
            tree = getattr(tree, attr)
    return np.asarray(tree)[(index[0], 0, *index[1:]) if index else ()]


def _both_params(arch: str, mode: str | None = None):
    """(reference params as jnp, port params on the CPU), packed under
    ``mode`` by each package."""
    jcfg, tcfg = _configs(arch, mode)
    np_params = _reference_init(arch)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, tcfg, device="cpu")
    if mode is not None:
        jp, tp = jsod.sodify_params(jp, jcfg.sod), sod.sodify_params(tp, tcfg.sod)
    return jp, tp


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "sod"}


# ---------------------------------------------------------------------------
# configs, counts, weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_counts_equal(arch):
    """The port's config is the reference's field for field, at full size
    and reduced, and counts the reference's parameters, which
    ``tests/test_models_smoke.py`` bills as 12.3 and 1.82 B within 15 %."""
    jfull, tfull = jconfigs.get_config(arch), configs.get_config(arch)
    assert _fields(tfull) == _fields(jfull)
    assert _fields(configs.reduced(tfull)) == _fields(jconfigs.reduced(jfull))
    assert arch in configs.ARCH_NAMES
    transformer.check_supported(tfull)
    assert LM(tfull).param_count() == jmodel_mod.LM(jfull).param_count()
    billed = {"pixtral-12b": 12.3, "musicgen-medium": 1.82}[arch]
    assert abs(tfull.param_count() / 1e9 - billed) / billed < 0.15


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carried_across_and_drawn_alike(arch):
    """Every leaf carried across is the reference's (the audio ``embed``
    stack and the VLM's ``patch_proj`` among them); the port's own init
    draws the reference's tree of shapes and dtypes, in bf16 too."""
    jcfg, tcfg = _configs(arch)
    np_params = _reference_init(arch)
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    assert set(tparams) - {"layers"} == set(np_params) - {"blocks"}
    extra = {"pixtral-12b": "patch_proj", "musicgen-medium": "head"}[arch]
    assert extra in tparams
    for path, leaf in leaves_with_path(tparams):
        np.testing.assert_array_equal(leaf.numpy(), _ref_at(np_params, path), err_msg=path)
    if arch == "musicgen-medium":
        assert tuple(tparams["embed"].shape) == (4, tcfg.padded_vocab, tcfg.d_model)
        assert tuple(tparams["head"].shape) == (tcfg.d_model, 4 * tcfg.padded_vocab)
    assert LM(tcfg).param_count(tparams) == jmodel_mod.LM(jcfg).param_count(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    bf16 = tcfg.with_(dtype="bfloat16")
    drawn = LM(bf16).init(torch.Generator().manual_seed(0), "cpu")
    want = jax.eval_shape(jmodel_mod.build_model(jcfg.with_(dtype="bfloat16")).init,
                          jax.random.PRNGKey(1))
    assert list(drawn)[:len(set(drawn) - {"layers"})] == [
        k for k in ("embed", "final_norm", "head", "patch_proj") if k in drawn]
    for path, leaf in leaves_with_path(drawn):
        ref = _ref_at(want, path) if "layers" not in path else None
        if ref is None:
            keys = [k for k, _, _ in _TOKEN.findall(path) if k][1:]
            ref = functools.reduce(lambda n, k: n[k], keys, want["blocks"])
            ref = jax.ShapeDtypeStruct(ref.shape[2:], ref.dtype)
        assert tuple(leaf.shape) == tuple(ref.shape), path
        assert str(leaf.dtype).split(".")[-1] == str(ref.dtype), path


# ---------------------------------------------------------------------------
# the frontends
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,with_patches", [("pixtral-12b", True),
                                                ("pixtral-12b", False),
                                                ("musicgen-medium", False)])
def test_embed_inputs_matches_reference(arch, with_patches):
    """The audio sum of codebook embeddings, and the VLM's projected patch
    prefix before its text (or the text alone without patches)."""
    jcfg, tcfg = _configs(arch)
    jp, tp = _both_params(arch)
    batch = _reference_batch(arch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if k != "targets" and (with_patches or k != "patch_embeds")}
    want = np.asarray(jtransformer.embed_inputs(jp, jbatch, jcfg))
    tb = to_device(batch, "cpu")
    got = transformer.embed_inputs(tp, tb["tokens"], tcfg,
                                   tb.get("patch_embeds") if with_patches else None)
    n_text = batch["tokens"].shape[1]
    assert tuple(got.shape) == want.shape == (
        B, n_text + (tcfg.n_patches if with_patches else 0), tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", [None, "tiled_csc"])
@pytest.mark.parametrize("arch", ARCHS)
def test_project_logits_matches_reference(arch, mode):
    """Final norm and head: pixtral's untied head, musicgen's over every
    codebook read as (..., C, V) (the codebook the slower index); packed,
    the head runs the Sparse-on-Dense path with float32 out."""
    jcfg, tcfg = _configs(arch, mode)
    jp, tp = _both_params(arch, mode)
    x = np.random.default_rng(3).standard_normal((B, 5, tcfg.d_model)).astype(np.float32)
    want = np.asarray(jtransformer.project_logits(jp, jnp.asarray(x), jcfg))
    got = transformer.project_logits(tp, to_torch(x, "cpu"), tcfg)
    shape = (B, 5) + ((4, tcfg.padded_vocab) if arch == "musicgen-medium"
                      else (tcfg.padded_vocab,))
    assert tuple(got.shape) == want.shape == shape and got.dtype == torch.float32
    assert isinstance(tp["head"], TiledCSC) == (mode is not None)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    if arch == "musicgen-medium":       # codebook c is the head's columns c·V..(c+1)·V
        h = transformer.layers.rms_norm(to_torch(x, "cpu"), tp["final_norm"], tcfg.norm_eps)
        flat = sod.apply(h, tp["head"], out_dtype=torch.float32)
        torch.testing.assert_close(got, flat.reshape(shape), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# packing and the planner
# ---------------------------------------------------------------------------
def _assert_pack_equal(t, j, index=()):
    assert type(t).__name__ == type(j).__name__
    assert t.shape == tuple(j.shape) and t.tile == tuple(j.tile)
    for field in PACKED_FIELDS[type(t)]:
        a, b = getattr(t, field), getattr(j, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b)[index], err_msg=field)


def _packed_items(tree, keys=(), index=()):
    """``(dict keys, list indices, packed leaf)`` of every packed leaf."""
    if isinstance(tree, (TiledCSC, BlockCSR)):
        yield keys, index, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _packed_items(v, keys + (k,), index)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _packed_items(v, keys, index + (i,))


def _assert_packs_equal(tparams, jparams) -> int:
    """Every packed leaf of the port's tree equals the reference's stacked
    pack at its layer's (G, P) index; returns how many were compared."""
    n = 0
    for keys, index, t in _packed_items(tparams):
        node = functools.reduce(lambda tree, k: tree["blocks" if k == "layers" else k],
                                keys, jparams)
        _assert_pack_equal(t, node, (index[0], 0) if index else ())
        n += 1
    return n


@pytest.mark.parametrize("mode", ["tiled_csc", "block_csr"])
@pytest.mark.parametrize("arch", ARCHS)
def test_packs_and_plan_entries_match_reference(arch, mode):
    """Global-config packing gives the reference's buffers; the planner's
    entries equal the reference's (the head's, and none for
    ``patch_proj`` or the audio ``embed`` stack), and a plan of the port
    replays in the reference to the port's packs."""
    jcfg, tcfg = _configs(arch, mode)
    np_params = _reference_init(arch)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    packed = sod.sodify_params(tparams, tcfg.sod)
    assert _assert_packs_equal(packed, jsod.sodify_params(jparams, jcfg.sod)) == 2 * 7 + 1
    assert not isinstance(packed["embed"], (TiledCSC, BlockCSR))
    assert not isinstance(packed.get("patch_proj"), (TiledCSC, BlockCSR))
    m_values = (B * S, B)
    tplan = planner.build_plan(tparams, tcfg.sod, cfg=tcfg, m_values=m_values)
    jplan = jplanner.build_plan(jparams, jcfg.sod, cfg=jcfg, m_values=m_values)
    fields = lambda e: {f: getattr(e, f) for f in PLAN_FIELDS}  # noqa: E731
    assert {p: fields(e) for p, e in tplan.entries.items()} == {
        p: fields(e) for p, e in jplan.entries.items()}
    head = {"pixtral-12b": (tcfg.d_model, tcfg.padded_vocab),
            "musicgen-medium": (tcfg.d_model, 4 * tcfg.padded_vocab)}[arch]
    assert tuple(tplan.entries[".head"].shape) == head
    assert ".patch_proj" not in tplan.entries and ".embed" not in tplan.entries
    replayed = jplan_mod.ModelPlan.from_json(tplan.to_json())
    planned = sum(int(np.prod(e.lead)) for e in tplan.entries.values() if e.mode != "dense")
    assert _assert_packs_equal(sod.sodify_params(tparams, tcfg.sod, plan=tplan),
                               jsod.sodify_params(jparams, jcfg.sod, plan=replayed)) == planned
    assert planned >= 1 and tplan.entries[".head"].mode == mode


# ---------------------------------------------------------------------------
# batches and the prompt-length rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_have_the_reference_shapes(arch):
    """The port's batches are the reference's shapes and dtypes: pixtral's
    text after 16 patches and float32 patches (the reference's are in the
    config's dtype), musicgen's (B, S, 4) tokens and targets, each
    codebook a walk of the bigram chain."""
    _, tcfg = _configs(arch)
    data = SyntheticLMData(tcfg, B, S, seed=0)
    got, want = data.batch(0), _reference_batch(arch)
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["targets"][:, :-1])
    succ = data._succ
    toks = got["tokens"] if arch == "pixtral-12b" else got["tokens"][..., 2]
    assert all(int(b) in succ[int(a)] for row in toks for a, b in zip(row[:-1], row[1:]))
    if arch == "pixtral-12b":
        assert got["tokens"].shape == (B, S - tcfg.n_patches)
        assert abs(float(got["patch_embeds"].std()) - 1.0) < 0.1
    np.testing.assert_array_equal(data.batch(3)["tokens"], data.batch(3)["tokens"])


@pytest.mark.parametrize("less", [0, 1])
def test_vlm_batch_without_text_matches_the_reference(less):
    """At ``seq_len == n_patches`` (and one less, where the reference's walk
    is still empty) both packages give text of shape (B, 0), int32, beside
    the usual patches; two below, both raise ``TypeError`` (the reference's
    walk of a negative length)."""
    jcfg, tcfg = _configs("pixtral-12b")
    seq = tcfg.n_patches - less
    got = SyntheticLMData(tcfg, B, seq, seed=0).batch(0)
    want = _reference_batch("pixtral-12b", seq)
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
    assert got["tokens"].shape == got["targets"].shape == (B, 0)
    assert got["tokens"].dtype == np.int32
    assert got["patch_embeds"].shape == (B, tcfg.n_patches, tcfg.frontend_dim)
    with pytest.raises(TypeError):
        JData(jcfg, B, tcfg.n_patches - 2, seed=0).batch(0)
    with pytest.raises(TypeError, match="below the 16 patches"):
        SyntheticLMData(tcfg, B, tcfg.n_patches - 2, seed=0).batch(0)


def test_vlm_prompt_must_divide_into_attention_chunks():
    """A VLM prompt longer than ``attn_chunk`` (64 reduced) that is not a
    multiple of it raises in the full forward of both packages; a
    multiple serves."""
    jcfg, tcfg = _configs("pixtral-12b")
    jp, tp = _both_params("pixtral-12b")
    bad = _reference_batch("pixtral-12b", 72)          # 16 patches + 56 text
    with pytest.raises(ValueError, match="not divisible by chunks"):
        jmodel_mod.LM(jcfg).apply(jp, {k: jnp.asarray(v) for k, v in bad.items()
                                       if k != "targets"})
    tb = to_device(bad, "cpu")
    with pytest.raises(ValueError, match="not divisible by chunks"):
        LM(tcfg).apply(tp, tb["tokens"], patch_embeds=tb["patch_embeds"])
    good = to_device(_reference_batch("pixtral-12b", 128), "cpu")
    logits, _ = LM(tcfg).apply(tp, good["tokens"], patch_embeds=good["patch_embeds"])
    assert tuple(logits.shape) == (B, 128, tcfg.padded_vocab)


# ---------------------------------------------------------------------------
# R5: the reference's static VLM decode starts at the text's length
# ---------------------------------------------------------------------------
def test_prefill_cache_keeps_r5_and_decode_at_the_true_end_matches():
    """Both packages' ``prefill_cache`` return the text's length as the
    first decode position, though the cache holds the patches before it
    (fault R5, kept for parity).  At ``n_patches + text length`` the port's
    decode step equals the full forward over the prompt and the token;
    at the text's length (where serving decodes) it does not."""
    jcfg, tcfg = _configs("pixtral-12b")
    jp, tp = _both_params("pixtral-12b")
    batch = _reference_batch("pixtral-12b")        # 16 patches + 16 text tokens
    n_text = batch["tokens"].shape[1]
    prompt = {"tokens": batch["tokens"][:, :-1], "patch_embeds": batch["patch_embeds"]}
    _, _, jpos = jserve.prefill_cache(jmodel_mod.LM(jcfg), jp,
                                      {k: jnp.asarray(v) for k, v in prompt.items()}, S)
    tb = to_device(prompt, "cpu")
    model = LM(tcfg)
    with torch.inference_mode():
        _, cache, pos = serve.prefill_cache(model, tp, tb["tokens"], S,
                                            patch_embeds=tb["patch_embeds"])
        assert pos == jpos == n_text - 1
        full = to_device(batch, "cpu")
        want = model.apply(tp, full["tokens"], patch_embeds=full["patch_embeds"])[0][:, -1]
        last = full["tokens"][:, -1:]
        right, _ = model.decode_step(tp, {k: v.clone() for k, v in cache.items()}, last,
                                     tcfg.n_patches + pos)
        wrong, _ = model.decode_step(tp, cache, last, pos)
    np.testing.assert_allclose(right[:, 0].numpy(), want.numpy(), atol=DECODE_ATOL,
                               rtol=DECODE_RTOL)
    assert (wrong[:, 0] - want).abs().max().item() > 0.1
