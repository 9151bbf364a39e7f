"""The port's speculative decoding: the paged verify path against the JAX
package's and, inside the port, against sequential paged decode bit for bit;
the draft tier's configuration; and the engine with a draft tier against
``static_generate`` bit for bit (window sizes, self and junk drafts, packed
tiers, chunked prefill, preemption, every feature composed, tracing on) and
against the JAX package's engine with a self-draft.

Weights come from the JAX initialiser and are carried across with
``repro_torch.interop``; pools and inputs are seeded with numpy.  Tolerance
against the JAX package: atol 1e-4 / rtol 1e-4 (as
``tests/test_torch_paged.py``) — both sides compute in float32 and differ
only in the order of their sums.  Inside the port: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import sod as jsod
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.models.model import LM as JLM
from repro.runtime import planner as jplanner
from repro.serving import Engine as JEngine
from repro_torch import configs, obs
from repro_torch.core import sod
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.models.model import LM
from repro_torch.runtime import planner
from repro_torch.serving import (Engine, Request, poisson_trace, static_generate,
                                 stress_spec_trace)

ATOL = RTOL = 1e-4
B, PAGE, C = 3, 4, 3
TABLES = np.asarray([[3, 5, 1, 7], [6, 2, 4, 8], [9, 11, 10, 12]], np.int32)


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """The reduced llama's JAX weights in fp32, both sides."""
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(dtype="float32")
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    tcfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(dtype="float32")
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, params_from_numpy(np_params, tcfg, device="cpu")


def _bf16(params):
    """The projections and embedding in bf16 (norm gains stay float32)."""
    return {"embed": params["embed"].to(torch.bfloat16),
            "final_norm": params["final_norm"],
            "layers": [{g: {k: v.to(torch.bfloat16) if v.ndim == 2 else v
                            for k, v in grp.items()} if isinstance(grp, dict) else grp
                        for g, grp in layer.items()} for layer in params["layers"]]}


def _model(weights, dtype="float32"):
    _, _, tcfg, tparams = weights
    cfg = tcfg.with_(dtype=dtype)
    return LM(cfg), (tparams if dtype == "float32" else _bf16(tparams))


# ---------------------------------------------------------------------------
# the verify path against the JAX package (fp32)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def layer(weights):
    jcfg, _, tcfg, _ = weights
    jspec = jtransformer.attn_spec(jcfg)
    jp = jattn.init_attention(jax.random.PRNGKey(0), jcfg.d_model, jspec, jnp.float32)
    return jcfg, jspec, jp, transformer.attn_spec(tcfg), {k: _t(v) for k, v in jp.items()}


def _pool(rng, spec, n_pages, lead=()):
    shape = lead + (n_pages, PAGE, spec.n_kv_heads, spec.head_dim)
    return {"k": _normal(rng, shape), "v": _normal(rng, shape)}


@pytest.mark.parametrize("start,valid", [([2, 5, 9], [64, 64, 64]),
                                         ([1, 6, 12], [3, 0, 14])])
def test_paged_verify_attention_matches_jax(layer, start, valid):
    jcfg, jspec, jp, tspec, tp = layer
    rng = np.random.default_rng(0)
    pool = _pool(rng, jspec, 13)
    x = _normal(rng, (B, C, jcfg.d_model))
    jo, jpool = jattn.paged_verify_attention(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(TABLES), jnp.asarray(start, jnp.int32),
        jnp.asarray(valid, jnp.int32), jspec)
    to, tpool = attn.paged_verify_attention(
        tp, _t(x), {k: _t(v).clone() for k, v in pool.items()}, _t(TABLES).long(),
        torch.tensor(start), torch.tensor(valid), tspec)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        # page 0 (trash) takes the cut-off positions' writes, in an order
        # neither side fixes; every live page agrees
        np.testing.assert_allclose(tpool[name].numpy()[1:], np.asarray(jpool[name])[1:],
                                   atol=ATOL, rtol=RTOL)


def test_transformer_verify_chunk_matches_jax(weights):
    jcfg, jparams, tcfg, tparams = weights
    rng = np.random.default_rng(1)
    pool = _pool(rng, transformer.attn_spec(tcfg), 13, (tcfg.n_layers,))
    tokens = rng.integers(0, tcfg.vocab, (B, C)).astype(np.int32)
    start, valid = np.asarray([2, 7, 11], np.int32), np.asarray([5, 9, 16], np.int32)
    g, p = jcfg.n_layers // jcfg.pattern_period, jcfg.pattern_period
    jl, jpool = jtransformer.transformer_verify_chunk(
        jparams, {k: jnp.asarray(v.reshape(g, p, *v.shape[1:])) for k, v in pool.items()},
        jnp.asarray(TABLES), jnp.asarray(tokens), jnp.asarray(start),
        jnp.asarray(valid), jcfg)
    tl, tpool = transformer.transformer_verify_chunk(
        tparams, {k: _t(v).clone() for k, v in pool.items()}, _t(TABLES).long(),
        _t(tokens).long(), _t(start).long(), _t(valid).long(), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        want = np.asarray(jpool[name]).reshape(-1, *jpool[name].shape[2:])
        np.testing.assert_allclose(tpool[name].numpy()[:, 1:], want[:, 1:],
                                   atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# inside the port: verify rows are sequential decode rows, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_verify_equals_sequential_decode(layer, dtype, window):
    """Row i of a C-position verify pass equals the i-th of C sequential
    paged decode steps, and both leave the pool with the same bits."""
    _, _, _, spec, tp = layer
    tp = {k: v.to(dtype) for k, v in tp.items()}
    rng = np.random.default_rng(2)
    pool = {k: _t(v).to(dtype) for k, v in _pool(rng, spec, 13).items()}
    x = _t(_normal(rng, (B, C, tp["wq"].shape[0]))).to(dtype)
    start = torch.tensor([2, 6, 10])
    tables = _t(TABLES).long()
    seq_pool = {k: v.clone() for k, v in pool.items()}
    rows = []
    for i in range(C):
        o, seq_pool = attn.paged_decode_attention(tp, x[:, i:i + 1], seq_pool, tables,
                                                  start + i, spec, window=window)
        rows.append(o[:, 0])
    out, ver_pool = attn.paged_verify_attention(
        tp, x, {k: v.clone() for k, v in pool.items()}, tables, start,
        torch.full((B,), 64), spec, window=window)
    for i in range(C):
        assert torch.equal(out[:, i], rows[i]), i
    for name in ("k", "v"):
        assert torch.equal(ver_pool[name], seq_pool[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_chunk_rows_equal_sequential_decode(weights, dtype, monkeypatch):
    """The whole model up to the LM head: row (b, i) of a verify window's
    final-normed hidden state equals the sequential paged decode step's at
    that position, and the pools agree.  The head itself is one matmul over
    all B·C rows against B at decode (as static serving's one row against
    the engine's B), which is not held row-invariant: on the CPU a float32
    matmul over a transposed weight sums a row in another order at 9 rows
    than at 3, so the head is left out here."""
    monkeypatch.setattr(transformer, "_head", lambda params, h, cfg: h)
    model, params = _model(weights, dtype)
    cfg = model.cfg
    rng = np.random.default_rng(3)
    pool = model.init_paged_pool(13, PAGE, "cpu")
    for name in ("k", "v"):
        pool[name].copy_(_t(_normal(rng, tuple(pool[name].shape))))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, C))).long()
    start, tables = torch.tensor([3, 7, 9]), _t(TABLES).long()
    valid = torch.full((B,), 16)
    seq_pool = {k: v.clone() for k, v in pool.items()}
    rows = []
    with torch.inference_mode():
        for i in range(C):
            hidden, seq_pool = model.paged_decode_step(
                params, seq_pool, tables, tokens[:, i:i + 1], start + i, valid)
            rows.append(hidden[:, 0])
        hidden, ver_pool = model.verify_chunk(
            params, {k: v.clone() for k, v in pool.items()}, tables, tokens, start,
            valid)
    for i in range(C):
        assert torch.equal(hidden[:, i], rows[i]), i
    for name in ("k", "v"):
        assert torch.equal(ver_pool[name], seq_pool[name])


def test_paged_verify_valid_len_redirects_overflow(layer):
    """Positions at or past ``valid_len`` scatter to the trash page, never
    into a live page."""
    _, _, _, spec, tp = layer
    rng = np.random.default_rng(4)
    pool = {k: _t(v) for k, v in _pool(rng, spec, 4).items()}
    live = pool["k"][1:].clone()
    x = _t(_normal(rng, (1, C, tp["wq"].shape[0])))
    # start 6, valid_len 7: position 6 writes live, 7 and 8 overflow
    _, pool = attn.paged_verify_attention(tp, x, pool, torch.tensor([[1, 2, 3]]),
                                          torch.tensor([6]), torch.tensor([7]), spec)
    changed = (pool["k"][1:] != live).flatten(1).any(1).nonzero().flatten().tolist()
    assert changed == [1]            # page id 2, which holds position 6


# ---------------------------------------------------------------------------
# the draft tier's configuration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,method", [("dense", "magnitude"),
                                         ("tiled_csc", "magnitude"),
                                         ("block_csr", "block")])
@pytest.mark.parametrize("qmode", [None, "int8"])
def test_draft_sod_cfg_equals_the_reference(mode, method, qmode):
    def cfg(pkg):
        return pkg.DENSE if mode == "dense" else pkg.SoDConfig(
            mode=mode, density=0.3, prune_method=method, min_dim=64)
    mine = planner._draft_sod_cfg(cfg(sod), 0.12, qmode)
    ref = jplanner._draft_sod_cfg(cfg(jsod), 0.12, qmode)
    for f in dataclasses.fields(mine):      # the reference has one more: impl
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert planner.DRAFT_DENSITY_LADDER == jplanner.DRAFT_DENSITY_LADDER


# ---------------------------------------------------------------------------
# the engine with a draft tier: tokens equal static_generate bit for bit
# ---------------------------------------------------------------------------
def _trace(vocab):
    return poisson_trace(4, 0.7, max_prompt=10, max_new=6, vocab=vocab, seed=3)


def _drained(eng):
    assert eng.page_pool.free_count == eng.page_pool.n_pages - 1
    assert not eng.page_pool.allocated


def _junk(model, seed=7):
    gen = torch.Generator().manual_seed(seed)
    return model.init(gen, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_engine_matches_static(weights, k, dtype):
    model, params = _model(weights, dtype)
    trace = _trace(model.cfg.vocab)
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=2, page_size=4, max_len=24,
                     spec_k=k, draft_params=params)
        res = eng.run(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req), req.rid
    s = res["stats"]
    assert s["completed"] == len(trace) and s["spec_windows"] > 0
    assert s["draft_proposed"] == s["spec_windows"] * k
    assert 0 <= s["draft_accepted"] <= s["draft_proposed"]
    assert s["logits_finite"]
    _drained(eng)


def test_spec_self_draft_accepts_full_windows(weights):
    """Window-aligned budgets and a self-draft: every proposal is accepted —
    the draft pool holds the committed positions' KV, the bonus token's
    position included."""
    model, params = _model(weights)
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, tokens=rng.integers(1, model.cfg.vocab, size=9),
                    max_new=7, arrival=0) for i in range(3)]
    with torch.inference_mode():
        res = Engine(model, params, max_slots=2, page_size=8, max_len=40,
                     spec_k=2, draft_params=params).run(reqs)
        for req in reqs:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    s = res["stats"]
    assert s["acceptance_rate"] == 1.0
    assert s["tokens_per_step"] > 1 and s["steps"] < s["generated_tokens"]


def test_spec_junk_draft_rollback_keeps_identity(weights):
    """A draft of other random weights proposes near garbage: heavy
    rejection and page rollback, the same tokens, a clean pool."""
    model, params = _model(weights)
    trace = _trace(model.cfg.vocab)
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=2, page_size=4, max_len=24, spec_k=4,
                     draft_params=_junk(model))
        res = eng.run(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    assert res["stats"]["acceptance_rate"] < 0.5
    assert res["stats"]["spec_rollbacks"] >= 1
    _drained(eng)


@pytest.mark.parametrize("mode,method", [("tiled_csc", "magnitude"),
                                         ("block_csr", "block")])
def test_spec_packed_tiers_match_static(weights, mode, method):
    """Both tiers packed from the same raw weights (target at 0.4, the draft
    at 0.12 in the target's format): the packed static reference's tokens."""
    _, _, tcfg, raw = weights
    target = sod.SoDConfig(mode=mode, density=0.4, prune_method=method, min_dim=64)
    model = LM(tcfg.with_(sod=target))
    draft = sod.sodify_params(raw, planner._draft_sod_cfg(target, 0.12))
    params = sod.sodify_params(raw, target)
    trace = poisson_trace(3, 0.7, max_prompt=10, max_new=5, vocab=tcfg.vocab, seed=3)
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=2, page_size=4, max_len=24, spec_k=2,
                     draft_params=draft)
        res = eng.run(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    assert sod.tree_weight_bytes(draft)["compressed"] < \
        sod.tree_weight_bytes(params)["compressed"]
    _drained(eng)


def test_spec_defaults_off_zero_counters(weights):
    model, params = _model(weights)
    trace = poisson_trace(2, 0.6, max_prompt=8, max_new=4, vocab=model.cfg.vocab,
                          seed=1)
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=2, page_size=4, max_len=16)
        res = eng.run(trace)
    assert not hasattr(eng, "draft_pool")
    s = res["stats"]
    assert s["spec_windows"] == s["draft_proposed"] == s["draft_accepted"] == 0
    assert s["acceptance_rate"] == 0.0 and s["tokens_per_step"] > 0


# ---------------------------------------------------------------------------
# composed phases: spec decode × chunked prefill × preemption × sharing
# ---------------------------------------------------------------------------
def test_spec_with_chunked_prefill_matches_static(weights):
    """Draft windows start once a slot's chunks are done, the draft prompt KV
    is laid down chunk by chunk, and the tokens are static serving's."""
    model, params = _model(weights)
    trace = _trace(model.cfg.vocab)
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=2, page_size=4, max_len=24, spec_k=2,
                     draft_params=params, prefill_chunk=4)
        res = eng.run(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    s = res["stats"]
    assert s["spec_windows"] > 0 and s["prefill_chunks"] > 0
    _drained(eng)


def test_spec_with_preemption_trims_window_pages(weights):
    """A starved pool with windows in flight: preemption trims a victim's
    speculative pages (never swaps them), and the tokens hold."""
    model, params = _model(weights)
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, tokens=rng.integers(1, model.cfg.vocab, size=9),
                    max_new=8, arrival=0) for i in range(4)]
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=2, page_size=4, max_len=20, n_pages=8,
                     spec_k=2, draft_params=params, preemption=True)
        res = eng.run(reqs)
        for req in reqs:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    s = res["stats"]
    assert s["preemptions"] >= 1 and s["spec_windows"] > 0
    assert s["swapped_out_pages"] >= s["swapped_in_pages"] >= 1
    _drained(eng)


def _composed(model, params, draft, tracer=None):
    trace = stress_spec_trace(6, prefix_len=8, max_prompt=14, max_new=8,
                              vocab=model.cfg.vocab, seed=0, burst=2, rate=0.3)
    eng = Engine(model, params, max_slots=3, page_size=4, max_len=24, n_pages=10,
                 spec_k=2, draft_params=draft, prefill_chunk=4, preemption=True,
                 prefix_sharing=True, tracer=tracer)
    return trace, eng, eng.run(trace)


def test_all_features_composed_matches_static(weights):
    """Spec decode, chunked prefill, preemption and prefix sharing on a
    bursty shared-prefix trace against a starved pool with a cold draft:
    preemptions land mid-window, rejected pages roll back while shared
    prefix pages stay mapped, and the tokens, pool and trie all hold."""
    model, params = _model(weights)
    with torch.inference_mode():
        trace, eng, res = _composed(model, params, _junk(model))
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    s = res["stats"]
    assert s["completed"] == len(trace)
    assert s["spec_windows"] > 0 and s["prefill_chunks"] > 0
    assert s["shared_prompt_pages"] >= 1 and s["preemptions"] >= 1
    assert s["spec_window_preemptions"] >= 1     # the trim-not-swap path ran
    assert s["spec_rollbacks"] >= 1
    _drained(eng)
    assert len(eng.trie) == 0


def test_trace_on_equals_trace_off(weights):
    """With spec decoding and preemption on, recording a trace changes no
    token and no counter, and the trace holds the spec spans."""
    model, params = _model(weights)
    draft = _junk(model)
    with torch.inference_mode():
        _, _, off = _composed(model, params, draft)
        tracer = obs.Tracer()
        _, _, on = _composed(model, params, draft, tracer=tracer)
    assert on["tokens"] == off["tokens"]
    ints = [k for k, v in off["stats"].items()
            if isinstance(v, int) and not isinstance(v, bool)]
    assert {k: on["stats"][k] for k in ints} == {k: off["stats"][k] for k in ints}
    names = {ev.get("name") for ev in tracer._events}
    assert {"draft", "verify", "spec_window", "capacity"} <= names


def test_self_draft_equals_the_reference_engine(weights):
    """fp32, the same weights and trace, a self-draft with preemption on:
    the port's tokens, preempt log and integer counters are the JAX
    engine's."""
    jcfg, jparams, _, _ = weights
    model, params = _model(weights)
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, tokens=rng.integers(1, model.cfg.vocab, size=9),
                    max_new=8, arrival=i // 2) for i in range(4)]
    kw = dict(max_slots=2, page_size=4, max_len=20, n_pages=8, spec_k=2,
              preemption=True)
    jeng = JEngine(JLM(jcfg), jparams, draft_params=jparams, **kw)
    want = jeng.run(reqs)
    with torch.inference_mode():
        eng = Engine(model, params, draft_params=params, **kw)
        got = eng.run(reqs)
    assert got["tokens"] == want["tokens"]
    assert eng.preempt_log == jeng.preempt_log
    ints = [k for k, v in want["stats"].items()
            if isinstance(v, int) and not isinstance(v, bool) and k != "steps"]
    assert {k: got["stats"][k] for k in ints} == {k: want["stats"][k] for k in ints}
    assert got["stats"]["draft_accepted"] > 0 and got["stats"]["preemptions"] >= 1


# ---------------------------------------------------------------------------
# validation and the serve CLI
# ---------------------------------------------------------------------------
def test_spec_validation_errors(weights):
    model, params = _model(weights)
    with pytest.raises(ValueError, match="draft_params"):
        Engine(model, params, max_len=16, spec_k=2)


@pytest.mark.parametrize("argv,msg", [
    (["--spec-decode", "2", "--draft-sparsity", "0.9"], "--engine"),
    (["--engine", "--draft-sparsity", "0.9"], "requires --spec-decode"),
    (["--engine", "--spec-decode", "2", "--plan", "auto"], "--plan requires"),
])
def test_serve_spec_flag_validation(argv, msg, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu", *argv])
    assert msg in capsys.readouterr().err


def test_serve_spec_decode_end_to_end():
    summary = serve.main(["--reduced", "--engine", "--device", "cpu",
                          "--requests", "3", "--prompt-len", "12", "--gen", "5",
                          "--max-slots", "2", "--page-size", "4",
                          "--spec-decode", "2", "--draft-sparsity", "0.9"])
    assert summary["spec_decode"] == 2 and summary["completed"] == 3
    assert summary["spec_windows"] > 0
    assert "acceptance_rate" in summary and "tokens_per_step" in summary
    assert summary["draft_density"] == pytest.approx(0.1)
    assert 0 < summary["draft_bytes"] < summary["weight_bytes"]["compressed"]
    assert summary["generated_tokens"] == sum(r.max_new for r in summary["trace"])
