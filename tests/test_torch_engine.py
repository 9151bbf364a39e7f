"""The port's continuous-batching engine: its copied page pool, scheduler
and trace against the JAX package's, its tokens against the port's
``static_generate`` (bit for bit, on the reduced llama in dense,
``tiled_csc`` and ``block_csr``, with fused and with chunked prefill,
through preemption with page swapping and copy-on-write prefix sharing) and
against the JAX package's ``Engine`` on the same weights in fp32 (tokens,
preemption log and integer counters), its admission rules, its flag
validation, and ``serve.py --engine`` on the CPU.

Weights come from the JAX initialiser and are carried across with
``repro_torch.interop``; each package prunes and packs them itself (the
packings are bit-equal, ``tests/test_torch_model.py``).
"""
import jax
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # CI installs hypothesis; bare
    from _hypothesis_stub import given, settings, st  # noqa: E501  envs skip the property tests

from repro import configs as jconfigs
from repro.core import sod as jsod
from repro.models.model import LM as JLM
from repro.serving import Engine as JEngine
from repro.serving import PagePool as JPagePool
from repro.serving import poisson_trace as jpoisson_trace
from repro.serving import shared_prefix_trace as jshared_prefix_trace
from repro_torch import configs
from repro_torch.core import sod
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.model import LM
from repro_torch.serving import (Engine, PagePool, PoolExhausted, Request,
                                 bucket_len, poisson_trace, shared_prefix_trace,
                                 static_generate)

MODES = ("dense", "tiled_csc", "block_csr")


# ---------------------------------------------------------------------------
# the copied host-side modules
# ---------------------------------------------------------------------------
def test_page_pool_invariants():
    pool = PagePool(8, page_size=4)
    assert pool.free_count == 7          # page 0 reserved as trash
    a = pool.alloc(3)
    b = pool.alloc(2)
    assert PagePool.TRASH_PAGE not in a + b
    assert len(set(a + b)) == 5          # no double allocation
    pool.free(a)
    assert pool.free_count == 5          # frees return to the pool
    c = pool.alloc(4)
    assert len(set(b + c)) == 6
    with pytest.raises(PoolExhausted):
        pool.alloc(2)                    # only 1 free
    (still_free,) = set(range(1, 8)) - set(b) - set(c)
    with pytest.raises(ValueError):
        pool.free([still_free])          # double free of an unheld page
    with pytest.raises(ValueError):
        pool.free([PagePool.TRASH_PAGE])  # trash page is never allocated
    assert pool.pages_for(9) == 3


def test_page_pool_hands_out_the_reference_ids():
    """The same alloc/free program gives the same page ids as the JAX
    package's allocator."""
    mine, ref = PagePool(12, page_size=4), JPagePool(12, page_size=4)
    for n, drop in ((3, 1), (4, 0), (2, 2), (3, 1)):
        a, b = mine.alloc(n), ref.alloc(n)
        assert a == b
        assert mine.free(a[:drop]) == ref.free(b[:drop])
    assert mine.free_count == ref.free_count


@settings(max_examples=60, deadline=None)
@given(st.integers(4, 24),
       st.lists(st.tuples(st.integers(0, 6), st.integers(0, 10**6)),
                min_size=1, max_size=120))
def test_page_pool_refcount_partition_property(n_pages, program):
    """Random alloc/retain/free/trim/fork/swap programs against a model:
    refcounts never go negative (a release of an unheld page raises), the
    trash page is never handed out, the free list and the live set partition
    the pool, and the swap tallies count what left the device."""
    pool = PagePool(n_pages, page_size=4)
    refs: dict[int, int] = {}     # model: page id -> expected refcount
    host = 0                      # model: pages swapped out, not yet back
    for op, r in program:
        live = sorted(refs)
        if op == 0:                                 # alloc
            for p in pool.alloc(r % (pool.free_count + 1)):
                assert p != PagePool.TRASH_PAGE and p not in refs
                refs[p] = 1
        elif op in (2, 3, 5) and live:              # free / trim / swap out
            p = live[r % len(live)]
            release = {2: pool.free, 3: pool.trim, 5: pool.swap_out}[op]
            before = (pool.trimmed_pages, pool.swapped_out_pages)
            freed = release([p])
            refs[p] -= 1
            assert (freed == [p]) == (refs[p] == 0)
            assert (pool.trimmed_pages - before[0]) == (len(freed) if op == 3 else 0)
            assert (pool.swapped_out_pages - before[1]) == (len(freed) if op == 5 else 0)
            host += len(freed) if op == 5 else 0
            if refs[p] == 0:
                del refs[p]
        elif op == 1 and live:                      # retain (share)
            p = live[r % len(live)]
            pool.retain([p])
            refs[p] += 1
        elif op == 4:                               # copy-on-write fork
            shared = [p for p in live if refs[p] >= 2]
            if shared and pool.can_alloc(1):
                p = shared[r % len(shared)]
                new = pool.fork(p)
                refs[p] -= 1
                assert new not in refs and new != PagePool.TRASH_PAGE
                refs[new] = 1
        elif op == 6 and host:                      # resume: swap in
            k = min(host, r % (pool.free_count + 1))
            for p in pool.swap_in(k):
                assert p != PagePool.TRASH_PAGE and p not in refs
                refs[p] = 1
            host -= k
        assert PagePool.TRASH_PAGE not in pool.allocated
        assert pool.allocated == frozenset(refs)
        assert all(pool.ref_count(p) == c >= 1 for p, c in refs.items())
        assert pool.free_count + len(refs) == pool.n_pages - 1
        assert pool.swapped_in_pages <= pool.swapped_out_pages
    victim = next(iter(refs)) if refs else pool.alloc(1)[0]
    pool.free([victim] * pool.ref_count(victim))
    with pytest.raises(ValueError):
        pool.free([victim])


def test_bucket_len():
    assert bucket_len(5, 8) == 8
    assert bucket_len(8, 8) == 8
    assert bucket_len(9, 8) == 16
    # prompts longer than the attention chunk round to lcm(page, chunk)
    assert bucket_len(70, 8, chunk=64) == 128
    assert bucket_len(60, 8, chunk=64) == 64


@pytest.mark.parametrize("seed", [0, 3])
def test_poisson_trace_equals_the_reference(seed):
    mine = poisson_trace(8, 0.5, max_prompt=64, max_new=16, vocab=128256, seed=seed)
    ref = jpoisson_trace(8, 0.5, max_prompt=64, max_new=16, vocab=128256, seed=seed)
    assert [(r.rid, r.arrival, r.max_new) for r in mine] == \
        [(r.rid, r.arrival, r.max_new) for r in ref]
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert all(32 <= len(r.tokens) <= 64 for r in mine)


# ---------------------------------------------------------------------------
# engine tokens
# ---------------------------------------------------------------------------
def _sod(pkg, mode):
    return pkg.SoDConfig(mode=mode, density=0.3, min_dim=64) if mode != "dense" \
        else pkg.DENSE


@pytest.fixture(scope="module")
def weights():
    """The reduced llama's JAX weights in fp32, as numpy."""
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(dtype="float32")
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _port(weights, mode, dtype="float32"):
    _, _, np_params = weights
    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        dtype=dtype, sod=_sod(sod, mode))
    params = params_from_numpy(np_params, cfg, device="cpu")
    if dtype != "float32":
        params = {"embed": params["embed"].to(torch.bfloat16),
                  "final_norm": params["final_norm"],
                  "layers": [{g: {k: v.to(torch.bfloat16) if v.ndim == 2 else v
                                  for k, v in grp.items()} if isinstance(grp, dict)
                              else grp for g, grp in layer.items()}
                             for layer in params["layers"]]}
    return LM(cfg), sod.sodify_params(params, cfg.sod)


TRACE = dict(n_requests=5, rate=0.7, max_prompt=20, max_new=7, seed=3)


def _trace(vocab):
    trace = poisson_trace(vocab=vocab, **TRACE)
    # ragged by construction: staggered arrivals, mixed lengths
    assert len({r.arrival for r in trace}) > 1
    assert len({len(r.tokens) for r in trace}) > 1
    return trace


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("mode", MODES)
def test_engine_matches_static_generate(weights, mode, chunk, dtype):
    """A ragged trace through the engine gives per-request static serving's
    greedy tokens bit for bit, with fused and with chunked prefill."""
    model, params = _port(weights, mode, dtype)
    trace = _trace(model.cfg.vocab)
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=3, page_size=4, max_len=32,
                     prefill_chunk=chunk)
        res = eng.run(trace)
        assert res["stats"]["completed"] == len(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req), \
                f"rid {req.rid}"
    assert res["stats"]["warmup_s"] > 0 and res["stats"]["steady_tok_per_s"] > 0
    assert (res["stats"]["prefill_chunks"] > 0) == bool(chunk)
    assert eng.page_pool.free_count == eng.page_pool.n_pages - 1


@pytest.mark.parametrize("mode,chunk", [("dense", None), ("tiled_csc", 8),
                                        ("block_csr", None)])
def test_engine_tokens_equal_the_reference_engine(weights, mode, chunk):
    """fp32, the same weights: the port's engine emits the JAX package's
    engine's tokens."""
    jcfg, jparams, _ = weights
    jcfg = jcfg.with_(sod=_sod(jsod, mode))
    jmodel = JLM(jcfg)
    jp = jsod.sodify_params(jparams, jcfg.sod)
    model, params = _port(weights, mode)
    trace = _trace(model.cfg.vocab)
    kw = dict(max_slots=3, page_size=4, max_len=32, prefill_chunk=chunk)
    want = JEngine(jmodel, jp, **kw).run(trace)["tokens"]
    with torch.inference_mode():
        got = Engine(model, params, **kw).run(trace)["tokens"]
    assert got == want


def _small(weights):
    return _port(weights, "dense")


def test_engine_page_pressure_reuses_pages(weights):
    """A pool too small for all requests at once forces head-of-line
    waiting; freed pages are reused and results stay correct."""
    model, params = _small(weights)
    reqs = [Request(rid=i, tokens=np.full(6, 7 * i + 1, np.int32), max_new=4,
                    arrival=0) for i in range(4)]
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=2, page_size=4, max_len=12, n_pages=7)
        res = eng.run(reqs)
        assert res["stats"]["completed"] == 4
        for req in reqs:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    assert eng.page_pool.free_count == eng.page_pool.n_pages - 1
    assert not eng.page_pool.allocated
    total_pages = sum(len(s.pages) for s in eng._finished.values())
    assert total_pages > eng.page_pool.n_pages - 1


def test_engine_admission_reserves_growth_pages(weights):
    """Admission holds back the pages running sequences will still claim:
    with 4 usable pages and 3 needed per request over its lifetime (bucket
    8 = 2 pages, the last write at position 8 a third), the second request
    waits although 2 pages are free at its arrival."""
    model, params = _small(weights)
    reqs = [Request(rid=0, tokens=np.full(6, 3, np.int32), max_new=4, arrival=0),
            Request(rid=1, tokens=np.full(6, 9, np.int32), max_new=4, arrival=1)]
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=2, page_size=4, max_len=12, n_pages=5)
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        eng.step()
        eng.step()                     # rid 1 has arrived: it must wait
        assert len(eng.sched.active) == 1 and eng.page_pool.free_count == 2
        res = eng.run()
        for req in reqs:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    assert res["stats"]["completed"] == 2 and eng.page_pool.free_count == 4


def test_engine_rejects_unservable(weights):
    model, params = _small(weights)
    eng = Engine(model, params, max_slots=2, page_size=4, max_len=16)
    with pytest.raises(ValueError, match="needs"):
        eng.submit(Request(rid=0, tokens=np.zeros(14, np.int32), max_new=8))


def test_chunked_prefill_refuses_prompts_past_attn_chunk(weights):
    """Chunked prefill's one-block attention equals the fused path only
    within one attention chunk (64 tokens at the reduced size)."""
    model, params = _small(weights)
    eng = Engine(model, params, max_slots=2, page_size=4, max_len=128,
                 prefill_chunk=8)
    with pytest.raises(ValueError, match="attn_chunk"):
        eng.submit(Request(rid=0, tokens=np.zeros(70, np.int32), max_new=2))


# ---------------------------------------------------------------------------
# preemption with page swapping, copy-on-write prefix sharing
# ---------------------------------------------------------------------------
def _drained(eng):
    assert eng.page_pool.free_count == eng.page_pool.n_pages - 1
    assert not eng.page_pool.allocated
    assert eng.trie is None or len(eng.trie) == 0


def _rotating(vocab, n=3, plen=8, max_new=8):
    return [Request(rid=i, tokens=(np.arange(plen, dtype=np.int32) * (3 * i + 7)) % vocab,
                    max_new=max_new, arrival=i) for i in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_preemption_victim_order_and_identity(weights, dtype):
    """A pool too small for three concurrent decodes forces preemption: the
    youngest decoding arrival goes first (the oldest is never evicted),
    every sequence completes, and the tokens hold through the swap cycles."""
    model, params = _port(weights, "dense", dtype)
    reqs = _rotating(model.cfg.vocab)
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=3, page_size=4, max_len=16, n_pages=8,
                     prefill_chunk=4, preemption=True)
        res = eng.run(reqs)
        for req in reqs:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    s = res["stats"]
    assert s["preemptions"] == len(eng.preempt_log) >= 1
    assert s["swapped_in_pages"] >= 1 and 0 not in eng.preempt_log
    _drained(eng)


def _pages(eng, pages):
    """A copy of pages ``pages`` of every layer's pool, raw bits as int."""
    return {name: eng.pool[name][:, pages].clone().view(
        {2: torch.int16, 4: torch.int32}[eng.pool[name].element_size()])
        for name in ("k", "v")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_swap_roundtrip_restores_exact_kv(weights, dtype):
    """Swap-out then swap-in lands the sequence's KV pages back on the
    device bit for bit (compared as raw integers), at fresh page ids."""
    model, params = _port(weights, "dense", str(dtype).split(".")[-1])
    req = Request(rid=0, tokens=np.arange(1, 9, dtype=np.int32), max_new=6)
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=2, page_size=4, max_len=16,
                     prefill_chunk=4, preemption=True)
        eng.submit(req)
        for _ in range(4):                    # two prefill chunks, then decode
            eng.step()
        (seq,) = eng.sched.active.values()
        assert not seq.is_prefilling and len(seq.pages) >= 2
        old = list(seq.pages)
        before = _pages(eng, old)
        eng._preempt(seq)
        assert eng.sched.swapped and not eng.sched.active
        assert seq.host_kv[0]["k"].device.type == "cpu"
        # the freed pages are reused and overwritten while the sequence is out
        for name in ("k", "v"):
            eng.pool[name][:, old] = -1
        eng._swap_in(seq)
        assert eng.pool["k"].dtype == dtype
        after = _pages(eng, seq.pages)
        for name in ("k", "v"):
            assert torch.equal(before[name], after[name])
        res = eng.run()
        assert res["tokens"][0] == static_generate(model, params, req)
    assert res["stats"]["swapped_in_pages"] == len(old)
    _drained(eng)


def test_engine_prefix_sharing_saves_pages(weights):
    """Requests with one common prefix map its pages once: fewer fresh
    prompt pages than prompt pages, static serving's tokens, and an empty
    trie and pool at the end."""
    model, params = _small(weights)
    trace = shared_prefix_trace(4, prefix_len=8, max_prompt=12, max_new=6,
                                vocab=model.cfg.vocab, seed=2, arrival_gap=3)
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=3, page_size=4, max_len=24,
                     prefill_chunk=4, prefix_sharing=True)
        res = eng.run(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    s = res["stats"]
    assert s["shared_prompt_pages"] > 0
    assert s["prompt_pages_fresh"] < s["prompt_pages_total"]
    _drained(eng)


def test_engine_cow_fork_refcount_accounting(weights):
    """Identical page-aligned prompts share every prompt page; a sharer's
    recompute of its last token forks the last shared page.  No page leaks
    or double frees (the pool raises on either)."""
    model, params = _small(weights)
    tok = (np.arange(8, dtype=np.int32) * 5 + 2) % model.cfg.vocab
    reqs = [Request(rid=i, tokens=tok.copy(), max_new=6, arrival=i * 3)
            for i in range(3)]
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=3, page_size=4, max_len=16,
                     prefill_chunk=4, prefix_sharing=True)
        res = eng.run(reqs)
        ref = static_generate(model, params, reqs[0])
    s = res["stats"]
    assert s["cow_forks"] >= 1 and s["shared_prompt_pages"] >= 2
    assert all(res["tokens"][r.rid] == ref for r in reqs)
    assert eng.page_pool.forks == s["cow_forks"]
    _drained(eng)


def test_engine_cow_fork_under_pool_pressure(weights):
    """A fork whose capacity hunt preempts the page's only other holder
    writes in place (forking a page of refcount 1 raises): a donor decodes
    on 3 of 4 usable pages, two identical sharers arrive together."""
    model, params = _small(weights)
    tok = (np.arange(8, dtype=np.int32) * 11 + 3) % model.cfg.vocab
    reqs = [Request(rid=0, tokens=tok.copy(), max_new=8, arrival=0),
            Request(rid=1, tokens=tok.copy(), max_new=6, arrival=3),
            Request(rid=2, tokens=tok.copy(), max_new=6, arrival=3)]
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=3, page_size=4, max_len=16, n_pages=5,
                     prefill_chunk=4, preemption=True, prefix_sharing=True)
        res = eng.run(reqs)
        for req in reqs:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    s = res["stats"]
    assert s["completed"] == 3 and s["cow_forks"] >= 1 and s["preemptions"] >= 1
    _drained(eng)


@pytest.mark.parametrize("features", [
    dict(preemption=True), dict(prefix_sharing=True),
    dict(preemption=True, prefix_sharing=True)], ids=["preempt", "share", "both"])
def test_stage2_equals_the_reference_engine(weights, features):
    """fp32, the same weights and traces: the port's tokens, preempt log and
    integer counters are the JAX engine's, on a starved pool (preemption)
    and on a shared-prefix trace."""
    jcfg, jparams, _ = weights
    model, params = _small(weights)
    kw = dict(max_slots=3, page_size=4, max_len=24, n_pages=9, prefill_chunk=4,
              **features)
    traces = [(_rotating(model.cfg.vocab, n=4), _rotating(jcfg.vocab, n=4)),
              (shared_prefix_trace(5, prefix_len=8, max_prompt=14, max_new=8,
                                   vocab=model.cfg.vocab, seed=4, arrival_gap=1),
               jshared_prefix_trace(5, prefix_len=8, max_prompt=14, max_new=8,
                                    vocab=jcfg.vocab, seed=4, arrival_gap=1))]
    for mine, ref in traces:
        jeng = JEngine(JLM(jcfg), jparams, **kw)
        want = jeng.run(ref)
        with torch.inference_mode():
            eng = Engine(model, params, **kw)
            got = eng.run(mine)
        assert got["tokens"] == want["tokens"]
        assert eng.preempt_log == jeng.preempt_log
        ints = [k for k, v in want["stats"].items()
                if isinstance(v, int) and not isinstance(v, bool)]
        assert {k: got["stats"][k] for k in ints} == {k: want["stats"][k] for k in ints}
    if features.get("preemption"):
        assert got["stats"]["preemptions"] >= 1
    if features.get("prefix_sharing"):
        assert got["stats"]["shared_prompt_pages"] >= 1


def test_engine_feature_flag_validation(weights):
    model, params = _small(weights)
    with pytest.raises(ValueError, match="prefix sharing needs chunked prefill"):
        Engine(model, params, max_len=16, prefix_sharing=True)
    with pytest.raises(ValueError, match="prefix_sharing=True"):
        Engine(model, params, max_len=16, prefill_chunk=4, prefix_cache_budget=1)


@pytest.mark.parametrize("argv,msg", [
    (["--prefix-sharing"], "--prefix-sharing requires --prefill-chunk"),
    (["--prefill-chunk", "4", "--prefix-cache-budget", "1"], "require --prefix-sharing"),
    (["--prefill-chunk", "4", "--prefix-cache-dir", "d"], "require --prefix-sharing"),
])
def test_serve_engine_flag_validation(argv, msg, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--engine", "--device", "cpu", *argv])
    assert msg in capsys.readouterr().err


def test_serve_engine_preemption_and_sharing_on_the_cpu():
    summary = serve.main(["--reduced", "--engine", "--device", "cpu",
                          "--requests", "4", "--prompt-len", "16", "--gen", "6",
                          "--max-slots", "2", "--page-size", "4",
                          "--prefill-chunk", "4", "--preemption", "--prefix-sharing"])
    assert summary["preemption"] and summary["prefix_sharing"]
    assert summary["completed"] == 4
    for key in ("preemptions", "swapped_in_pages", "cow_forks", "shared_prompt_pages"):
        assert key in summary, key


@pytest.mark.parametrize("chunk", [[], ["--prefill-chunk", "16"]])
def test_serve_engine_on_the_cpu(chunk):
    summary = serve.main(["--reduced", "--engine", "--device", "cpu",
                          "--requests", "4", "--prompt-len", "24", "--gen", "6",
                          "--sod", "tiled_csc", *chunk])
    assert summary["engine"] and summary["completed"] == 4
    assert summary["warmup_s"] > 0 and summary["steady_tok_per_s"] > 0
    assert 0 < summary["p50_latency_s"] <= summary["p99_latency_s"]
    assert summary["kernel_launches"] == {"sod_matmul": 0, "block_matmul": 0}
    assert summary["prefill_chunk"] == (16 if chunk else None)
    assert summary["generated_tokens"] == sum(r.max_new for r in summary["trace"])


def test_serve_engine_needs_a_gpu_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--engine", "--requests", "2"])
