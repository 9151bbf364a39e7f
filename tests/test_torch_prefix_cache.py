"""The port's persistent multi-tier prefix cache: its keys against the JAX
package's, the tier lifecycle and the pool partition against a bare pool,
pages round-tripping bit for bit through host and disk in every pool dtype
(without ``ml_dtypes``), and the engine with the cache: the second epoch of
a repeated prompt prefills no fresh page, a restart is served from disk,
tokens are the cache-off run's and ``static_generate``'s, admission reclaims
cold pages, and tokens, preemption log and integer counters equal the JAX
engine's on the same fp32 weights.

Weights come from the JAX initialiser and are carried across with
``repro_torch.interop``.
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
from repro.models.model import LM as JLM
from repro.serving import Engine as JEngine
from repro.serving import PrefixCache as JPrefixCache
from repro.serving import repeated_prompt_trace as jrepeated_prompt_trace
from repro_torch import configs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.model import LM
from repro_torch.serving import (Engine, PagePool, PrefixCache, repeated_prompt_trace,
                                 static_generate)

PAGE_BYTES = 32


def _gather_stub(page):
    """A page-keyed snapshot standing in for the engine's per-page gather."""
    return {"k": torch.full((4,), float(page)), "v": torch.full((4,), float(-page))}


# ---------------------------------------------------------------------------
# keys and the raw-bits host format
# ---------------------------------------------------------------------------
def test_prefix_cache_key_pins_full_context():
    """Keys hash the entire token prefix: two chunks with the same tokens but
    different histories never alias."""
    a = np.arange(8, dtype=np.int32)
    b = a.copy()
    b[0] += 1
    assert PrefixCache.key(a) != PrefixCache.key(b)
    assert PrefixCache.key(a) == PrefixCache.key(list(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_key_equals_the_reference(seed):
    tokens = np.random.default_rng(seed).integers(0, 128256, 48).astype(np.int32)
    for n in (16, 32, 48):
        assert PrefixCache.key(tokens[:n]) == JPrefixCache.key(tokens[:n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn, torch.float8_e5m2])
def test_pages_round_trip_bit_for_bit(tmp_path, dtype):
    """A page demoted to host and to disk comes back with its dtype and its
    bits, NaN and signed-zero patterns included."""
    g = torch.Generator().manual_seed(0)
    kv = {"k": torch.randn(2, 4, 2, 8, generator=g).to(dtype),
          "v": torch.randn(2, 4, 2, 8, generator=g).to(dtype)}
    kv["k"].view(-1)[:2] = torch.tensor([-0.0, float("nan")]).to(dtype)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(dtype, torch.uint8)
    pool = PagePool(4, page_size=4)
    cache = PrefixCache(pool, page_bytes=64, cache_dir=tmp_path,
                        gather=lambda page: kv)
    (page,) = pool.alloc(1)
    cache.hold("chunk", page)              # budget 0: demoted at once
    for tier in ("host", "disk"):
        got, where = cache.fetch("chunk")
        assert where == tier
        for name in ("k", "v"):
            assert got[name].dtype == dtype
            assert torch.equal(got[name].view(bits), kv[name].view(bits))


def test_host_snapshot_is_a_copy():
    """A CPU gather hands the cache views into the pool; the host tier keeps
    its own copy, so the page can be reused."""
    pool_t = torch.zeros(3, 4)
    pool = PagePool(3, page_size=4)
    cache = PrefixCache(pool, page_bytes=16, gather=lambda page: {"k": pool_t[page],
                                                                  "v": pool_t[page]})
    (page,) = pool.alloc(1)
    pool_t[page] = 7.0
    cache.hold("chunk", page)
    pool_t[page] = -1.0
    got, _ = cache.fetch("chunk")
    assert torch.equal(got["k"], torch.full((4,), 7.0))


# ---------------------------------------------------------------------------
# the tier lifecycle against a bare pool
# ---------------------------------------------------------------------------
def test_prefix_cache_tier_lifecycle(tmp_path):
    """hold → budget demotion (leaf-first) → host fetch → disk write-through,
    with the pool's refcounts balanced throughout."""
    pool = PagePool(8, page_size=4)
    dropped = []
    cache = PrefixCache(pool, page_bytes=PAGE_BYTES, budget_bytes=2 * PAGE_BYTES,
                        cache_dir=tmp_path, gather=_gather_stub,
                        on_page_freed=dropped.append)
    pages = pool.alloc(3)
    keys = [f"k{j}" for j in range(3)]
    for j in (2, 1, 0):                   # completion holds leaf-first
        cache.hold(keys[j], pages[j])
    assert cache.held_pages == (pages[1], pages[0])
    assert dropped == []                  # the sequence still holds the leaf
    pool.free(pages)
    assert cache.bytes_by_tier()["hbm"] == 2 * PAGE_BYTES
    assert cache.bytes_by_tier()["disk"] > 0
    assert cache.peek(keys[2]) == "host"
    kv, tier = cache.fetch(keys[2])
    assert tier == "host" and torch.equal(kv["k"], torch.full((4,), float(pages[2])))
    assert cache.peek(keys[2]) == "disk"
    kv, tier = cache.fetch(keys[2])
    assert tier == "disk" and torch.equal(kv["v"], torch.full((4,), float(-pages[2])))
    assert cache.reclaimable() == 2
    assert cache.reclaim(2) == 2
    assert dropped == [pages[1], pages[0]]
    assert not cache.held_pages and pool.free_count == pool.n_pages - 1
    again = PrefixCache(pool, page_bytes=PAGE_BYTES, cache_dir=tmp_path,
                        gather=_gather_stub)
    assert again.peek(keys[0]) == "disk"
    assert again.bytes_by_tier()["disk"] == cache.bytes_by_tier()["disk"]


def test_prefix_cache_hold_is_idempotent_and_touch_reorders():
    pool = PagePool(8, page_size=4)
    cache = PrefixCache(pool, page_bytes=PAGE_BYTES, budget_bytes=4 * PAGE_BYTES,
                        gather=_gather_stub)
    a, b = pool.alloc(2)
    cache.hold("a", a)
    cache.hold("b", b)
    cache.hold("a", a)                    # re-hold = LRU touch, not a new ref
    assert pool.ref_count(a) == 2 and cache.held_pages == (b, a)
    cache.touch(b)
    assert cache.held_pages == (a, b)
    cache.flush()
    assert pool.ref_count(a) == 1 and pool.ref_count(b) == 1


@settings(max_examples=40, deadline=None)
@given(st.integers(6, 16), st.integers(0, 4),
       st.lists(st.tuples(st.integers(0, 7), st.integers(0, 10**6)),
                min_size=1, max_size=100))
def test_prefix_cache_pool_partition_property(n_pages, budget_pages, program):
    """Random programs of sequence alloc/retain/free and cache
    hold/touch/reclaim/fetch/flush: one pool reference per resident entry,
    the budget held, reclaimable() exact, demoted bytes round-tripping, and
    the pool's free + live partition intact."""
    pool = PagePool(n_pages, page_size=4)
    cache = PrefixCache(pool, page_bytes=PAGE_BYTES,
                        budget_bytes=budget_pages * PAGE_BYTES, gather=_gather_stub)
    seq_refs: dict[int, int] = {}
    for op, r in program:
        live = sorted(seq_refs)
        held = list(cache.held_pages)
        if op == 0:
            for p in pool.alloc(r % (pool.free_count + 1)):
                seq_refs[p] = 1
        elif op == 1 and live:
            p = live[r % len(live)]
            pool.retain([p])
            seq_refs[p] += 1
        elif op == 2 and live:
            p = live[r % len(live)]
            freed = pool.free([p])
            seq_refs[p] -= 1
            if seq_refs[p] == 0:
                del seq_refs[p]
                assert bool(freed) == (not cache.held(p))
        elif op == 3 and live:
            p = live[r % len(live)]
            cache.hold(f"k{p}", p)
        elif op == 4 and held:
            cache.touch(held[r % len(held)])
        elif op == 5 and held:
            want = r % 3 + 1
            assert cache.reclaim(want) <= want
        elif op == 6 and cache.host_keys:
            key = cache.host_keys[r % len(cache.host_keys)]
            kv, tier = cache.fetch(key)
            assert tier == "host"
            assert torch.equal(kv["k"], torch.full((4,), float(key[1:])))
        elif op == 7:
            cache.flush()
        held_set = set(cache.held_pages)
        assert len(held_set) == len(cache.held_pages)
        assert len(held_set) * PAGE_BYTES <= cache.budget_bytes or not held_set
        for p in held_set:
            assert cache.held(p) and p in pool.allocated
            assert pool.ref_count(p) == seq_refs.get(p, 0) + 1
        for p, c in seq_refs.items():
            if p not in held_set:
                assert pool.ref_count(p) == c
        assert cache.reclaimable() == sum(1 for p in held_set if p not in seq_refs)
        assert pool.free_count + len(pool.allocated) == pool.n_pages - 1
        assert cache.bytes_by_tier()["hbm"] == len(held_set) * PAGE_BYTES
    for p, c in list(seq_refs.items()):
        pool.free([p] * c)
    cache.flush()
    assert not cache.held_pages and not pool.allocated


# ---------------------------------------------------------------------------
# the engine with the cache
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(dtype="float32")
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(dtype="float32")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                               device="cpu")
    model = LM(cfg)
    k = model.init_paged_pool(2, 4, "cpu")["k"]
    page_nbytes = 2 * (k.numel() // k.shape[1]) * k.element_size()
    return jcfg, jparams, model, params, page_nbytes


def _epoch(vocab, seed=0, rid_base=0, make=repeated_prompt_trace):
    return make(3, prefix_len=8, suffix_len=4, max_new=4, vocab=vocab, page_size=4,
                seed=seed, arrival_gap=2, rid_base=rid_base)


def _cache_engine(model, params, *, budget_bytes, cache_dir=None, n_pages=12):
    return Engine(model, params, max_slots=2, page_size=4, max_len=16,
                  n_pages=n_pages, prefill_chunk=4, prefix_sharing=True,
                  prefix_cache_budget=budget_bytes, prefix_cache_dir=cache_dir)


def _clean(eng):
    eng.flush_prefix_cache()
    assert not eng.page_pool.allocated
    assert eng.page_pool.free_count == eng.page_pool.n_pages - 1
    assert len(eng.trie) == 0
    assert eng.prefix_cache.bytes_by_tier()["hbm"] == eng.stats["prefix_bytes_hbm"] == 0


def test_engine_second_epoch_prefills_zero_fresh_pages(weights, tmp_path):
    """A repeated prompt's second epoch resolves entirely from the cache
    tiers: the fresh page counter does not move, tokens are static serving's,
    and a flush drains the pool, the trie and the resident tier."""
    _, _, model, params, page_nbytes = weights
    vocab = model.cfg.vocab
    with torch.inference_mode():
        eng = _cache_engine(model, params, budget_bytes=3 * page_nbytes,
                            cache_dir=tmp_path)
        fresh1 = eng.run(_epoch(vocab))["stats"]["prompt_pages_fresh"]
        res = eng.run(_epoch(vocab, rid_base=3))
        for req in _epoch(vocab) + _epoch(vocab, rid_base=3):
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    s = res["stats"]
    assert fresh1 > 0 and s["prompt_pages_fresh"] == fresh1
    assert s["prefix_hits"] >= 1 and s["prefix_host_hits"] >= 1
    assert s["prefix_demotions_disk"] >= 1 and s["prefix_bytes_disk"] > 0
    assert s["reprefill_tokens_saved"] > 0
    _clean(eng)


def test_engine_restart_survives_from_disk(weights, tmp_path):
    """A fresh engine on the same cache dir serves the same prompts with no
    fresh prefill page, every page promoted from disk, the same tokens."""
    _, _, model, params, _ = weights
    vocab = model.cfg.vocab
    with torch.inference_mode():
        eng = _cache_engine(model, params, budget_bytes=0, cache_dir=tmp_path)
        first = eng.run(_epoch(vocab))
        assert eng.stats["prefix_demotions_disk"] >= 1
        assert list(tmp_path.glob("*.npz"))
        del eng
        again = _cache_engine(model, params, budget_bytes=0, cache_dir=tmp_path)
        res = again.run(_epoch(vocab))
    s = res["stats"]
    assert s["prompt_pages_fresh"] == 0 and s["prefix_disk_hits"] >= 1
    assert s["prefix_host_hits"] == 0
    assert res["tokens"] == first["tokens"]
    _clean(again)


def test_engine_cache_off_tokens_identical(weights, tmp_path):
    _, _, model, params, page_nbytes = weights
    vocab = model.cfg.vocab
    with torch.inference_mode():
        off = Engine(model, params, max_slots=2, page_size=4, max_len=16, n_pages=12,
                     prefill_chunk=4, prefix_sharing=True)
        on = _cache_engine(model, params, budget_bytes=3 * page_nbytes,
                           cache_dir=tmp_path)
        trace = _epoch(vocab) + _epoch(vocab, rid_base=3)
        assert on.run(trace)["tokens"] == off.run(trace)["tokens"]


def test_engine_admission_reclaims_cold_pages_under_pressure(weights):
    """Retained pages would block admission: the engine demotes cold entries
    instead of stalling, and every request completes with static serving's
    tokens."""
    _, _, model, params, page_nbytes = weights
    vocab = model.cfg.vocab
    trace = _epoch(vocab) + _epoch(vocab, seed=7, rid_base=3)
    with torch.inference_mode():
        eng = _cache_engine(model, params, budget_bytes=8 * page_nbytes, n_pages=9)
        res = eng.run(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req)
    assert res["stats"]["completed"] == len(trace)
    assert res["stats"]["prefix_demotions_host"] >= 1
    _clean(eng)


@pytest.mark.parametrize("budget_pages,n_pages,preemption", [
    (3, 12, False), (0, 12, False), (8, 9, False), (2, 7, True)])
def test_engine_cache_equals_the_reference_engine(weights, tmp_path, budget_pages,
                                                  n_pages, preemption):
    """fp32, the same weights and two epochs: the port's tokens, preempt log
    and integer counters are the JAX engine's, except ``prefix_bytes_disk``
    (the sizes of files in the port's own disk format)."""
    jcfg, jparams, model, params, page_nbytes = weights
    vocab = model.cfg.vocab
    kw = dict(max_slots=2, page_size=4, max_len=16, n_pages=n_pages, prefill_chunk=4,
              prefix_sharing=True, preemption=preemption,
              prefix_cache_budget=budget_pages * page_nbytes)
    jeng = JEngine(JLM(jcfg), jparams, prefix_cache_dir=str(tmp_path / "jax"), **kw)
    with torch.inference_mode():
        eng = Engine(model, params, prefix_cache_dir=str(tmp_path / "port"), **kw)
        for base, seed in ((0, 0), (3, 0), (6, 7)):
            want = jeng.run(_epoch(vocab, seed, base, jrepeated_prompt_trace))
            got = eng.run(_epoch(vocab, seed, base))
            assert got["tokens"] == want["tokens"]
            ints = [k for k, v in want["stats"].items() if isinstance(v, int)
                    and not isinstance(v, bool) and k != "prefix_bytes_disk"]
            assert {k: got["stats"][k] for k in ints} == \
                {k: want["stats"][k] for k in ints}
    assert eng.preempt_log == jeng.preempt_log
    assert got["stats"]["prefix_hits"] >= 1
    assert (got["stats"]["preemptions"] >= 1) == preemption


def test_engine_cache_requires_prefix_sharing(weights):
    _, _, model, params, _ = weights
    with pytest.raises(ValueError, match="prefix_sharing"):
        Engine(model, params, max_slots=2, page_size=4, max_len=16, prefill_chunk=4,
               prefix_cache_budget=1)


def test_serve_cli_cache_end_to_end(tmp_path):
    summary = serve.main(["--reduced", "--engine", "--device", "cpu",
                          "--requests", "2", "--prompt-len", "8", "--gen", "3",
                          "--max-slots", "2", "--page-size", "4",
                          "--prefill-chunk", "4", "--prefix-sharing",
                          "--prefix-cache-budget", str(1 << 30),
                          "--prefix-cache-dir", str(tmp_path)])
    assert summary["prefix_cache_budget"] == 1 << 30
    assert summary["prefix_cache_dir"] == str(tmp_path)
    for key in ("prefix_hits", "prefix_misses", "prefix_bytes_hbm",
                "reprefill_tokens_saved"):
        assert key in summary, key
