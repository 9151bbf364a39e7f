"""The port's continuous-batching engine: its copied page pool, scheduler
and trace against the JAX package's, its tokens against the port's
``static_generate`` (bit for bit, on the reduced llama in dense,
``tiled_csc`` and ``block_csr``, with fused and with chunked prefill) and
against the JAX package's ``Engine`` on the same weights in fp32, its
admission rules, its refusals, and ``serve.py --engine`` on the CPU.

Weights come from the JAX initialiser and are carried across with
``repro_torch.interop``; each package prunes and packs them itself (the
packings are bit-equal, ``tests/test_torch_model.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import sod as jsod
from repro.models.model import LM as JLM
from repro.serving import Engine as JEngine
from repro.serving import PagePool as JPagePool
from repro.serving import poisson_trace as jpoisson_trace
from repro_torch import configs
from repro_torch.core import sod
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.model import LM
from repro_torch.serving import (Engine, PagePool, PoolExhausted, Request,
                                 bucket_len, poisson_trace, static_generate)

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


@pytest.mark.parametrize("flag,value,stage", [
    ("preemption", True, "stage 2"), ("prefix_sharing", True, "stage 2"),
    ("spec_k", 2, "stage 3"), ("draft_params", {}, "stage 3"),
    ("prefix_cache_budget", 1 << 20, "stage 4"),
    ("prefix_cache_dir", "cache", "stage 4")])
def test_engine_refuses_unported_stages(weights, flag, value, stage):
    model, params = _small(weights)
    with pytest.raises(NotImplementedError, match=f"not ported yet.*{stage}"):
        Engine(model, params, max_len=16, **{flag: value})


@pytest.mark.parametrize("argv", [["--preemption"], ["--prefix-sharing"],
                                  ["--spec-decode", "2"],
                                  ["--prefix-cache-budget", "1024"],
                                  ["--prefix-cache-dir", "d"]])
def test_serve_refuses_unported_engine_flags(argv, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--engine", "--device", "cpu", *argv])
    assert "not ported yet" in capsys.readouterr().err


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
