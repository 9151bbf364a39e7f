"""The port's kernel registry, autotuner and dispatch (``repro_torch.kernels.
registry`` / ``autotune`` / ``ops``), mirroring ``tests/test_autotune.py``
without its VJP cases, on the CPU.

Dispatch keyed on ``cuda`` is driven with CPU tensors: the CUDA impls'
wrappers then take their plain versions, so the choice of impl and of launch
parameters is what is tested, and a stub ``measure_fn`` stands in for the
card's clock.  Each test points ``REPRO_TORCH_TUNING_CACHE`` at its own
``tmp_path``.  Numerics: every capable impl against the plain version at
atol 5e-4 / rtol 1e-4 in float32 (the reference's tolerance; the CPU path
of every impl is the plain version itself).
"""
import json
import shutil

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro_torch.core import plan as plan_mod
from repro_torch.core import sod
from repro_torch.core.formats import TiledCSC, pack_block_csr, pack_tiled_csc
from repro_torch.core.plan import ModelPlan, PackPlan
from repro_torch.core.pruning import block_prune, random_sparse
from repro_torch.core.sod import SoDConfig
from repro_torch.kernels import autotune, block_matmul, ops, ref, registry
from repro_torch.kernels import sod_matmul as sm

ATOL, RTOL = 5e-4, 1e-4


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path, monkeypatch):
    """A cold tuning cache of this test's own, as the process default."""
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    autotune.set_cache(None)
    cache = autotune.get_cache()
    yield cache
    autotune.set_cache(None)


def _packed(shape=(256, 256), density=0.3, fmt="tiled_csc", seed=0):
    g = torch.Generator().manual_seed(seed)
    w = random_sparse(g, shape, density)
    if fmt == "block_csr":
        w = block_prune(w, density)
        return w, pack_block_csr(w)
    return w, pack_tiled_csc(w)


def _x(m, k, seed=1):
    return torch.randn(m, k, generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# registry dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
def test_cpu_cold_cache_dispatches_torch_oracle(fmt):
    _, p = _packed(fmt=fmt)
    impl, params = registry.choose(registry.problem_key(p, m=64))
    assert impl.name == "torch_oracle" and params == {}
    with registry.record_dispatches() as log:
        ops.sod_matmul(_x(8, 256), p)
    assert registry.dispatch_counts(log) == {"torch_oracle[prior]": 1}


@pytest.mark.parametrize("fmt,name", [("tiled_csc", "cuda_fused"),
                                      ("block_csr", "cuda_block")])
def test_cuda_cold_cache_dispatches_the_kernel_at_its_defaults(fmt, name):
    """A cold cache on the card launches what the wrappers launch untuned:
    the widest M block (clamped to M by the wrapper) and 8 stages; the CTAs
    per SM are the wrappers' own, not a parameter."""
    _, p = _packed(fmt=fmt)
    for m in (1, 4, 48, 128):
        key = registry.problem_key(p, m=m, backend="cuda")
        assert [i.name for i in registry.candidates(key)] == [name]
        impl, params = registry.choose(key)
        assert impl.name == name
        assert params == impl.default_params(key)
        assert "ctas_per_sm" not in params and params["max_stages"] == 8
        canon = impl.canonical_params(key, params, m)
        assert canon["bm"] == sm.m_block(m, None, (4, 8, 32) if fmt == "tiled_csc"
                                         else block_matmul.M_BLOCKS)


def test_torch_oracle_is_cpu_only():
    _, p = _packed()
    oracle = registry.get_impl("torch_oracle")
    assert oracle.backends == ("cpu",)
    assert not oracle.supports(registry.problem_key(p, m=4, backend="cuda"))
    meta = TiledCSC(vals=p.vals.to("meta"), rows=p.rows.to("meta"), shape=p.shape,
                    tile=p.tile)
    with pytest.raises(RuntimeError, match="CPU only"):
        oracle.run(_x(4, 256).to("meta"), meta)


def test_forced_impls_and_the_reference_spellings():
    w, p = _packed()
    x = _x(8, 256)
    for impl, name in (("jnp", "torch_oracle"), ("cuda", "cuda_fused"),
                       ("pallas", "cuda_fused")):
        with registry.record_dispatches() as log:
            y = ops.sod_matmul(x, p, impl=impl)
        assert (log[-1]["impl"], log[-1]["source"]) == (name, "forced")
        np.testing.assert_allclose(y.numpy(), (x @ w).numpy(), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.sod_matmul(x, p, impl="xla")


def test_every_capable_impl_matches_ref():
    for fmt in ("tiled_csc", "block_csr"):
        _, p = _packed((300, 260), 0.25, fmt, seed=3)
        x = _x(24, 300, seed=2)
        want = ref.sod_matmul_ref(x, p)
        for backend in ("cpu", "cuda"):
            key = registry.problem_key(p, m=24, backend=backend)
            for impl in registry.candidates(key):
                for params in impl.param_grid(key):
                    y = impl.run(x, p, out_dtype=x.dtype, **params)
                    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=ATOL,
                                               rtol=RTOL, err_msg=f"{impl.name} {params}")


def test_backend_override_keys_dispatch_on_cuda():
    """The override keys CPU tensors' dispatch on ``cuda`` (the CPU
    rehearsal of a card run): the CUDA impl is chosen, and its wrapper
    runs the plain version on the CPU tensor."""
    w, p = _packed()
    x = _x(4, 256)
    registry.set_backend_override("cuda")
    try:
        with registry.record_dispatches() as log:
            y = ops.sod_matmul(x, p)
    finally:
        registry.set_backend_override(None)
    assert registry.dispatch_counts(log) == {"cuda_fused[prior]": 1}
    np.testing.assert_allclose(y.numpy(), (x @ w).numpy(), atol=ATOL, rtol=RTOL)
    assert registry.current_backend(x.device) == "cpu"
    with pytest.raises(ValueError, match="unknown backend"):
        registry.set_backend_override("tpu")


def test_count_dispatches_counts_what_the_record_holds():
    """serve's count-only record gives what dispatch_counts makes of the
    full record, nested or not, and keeps no record of its own."""
    _, p = _packed()
    x = _x(4, 256)
    with registry.count_dispatches() as counts, registry.record_dispatches() as log:
        for impl in ("auto", "cuda", "auto"):
            ops.sod_matmul(x, p, impl=impl)
        with registry.count_dispatches() as inner:
            ops.sod_matmul(x, p, impl="jnp")
    assert counts == registry.dispatch_counts(log) == {"torch_oracle[prior]": 2,
                                                       "cuda_fused[forced]": 1,
                                                       "torch_oracle[forced]": 1}
    assert inner == {"torch_oracle[forced]": 1}
    ops.sod_matmul(x, p)
    assert sum(counts.values()) == 4 and not registry._DISPATCH_COUNTS


def test_dense_bypass():
    w = torch.randn(64, 32)
    x = _x(5, 64)
    with registry.record_dispatches() as log:
        y = ops.sod_matmul(x, w)
    assert not log
    torch.testing.assert_close(y, x @ w)


def test_problem_key_matches_the_reference_key_strings():
    """Same layout facts, same key string shape as the reference's (the
    backend word aside), so a cache dump reads the same in both packages."""
    _, p = _packed()
    key = registry.problem_key(p, m=5, backend="cpu")
    assert autotune.key_str(key) == (
        f"tiled_csc|m=8|k=256|n=256|d={key.density:.3f}|t=128x128|cap={p.cap}"
        "|float32|cpu")
    assert registry.problem_key(p, m=129, backend="cpu").m == 256


# ---------------------------------------------------------------------------
# plan hints, tuned entries, and parameters that keep a row's sums
# ---------------------------------------------------------------------------
def test_tuned_entry_is_used_and_plan_hints_never_override_it(tmp_cache):
    w, p = _packed()
    entry = PackPlan(mode="tiled_csc", shape=(256, 256), cap=p.cap,
                     dispatch_params={"bm": 8, "max_stages": 4}, dtype="float32")
    mp = ModelPlan({".w": entry})
    x = _x(16, 256)
    # cold cache: the hint seeds dispatch
    with plan_mod.use_plan(mp), registry.record_dispatches() as log:
        sod.apply(x, p, backend="cuda")
    assert log[-1]["impl"] == "cuda_fused" and log[-1]["source"] == "prior"
    assert log[-1]["params"]["bm"] == 8 and log[-1]["params"]["max_stages"] == 4
    # a tuned winner at this (layout, M): the hint must not override it
    key = registry.problem_key(p, m=16, backend="cuda")
    tmp_cache.put(key, "cuda_fused", {"bm": 32, "max_stages": 2}, us=1.0)
    with plan_mod.use_plan(mp), registry.record_dispatches() as log2:
        y = sod.apply(x, p, backend="cuda")
    assert log2[-1]["source"] == "tuned"
    assert log2[-1]["params"]["bm"] == 32 and log2[-1]["params"]["max_stages"] == 2
    np.testing.assert_allclose(y.numpy(), (x @ w).numpy(), atol=ATOL, rtol=RTOL)
    # explicit params win over both
    with registry.record_dispatches() as log3:
        ops.sod_matmul(x, p, backend="cuda", params={"max_stages": 8})
    assert log3[-1]["params"]["max_stages"] == 8


def test_reference_plan_hint_keys_are_dropped():
    """A reference plan's TPU hint (bm=128, slot_chunk, k_slab): the keys
    outside the CUDA impl's space are dropped, and bm lands on a compiled
    M block at every M."""
    _, p = _packed()
    hint = {"bm": 128, "slot_chunk": 8, "k_slab": 0}
    for m, want in ((1, 4), (4, 4), (6, 8), (40, 32), (128, 32)):
        key = registry.problem_key(p, m=m, backend="cuda")
        impl, params = ops.resolve(key, "auto", fallback_params=hint)
        assert set(params) == {"bm", "max_stages"}
        assert params["bm"] == 128
        assert impl.canonical_params(key, params, m)["bm"] == want
        assert sm.plan_launch(m, 2, 2, p.cap, (128, 128), 4, 4, 132,
                              bm=params["bm"]).bm == want
    _, pb = _packed(fmt="block_csr")
    key = registry.problem_key(pb, m=40, backend="cuda")
    impl, params = ops.resolve(key, "auto", fallback_params=hint)
    assert "slot_chunk" not in params and "k_slab" not in params
    assert impl.canonical_params(key, params, 40)["bm"] == 16


@pytest.mark.parametrize("kt,nt", [(16, 16), (16, 4), (16, 64), (64, 16), (3, 2)])
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
def test_no_tunable_changes_the_k_splits(fmt, kt, nt):
    """Every tunable is M-local: at every point of the CUDA impl's grid and
    every M, the launch plan splits K as the untuned launch at M = 1 does,
    so a row's sums run in one order whatever was tuned at which M."""
    _, p = _packed(fmt=fmt)
    key = registry.problem_key(p, m=4, backend="cuda")
    impl = registry.candidates(key)[0]
    assert set(impl.param_space(key)) <= {"bm", "m_groups", "max_stages"}
    if fmt == "tiled_csc":
        def plan(m, **launch):
            return sm.plan_launch(m, kt, nt, 48, (128, 128), 2, 2, 132, **launch)
    else:
        def plan(m, **launch):
            return block_matmul.plan_launch(m, kt, nt, 6, 8, (128, 128), 2, 2, 132,
                                            **launch)
    want = plan(1).splits
    for point in impl.param_grid(key):
        for m in (1, 4, 8, 16, 40, 64, 128, 300):
            assert plan(m, **point).splits == want, (point, m)


def test_dispatch_memo_follows_the_cache(tmp_cache):
    _, p = _packed()
    key = registry.problem_key(p, m=4, backend="cuda")
    assert ops.resolve(key, "auto")[1]["max_stages"] == 8
    tmp_cache.put(key, "cuda_fused", {"bm": 4, "max_stages": 2}, us=1.0)
    assert ops.resolve(key, "auto")[1]["max_stages"] == 2
    other = autotune.TuningCache(tmp_cache.path.with_name("other.json"))
    autotune.set_cache(other)
    assert ops.resolve(key, "auto")[1]["max_stages"] == 8


def test_apply_honors_plan_impl_hint():
    w, p = _packed((256, 256), 0.3)
    x = _x(8, 256)
    for hint, name in (("jnp", "torch_oracle"), ("pallas", "cuda_fused")):
        entry = PackPlan(mode="tiled_csc", shape=(256, 256), cap=p.cap, impl=hint,
                         dtype="float32")
        with registry.record_dispatches() as log:
            y = sod.apply(x, p, plan=entry)
        assert (log[-1]["impl"], log[-1]["source"]) == (name, "forced")
        np.testing.assert_allclose(y.numpy(), (x @ w).numpy(), atol=ATOL, rtol=RTOL)
    # a caller's explicit impl disables the plan's hint
    with registry.record_dispatches() as log:
        sod.apply(x, p, plan=entry, impl="auto")
    assert log[-1]["source"] == "prior"


def test_active_plan_layout_lookup_and_params():
    w, p = _packed((256, 384), 0.3)
    entry = PackPlan(mode="tiled_csc", shape=(256, 384), cap=p.cap, impl="pallas",
                     dispatch_params={"bm": 8}, dtype="float32")
    mp = ModelPlan({".blocks.mlp.w_gate": entry})
    x = _x(16, 256)
    with plan_mod.use_plan(mp), registry.record_dispatches() as log:
        y = sod.apply(x, p)
    assert log[-1]["impl"] == "cuda_fused" and log[-1]["params"]["bm"] == 8
    np.testing.assert_allclose(y.numpy(), (x @ w).numpy(), atol=ATOL, rtol=RTOL)
    with registry.record_dispatches() as log2:
        sod.apply(x, p)
    assert log2[-1]["source"] != "forced"


# ---------------------------------------------------------------------------
# tuning cache and the tuner
# ---------------------------------------------------------------------------
def test_cache_roundtrip_warm_run_skips_measurement(tmp_cache):
    _, p = _packed((256, 256), 0.3, seed=11)
    x = _x(32, 256)
    calls = []

    def counting(fn):
        calls.append(1)
        fn()
        return float(len(calls))

    entry = autotune.tune(x, p, cache=tmp_cache, measure_fn=counting)
    assert calls and entry["impl"] == "torch_oracle"
    n_cold = len(calls)
    autotune.tune(x, p, cache=tmp_cache, measure_fn=counting)
    assert len(calls) == n_cold
    reloaded = autotune.TuningCache(tmp_cache.path)
    assert len(reloaded) == len(tmp_cache)
    autotune.tune(x, p, cache=reloaded, measure_fn=counting)
    assert len(calls) == n_cold
    autotune.set_cache(reloaded)
    key = registry.problem_key(p, m=32)
    assert registry.choose(key, tuned=autotune.lookup(key))[0].name == entry["impl"]


def test_tune_on_cuda_never_ranks_the_oracle_and_dedups(tmp_cache):
    """Keyed on cuda (a stub clock), only the CUDA impl is measured, every
    trial once on what the wrapper executes, the default launch among them;
    at M = 4 every M block clamps to 4."""
    _, p = _packed((256, 256), 0.3, seed=19)
    trials = []
    entry = autotune.tune(_x(4, 256), p, backend="cuda", cache=tmp_cache,
                          measure_fn=lambda fn: 1.0, trials_out=trials)
    names = {name for name, _, _ in trials}
    assert names == {"cuda_fused"}
    sigs = [tuple(sorted(params.items())) for _, params, _ in trials]
    assert len(sigs) == len(set(sigs))
    assert {params["bm"] for _, params, _ in trials} == {4}
    assert len(trials) == 3              # stages
    key = registry.problem_key(p, m=4, backend="cuda")
    fused = registry.get_impl("cuda_fused")
    assert fused.canonical_params(key, fused.default_params(key), 4) in [
        params for _, params, _ in trials]
    assert entry["impl"] == "cuda_fused"


def test_tune_sweeps_each_m_bucket_on_its_own(tmp_cache):
    """Each M bucket sweeps the whole M-local grid and keeps its own
    winner, with the untuned launch's time beside it."""
    _, p = _packed((256, 384), 0.3, seed=5)
    times = iter(range(1000, 0, -1))       # later trials measure faster
    small, large = [], []
    autotune.tune(_x(4, 256), p, backend="cuda", cache=tmp_cache,
                  measure_fn=lambda fn: float(next(times)), trials_out=small)
    autotune.tune(_x(128, 256), p, backend="cuda", cache=tmp_cache,
                  measure_fn=lambda fn: float(next(times)), trials_out=large)
    assert len(small) == 3               # stages; every M block clamps to 4
    assert {params["bm"] for _, params, _ in large} == {4, 8, 32}
    assert len(large) == 3 * 3           # M blocks x stages
    for m, trials in ((4, small), (128, large)):
        entry = tmp_cache.get(registry.problem_key(p, m=m, backend="cuda"))
        assert entry["params"] == trials[-1][1] and entry["us"] == trials[-1][2]
        assert entry["default_us"] == trials[0][2]       # defaults measured first
    saved = json.loads(tmp_cache.path.read_text())
    assert set(saved) == {"version", "kernel_hash", "entries"}


def test_block_trials_canonicalize_row_groups(tmp_cache):
    _, p = _packed((256, 256), 0.3, "block_csr", seed=7)
    trials = []
    autotune.tune(_x(40, 256), p, backend="cuda", cache=tmp_cache,
                  measure_fn=lambda fn: 1.0, trials_out=trials)
    assert {name for name, _, _ in trials} == {"cuda_block"}
    for _, params, _ in trials:
        if params["bm"] != 16:
            assert params["m_groups"] == 1
        else:
            assert params["m_groups"] <= 3         # ceil(40 / 16)


def test_cache_invalidated_by_kernel_hash(tmp_cache):
    _, p = _packed((256, 256), 0.3, seed=13)
    autotune.tune(_x(32, 256), p, cache=tmp_cache, measure_fn=lambda fn: 1.0)
    assert len(tmp_cache) == 1
    raw = json.loads(tmp_cache.path.read_text())
    raw["kernel_hash"] = "0" * 16
    tmp_cache.path.write_text(json.dumps(raw))
    assert len(autotune.TuningCache(tmp_cache.path)) == 0


def test_editing_a_cuda_source_changes_kernel_hash(tmp_path, monkeypatch):
    pkg = tmp_path / "kernels"
    shutil.copytree(registry.__file__.rsplit("/", 1)[0], pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(registry, "__file__", str(pkg / "registry.py"))
    before = registry.kernel_hash()
    cu = pkg / "csrc" / "sod_matmul.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    after = registry.kernel_hash()
    assert before != after
    cuh = pkg / "csrc" / "common.cuh"
    cuh.write_text(cuh.read_text() + "\n")
    assert registry.kernel_hash() != after


def test_set_cache_pins_and_env_path(tmp_path, monkeypatch):
    assert autotune.default_cache_path() == tmp_path / "tuning_cache.json"
    pinned = autotune.TuningCache(tmp_path / "pinned.json")
    autotune.set_cache(pinned)
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "elsewhere.json"))
    assert autotune.get_cache() is pinned
    autotune.set_cache(None)
    assert autotune.get_cache().path == tmp_path / "elsewhere.json"
    # the variable is read when the cache is opened, not on every dispatch
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "later.json"))
    assert autotune.get_cache().path == tmp_path / "elsewhere.json"
    autotune.set_cache(None)
    assert autotune.get_cache().path == tmp_path / "later.json"
    assert autotune.install_cache(tmp_path / "cli.json").path == tmp_path / "cli.json"
    assert autotune.get_cache().path == tmp_path / "cli.json"


def test_the_two_packages_keep_separate_caches(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE")
    monkeypatch.delenv("REPRO_TUNING_CACHE", raising=False)
    assert autotune.default_cache_path() != jautotune.default_cache_path()
    assert "repro_torch" in str(autotune.default_cache_path())


def test_warmup_params_covers_packed_tree(tmp_cache):
    cfg = SoDConfig(mode="tiled_csc", density=0.5, min_dim=64)
    g = torch.Generator().manual_seed(0)
    params = {"layers": [{"wq": sod.pack_param(random_sparse(g, (128, 128), 0.5), cfg,
                                               prune=False),
                          "w_up": sod.pack_param(random_sparse(g, (128, 256), 0.5),
                                                 cfg, prune=False),
                          "bias": torch.zeros(128)}]}
    stats = autotune.warmup_params(params, (16, 4), cache=tmp_cache)
    assert stats == {"tuned": 4, "cached": 0}
    assert autotune.warmup_params(params, (16,), cache=tmp_cache) == {"tuned": 0,
                                                                       "cached": 2}


# ---------------------------------------------------------------------------
# property: tuned dispatch ≡ the plain version across formats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
@pytest.mark.parametrize("m", [1, 8, 33])
def test_tuned_dispatch_matches_ref(fmt, m, tmp_cache):
    w, p = _packed((192, 320), 0.2, fmt, seed=m)
    x = _x(m, 192, seed=m)
    for backend in ("cpu", "cuda"):
        autotune.tune(x, p, backend=backend, cache=tmp_cache,
                      measure_fn=lambda fn: float(np.random.default_rng(m).random()))
        y = ops.sod_matmul(x, p, backend=backend)
        np.testing.assert_allclose(y.numpy(), ref.sod_matmul_ref(x, p).numpy(),
                                   atol=ATOL, rtol=RTOL)
