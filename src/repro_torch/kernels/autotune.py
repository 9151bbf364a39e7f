"""Autotuner for the kernel registry, with a persistent tuning cache.

Twin of :mod:`repro.kernels.autotune`.  Tuning has two stages: an
**analytical prior** (the same traffic model as the reference, with the
H100's rates and a fixed cost per launch) ranks every (impl, params)
candidate of a problem, then the candidates are **measured** on the card and
the winner is persisted.  Dispatch (:func:`repro_torch.kernels.ops.resolve`)
only ever *reads* the cache; measuring is :func:`tune` /
:func:`warmup_params`, which the launch script's ``--autotune`` calls.

A candidate is timed on the card's clock, not the host's: the clean-L2
yardstick of :mod:`repro_torch.kernels.timing` (CUDA events, each call
behind a read of a 512 MB buffer and a spin kernel, the median of ``iters``
calls).  A kernel of 0.01-0.2 ms timed on the host clock would be timed
mostly as its enqueue.  The buffer lives for one :func:`tune` call.

Cache file format (JSON, one file per machine)::

    {"version": 1, "kernel_hash": "<sha256 prefix over the kernel sources>",
     "entries": {"tiled_csc|m=8|k=2048|n=512|d=0.281|t=128x128|cap=48|bfloat16|cuda":
                   {"impl": "cuda_fused", "params": {...}, "us": <the winner's us>,
                    "default_us": <the untuned launch's us>, "source": "measured"}}}

Entries are keyed by layout and M bucket; ``default_us`` is the untuned
launch's time, measured beside the winner.  Every tunable is M-local
(:mod:`repro_torch.kernels.registry`), so a winner at one M bucket never
changes the order of a row's sums at another.

The file lives at ``~/.cache/repro_torch/tuning_cache.json`` unless
``REPRO_TORCH_TUNING_CACHE`` points elsewhere; the JAX package's cache
(``REPRO_TUNING_CACHE``) is another file, and neither package reads the
other's winners.  Editing any kernel source, CUDA files included, changes
``kernel_hash`` and invalidates every entry.
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import pathlib
import statistics
import time
import zlib
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.core.plan import QVALUE_BITS
from repro_torch.kernels import registry, timing
from repro_torch.kernels.registry import KernelImpl, ProblemKey

__all__ = [
    "TuningCache",
    "default_cache_path",
    "get_cache",
    "set_cache",
    "install_cache",
    "key_str",
    "predict_us",
    "rank_candidates",
    "tune",
    "lookup",
    "warmup_params",
]

CACHE_VERSION = 1
ENV_VAR = "REPRO_TORCH_TUNING_CACHE"

# Rates of the prior: the H100 SXM's published HBM rate and dense bf16
# tensor-core peak (NVIDIA data sheet, at the 700 W limit); the CPU's are
# the reference's (the prior only orders candidates, measurement fixes the
# magnitudes).
_PEAK_FLOPS = {"cpu": 5e10, "cuda": 989e12}
_MEM_BW = {"cpu": 2e10, "cuda": 3.35e12}
# Fixed cost of one kernel call on the card: about 11 us a call of the
# port's matmul wrappers, measured on an NVIDIA H100 80GB HBM3 at 700 W.
_LAUNCH_US = {"cuda": 11.0}

_VERSIONS = itertools.count()


def default_cache_path() -> pathlib.Path:
    """Cache file location: $REPRO_TORCH_TUNING_CACHE, else the user cache."""
    return _expand(os.environ.get(ENV_VAR, "~/.cache/repro_torch/tuning_cache.json"))


@functools.lru_cache(maxsize=16)
def _expand(path: str) -> pathlib.Path:
    return pathlib.Path(path).expanduser()


def key_str(key: ProblemKey) -> str:
    """Stable string form of a :class:`ProblemKey` — the cache-entry key
    (the reference's)."""
    bk, bn = key.tile
    s = (f"{key.fmt}|m={key.m}|k={key.k}|n={key.n}|d={key.density:.3f}"
         f"|t={bk}x{bn}|cap={key.cap}|{key.dtype}|{key.backend}")
    if key.qmode != "none":
        s += f"|q={key.qmode}"
    if key.mesh:
        s += f"|mesh={key.mesh}"
    return s


class TuningCache:
    """Persistent (impl, params) winners, versioned by the kernel sources.
    ``version`` changes with every change of any cache in the process (a
    new number each time: dispatch memos key on it)."""

    def __init__(self, path: pathlib.Path | str | None = None):
        self.path = pathlib.Path(path) if path else default_cache_path()
        self.kernel_hash = registry.kernel_hash()
        self.entries: dict[str, dict] = {}
        self.version = next(_VERSIONS)
        self._load()

    def _load(self) -> None:
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return
        if (raw.get("version") != CACHE_VERSION
                or raw.get("kernel_hash") != self.kernel_hash):
            return  # stale: kernels changed since these were measured
        if isinstance(raw.get("entries"), dict):
            self.entries = raw["entries"]

    def save(self) -> None:
        """Atomically persist the entries (tmp file + rename), stamped with
        the kernel-source hash so stale measurements self-invalidate."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"version": CACHE_VERSION, "kernel_hash": self.kernel_hash,
                   "entries": self.entries}
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
        tmp.replace(self.path)

    def get(self, key: ProblemKey) -> dict | None:
        """Cached winner for the problem, or None on a cold key."""
        return self.entries.get(key_str(key))

    def put(self, key: ProblemKey, impl: str, params: dict, us: float,
            source: str = "measured") -> None:
        """Record a winner (impl + params + measured microseconds)."""
        self.entries[key_str(key)] = {
            "impl": impl, "params": params, "us": us, "source": source}
        self.version = next(_VERSIONS)

    def __len__(self) -> int:
        return len(self.entries)


_CACHE: TuningCache | None = None


def get_cache() -> TuningCache:
    """Process-wide cache singleton: the one :func:`set_cache` installed,
    else the file the env variable names, opened at the first call after
    start or after ``set_cache(None)``.  Dispatch asks on every call, so
    the variable is read only when the cache is opened: after changing it,
    call ``set_cache(None)``."""
    global _CACHE
    if _CACHE is None:
        _CACHE = TuningCache()
    return _CACHE


def set_cache(cache: TuningCache | None) -> None:
    """Install the process-wide cache; None drops it, so the next
    :func:`get_cache` opens the env variable's file."""
    global _CACHE
    _CACHE = cache


def install_cache(path: str | pathlib.Path | None) -> TuningCache:
    """The cache of a ``--tuning-cache`` argument, installed so dispatch
    reads the file the caller tunes into; without a path, the default
    singleton."""
    if path:
        cache = TuningCache(path)
        set_cache(cache)
        return cache
    return get_cache()


def lookup(key: ProblemKey) -> dict | None:
    """Cache read used by the dispatcher."""
    return get_cache().get(key)


# ---------------------------------------------------------------------------
# analytical prior
# ---------------------------------------------------------------------------
def predict_us(key: ProblemKey, impl: KernelImpl, params: dict) -> float:
    """Traffic-model prediction of one candidate's time (µs): compute at
    peak against bytes at the memory rate, the larger of the two, plus a
    fixed cost per launch on the card.  Packed operands move ≈1.5·density
    of their dense bytes unquantized (16-bit value + 8-bit index), less
    when quantized; the CUDA kernels read the operand once per M block.
    No term depends on the ring's stages, so a cold cache dispatches their
    default."""
    m, k, n = key.m, key.k, key.n
    itemsize = getattr(torch, key.dtype).itemsize
    flops = 2.0 * m * k * n
    x_bytes = m * k * itemsize
    out_bytes = m * n * itemsize
    dense_w_bytes = k * n * itemsize
    peak = _PEAK_FLOPS.get(key.backend, 5e10)
    bw = _MEM_BW.get(key.backend, 2e10)
    launch = _LAUNCH_US.get(key.backend, 0.0)

    if impl.name == "torch_oracle":
        # scatter-decompress materializes the dense matrix, then a dense dot
        us = max(flops / peak, (x_bytes + 2 * dense_w_bytes + out_bytes) / bw) * 1e6
        return us + key.density * k * n * 4 / peak * 1e6
    if impl.name == "dense_ref":
        return max(flops / peak,
                   (x_bytes + dense_w_bytes + out_bytes) / bw) * 1e6 + launch
    vbytes = QVALUE_BITS.get(key.qmode, 16) / 8.0
    w_bytes = key.density * dense_w_bytes * ((vbytes + 1.0) / 2.0)
    bm = impl.canonical_params(key, params, m).get("bm", m)
    mt = max(-(-m // max(bm, 1)), 1)
    return max(flops / peak,
               (x_bytes + mt * w_bytes + out_bytes) / bw) * 1e6 + launch


def rank_candidates(key: ProblemKey) -> list[tuple[float, KernelImpl, dict]]:
    """All capable (impl, params) candidates, cheapest-predicted first (a
    stable sort: among equal predictions the param grid's order, defaults
    first)."""
    out = []
    for impl in registry.candidates(key):
        for params in impl.param_grid(key):
            out.append((predict_us(key, impl, params), impl, params))
    out.sort(key=lambda t: (t[0], -t[1].priority))
    return out


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------
def _measure(fn: Callable[[], torch.Tensor], iters: int,
             flush: torch.Tensor | None) -> float:
    """Median time of one call of ``fn`` in µs: on the card the clean-L2
    yardstick (:func:`repro_torch.kernels.timing.device_ms`, behind reads
    of ``flush``), on the CPU (``flush`` None) the host clock."""
    if flush is not None:
        return timing.device_ms(fn, flush, iters) * 1e3
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def _trials(key: ProblemKey, ranked, m: int,
            top_k: int | None) -> list[tuple[KernelImpl, dict]]:
    """The (impl, canonical params) to measure: the prior's top ``top_k``
    (all when None) and every capable impl's defaults, deduplicated on what
    the runner executes."""
    picks = [(impl, params) for _, impl, params in
             (ranked if top_k is None else ranked[:max(top_k, 1)])]
    picks += [(impl, impl.default_params(key)) for impl in registry.candidates(key)]
    out, seen = [], set()
    for impl, params in picks:
        canon = impl.canonical_params(key, params, m)
        sig = (impl.name, tuple(sorted(canon.items())))
        if sig not in seen:
            out.append((impl, canon))
            seen.add(sig)
    return out


def tune(
    x: torch.Tensor,
    w,
    *,
    backend: str | None = None,
    cache: TuningCache | None = None,
    top_k: int | None = None,
    iters: int = 9,
    measure_fn: Callable | None = None,
    force: bool = False,
    trials_out: list | None = None,
) -> dict:
    """Measure the candidates for ``x @ w`` (``x`` 2-D) and persist the
    winner; returns its cache entry.

    A warm entry returns at once unless ``force``.  The candidates are the
    prior's top ``top_k`` (every one when None: the CUDA impls' grids are
    small) and every capable impl's defaults, so a tuned choice never loses
    to the untuned launch silently.  ``measure_fn(fn) -> us`` is injectable
    for tests; ``trials_out`` receives every measured ``(impl_name, params,
    us)``.  On the card the yardstick's 512 MB buffer is allocated here and
    freed when the call returns.
    """
    cache = get_cache() if cache is None else cache
    key = registry.problem_key(w, m=x.shape[0], backend=backend)
    hit = cache.get(key)
    if hit is not None and not force:
        return hit
    flush = None
    if measure_fn is None and x.device.type == "cuda":
        flush = timing.flush_buffer(x.device)
    measure = measure_fn or functools.partial(_measure, iters=iters, flush=flush)
    ranked = rank_candidates(key)
    if not ranked:
        raise ValueError(f"no kernel impl supports {key}")
    best: tuple[float, KernelImpl, dict] | None = None
    measured: dict[tuple, float] = {}
    tracer = obs.get_tracer()
    for impl, params in _trials(key, ranked, x.shape[0], top_k):
        with tracer.span(f"measure:{impl.name}", track="autotune",
                         key=key_str(key), params=str(params)):
            us = float(measure(lambda impl=impl, params=params: impl.run(
                x, w, out_dtype=x.dtype, **params)))
        if trials_out is not None:
            trials_out.append((impl.name, dict(params), us))
        measured[(impl.name, tuple(sorted(params.items())))] = us
        if best is None or us < best[0]:
            best = (us, impl, params)
    us, impl, params = best
    cache.put(key, impl.name, params, us)
    # the winner impl's untuned launch, as measured in this same call
    default = impl.canonical_params(key, impl.default_params(key), x.shape[0])
    cache.entries[key_str(key)]["default_us"] = measured[
        (impl.name, tuple(sorted(default.items())))]
    cache.save()
    return cache.get(key)


# ---------------------------------------------------------------------------
# model-level warmup (what launch --autotune calls)
# ---------------------------------------------------------------------------
def _packed_leaves(tree):
    from repro_torch.core.formats import BlockCSR, TiledCSC

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _packed_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _packed_leaves(v)
    elif isinstance(tree, (TiledCSC, BlockCSR)):
        yield tree


def _layout_sig(w) -> tuple:
    """What a packed operand's tuning depends on: format, shape, capacity,
    value dtype, tile (and br), qmode."""
    slot = (w.cap,) if registry.format_of(w) == "tiled_csc" else (w.bcap, w.br)
    return (registry.format_of(w), tuple(w.shape), *slot, str(w.dtype),
            tuple(w.tile), w.qmode)


def tune_layouts(operands: dict[tuple, tuple], m_values, *, backend=None,
                 cache: TuningCache | None = None, iters: int = 9,
                 seed: int = 0) -> dict:
    """Tune each ``{signature: (operand, x dtype)}`` at every M of
    ``m_values``.  ``x`` is random, drawn on the operand's
    device from ``seed`` and the signature, in the given dtype, or with
    None the operand's value dtype (bf16 for a quantized one).  Returns
    ``{"tuned": n_measured, "cached": n_hits}``."""
    cache = get_cache() if cache is None else cache
    stats = {"tuned": 0, "cached": 0}
    for sig, (w, dtype) in operands.items():
        dtype = dtype or (w.dtype if w.qmode == "none" else torch.bfloat16)
        for m in sorted({int(v) for v in m_values}):
            if cache.get(registry.problem_key(w, m=m, backend=backend)) is not None:
                stats["cached"] += 1
                continue
            gen = torch.Generator(device=w.device)
            gen.manual_seed((seed + zlib.crc32(repr(sig).encode()) ^ m) % (2**31))
            x = torch.randn(m, w.shape[0], generator=gen, device=w.device).to(dtype)
            tune(x, w, backend=backend, cache=cache, iters=iters)
            stats["tuned"] += 1
    return stats


def warmup_params(params, m_values: tuple[int, ...], *, backend: str | None = None,
                  cache: TuningCache | None = None, iters: int = 9,
                  seed: int = 0) -> dict:
    """Tune every distinct packed-weight layout of a parameter tree at every
    M of ``m_values``: the layers of a model share one entry per layout (a
    stacked operand is tuned on its first layer, what dispatch sees).
    Returns ``{"tuned": n_measured, "cached": n_hits}``."""
    seen: dict[tuple, tuple] = {}
    for leaf in _packed_leaves(params):
        while leaf.lead:
            leaf = leaf.layer(0)
        seen.setdefault(_layout_sig(leaf), (leaf, None))
    return tune_layouts(seen, m_values, backend=backend, cache=cache,
                        iters=iters, seed=seed)
