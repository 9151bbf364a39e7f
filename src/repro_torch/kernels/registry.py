"""Kernel registry: every matmul implementation, with its capabilities.

Twin of :mod:`repro.kernels.registry`.  The Sparse-on-Dense datapath has
several realizations — the fused decompress + matmul CUDA kernel, the block
kernel with zero-macro-tile skip, the plain PyTorch version, the dense
bypass — and each registers itself here with

  * a **capability predicate** (``supports``): which backends, formats and
    qmodes it can run at all;
  * a **tunable-parameter space** (``param_space``): the launch parameters
    the autotuner may sweep, the defaults first;
  * a **runner** that takes a 2-D ``x`` and the packed operand.

:mod:`repro_torch.kernels.autotune` consumes the registry to measure
candidates and persist the winners; :func:`repro_torch.kernels.ops.sod_matmul`
consults it on every call (a dict lookup once resolved; nothing is measured
there).

Backends are ``cuda`` and ``cpu``.  The CUDA impls run the hand-written
kernels; on a CPU tensor their wrappers take the plain version (which is
how the CPU tests drive dispatch keyed on ``cuda``).  The plain version,
``torch_oracle``, lists ``cpu`` only: neither the prior nor a measurement
can route a CUDA tensor through it, and its runner raises on one.

Every tunable of a CUDA impl is M-local: the M block, the ring's stage cap
and the block kernel's row groups may differ per M bucket, because they
change how rows share a CTA and never the K splits, which set the order of
a row's sums.  The splits come from a fixed count of CTAs per SM
(``CTAS_PER_SM`` of the wrappers), so a row computed alone equals the same
row in any batch whatever was tuned at either M — the serving engine's
equality with static serving rests on that.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import pathlib
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.core.formats import BlockCSR, TiledCSC

__all__ = [
    "KernelImpl",
    "ProblemKey",
    "register",
    "get_impl",
    "candidates",
    "choose",
    "problem_key",
    "format_of",
    "current_backend",
    "set_backend_override",
    "kernel_hash",
    "record_dispatches",
    "count_dispatches",
    "note_dispatch",
    "dispatch_counts",
]

BACKENDS = ("cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class ProblemKey:
    """Static description of one matmul problem — everything dispatch may
    depend on (density is a pack-time proxy: the slots a tile column holds
    over its rows, rounded to 1/32 so nearby packs share a cache entry)."""

    fmt: str                 # tiled_csc | block_csr | dense
    m: int
    k: int
    n: int
    density: float           # static proxy (cap/bk fill ratio), NOT data nnz
    dtype: str
    backend: str

    # format-specific static layout facts the param spaces need
    tile: tuple[int, int] = (128, 128)
    cap: int = 0             # TiledCSC slot capacity / BlockCSR bcap*br
    kt: int = 1              # K-tile grid size
    qmode: str = "none"      # value quantization of the packed operand
    # the reference's SPMD mesh signature; the port has no mesh pass yet,
    # so it stays empty (kept so the two packages' keys have one shape)
    mesh: str = ""

    @functools.cached_property
    def _hash(self) -> int:
        return hash(dataclasses.astuple(self))

    def __hash__(self) -> int:
        # computed once: dispatch hashes a key on every call
        return self._hash


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One registered implementation."""

    name: str
    formats: tuple[str, ...]
    backends: tuple[str, ...]
    priority: int            # tie-break when the prior can't separate
    param_space: Callable[[ProblemKey], dict[str, tuple]]
    run: Callable[..., torch.Tensor]   # run(x2, w, out_dtype=?, **params)
    # maps requested params to what the runner executes at a concrete M
    # (the M block clamped onto the compiled blocks, row groups only where
    # the block holds them); the autotuner dedups trials on this
    canonicalize: Callable[[ProblemKey, dict, int], dict] | None = None
    qmodes: tuple[str, ...] = ("none", "int8", "fp8", "codebook")

    def supports(self, key: ProblemKey) -> bool:
        """Whether this impl can run the problem (format, backend, qmode)."""
        return (key.fmt in self.formats and key.backend in self.backends
                and key.qmode in self.qmodes)

    def canonical_params(self, key: ProblemKey, params: dict, m: int) -> dict:
        """Params as the runner executes them at concrete ``m``."""
        if self.canonicalize is None:
            return dict(params)
        return self.canonicalize(key, params, m)

    def default_params(self, key: ProblemKey) -> dict:
        """First element of every axis of the param space: the launch the
        wrappers make when asked for nothing (kept first on purpose, so the
        tuner always measures the status quo)."""
        return {k: v[0] for k, v in self.param_space(key).items()}

    def param_grid(self, key: ProblemKey) -> list[dict]:
        """Cartesian product of the impl's param space."""
        grid: list[dict] = [{}]
        for name, values in self.param_space(key).items():
            grid = [dict(g, **{name: v}) for g in grid for v in values]
        return grid


_REGISTRY: dict[str, KernelImpl] = {}
_BACKEND_OVERRIDE: str | None = None


def register(impl: KernelImpl) -> KernelImpl:
    """Add an impl to the global registry (returns it, decorator-style)."""
    _REGISTRY[impl.name] = impl
    return impl


def get_impl(name: str) -> KernelImpl:
    """Look up a registered impl by name; KeyError lists what exists."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no kernel impl {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def candidates(key: ProblemKey) -> list[KernelImpl]:
    """All implementations able to run this problem, best-priority first."""
    out = [i for i in _REGISTRY.values() if i.supports(key)]
    return sorted(out, key=lambda i: -i.priority)


def current_backend(device: torch.device | str | None = None) -> str:
    """Dispatch backend: the override, else the device's type (``cuda`` or
    ``cpu``), else ``cuda`` when a card is present."""
    if _BACKEND_OVERRIDE is not None:
        return _BACKEND_OVERRIDE
    kind = getattr(device, "type", device)
    if kind in BACKENDS:
        return kind
    return "cuda" if torch.cuda.is_available() else "cpu"


def set_backend_override(backend: str | None) -> None:
    """Force the dispatch backend (tests).  None resets."""
    global _BACKEND_OVERRIDE
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    _BACKEND_OVERRIDE = backend


def format_of(w) -> str:
    """Operand's packed format name: tiled_csc, block_csr, or dense."""
    if isinstance(w, TiledCSC):
        return "tiled_csc"
    if isinstance(w, BlockCSR):
        return "block_csr"
    return "dense"


def _m_bucket(m: int) -> int:
    """Bucket M to the next power of two (≥8) so decode and prefill tune
    separately but nearby batch sizes share entries."""
    b = 8
    while b < m:
        b *= 2
    return b


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def problem_key(w, m: int, backend: str | None = None,
                mesh: str = "") -> ProblemKey:
    """The dispatch/tuning identity of one matmul: operand layout (format,
    K/N, static density, dtype, tile, capacity, qmode) × bucketed M ×
    backend.  Everything the cache keys on, nothing value-dependent."""
    backend = backend or current_backend(w.device)
    if isinstance(w, TiledCSC):
        slot, br = w.vals.shape[-2], 0
    elif isinstance(w, BlockCSR):
        slot, br = w.block_vals.shape[-3], w.br
    else:
        return _key("dense", int(w.shape[-2]), int(w.shape[-1]), (128, 128), 0, 0,
                    w.dtype, "none", _m_bucket(m), backend, mesh)
    return _key(format_of(w), *w.shape, tuple(w.tile), slot, br, w.dtype, w.qmode,
                _m_bucket(m), backend, mesh)


@functools.lru_cache(maxsize=None)
def _key(fmt, k, n, tile, slot, br, dtype, qmode, m, backend, mesh) -> ProblemKey:
    """One ProblemKey object per problem (dispatch asks on every call)."""
    if fmt == "dense":
        return ProblemKey(fmt, m, k, n, 1.0, _dtype_name(dtype), backend, mesh=mesh)
    cap = slot if fmt == "tiled_csc" else slot * br
    density = round(min(cap / tile[0], 1.0) * 32) / 32
    return ProblemKey(fmt, m, int(k), int(n), density, _dtype_name(dtype), backend,
                      tile=tile, cap=int(cap), kt=-(-int(k) // tile[0]),
                      qmode=qmode, mesh=mesh)


def choose(key: ProblemKey, tuned: dict | None = None, note: bool = True
           ) -> tuple[KernelImpl, dict]:
    """Resolve (impl, params) for a problem.

    ``tuned`` is a tuning-cache entry ``{"impl": ..., "params": ...}``; when
    absent (a cold cache) the cheapest candidate under the analytical prior
    of :mod:`repro_torch.kernels.autotune` runs.  ``note=False`` leaves the
    dispatch log to the caller (:func:`repro_torch.kernels.ops.resolve`
    notes what it finally runs).
    """
    if tuned is not None:
        impl = _REGISTRY.get(tuned.get("impl", ""))
        if impl is not None and impl.supports(key):
            params = dict(impl.default_params(key))
            params.update(tuned.get("params") or {})
            if note:
                note_dispatch(key, impl, params, "tuned")
            return impl, params
    from repro_torch.kernels import autotune  # deferred: autotune imports this

    ranked = autotune.rank_candidates(key)
    if not ranked:
        raise ValueError(f"no kernel impl supports {key}")
    _, impl, params = ranked[0]
    if note:
        note_dispatch(key, impl, params, "prior")
    return impl, dict(params)


# ---------------------------------------------------------------------------
# dispatch observability: what actually ran?
# ---------------------------------------------------------------------------
_DISPATCH_LOGS: list[list] = []
_DISPATCH_COUNTS: list[dict] = []


@contextlib.contextmanager
def record_dispatches(log: list | None = None):
    """Collect ``{"key", "impl", "params", "source"}`` dicts for every
    dispatch made while the context is active (source is ``tuned`` /
    ``prior`` / ``forced``)."""
    log = [] if log is None else log
    _DISPATCH_LOGS.append(log)
    try:
        yield log
    finally:
        for i, entry in enumerate(_DISPATCH_LOGS):
            if entry is log:     # identity: equal nested logs must not collide
                del _DISPATCH_LOGS[i]
                break


@contextlib.contextmanager
def count_dispatches(counts: dict | None = None):
    """Count the dispatches made while the context is active per
    ``impl[source]``, as :func:`dispatch_counts` gives them, and record
    nothing else: what serving keeps for its summary, at a dict update a
    call."""
    counts = {} if counts is None else counts
    _DISPATCH_COUNTS.append(counts)
    try:
        yield counts
    finally:
        for i, entry in enumerate(_DISPATCH_COUNTS):
            if entry is counts:
                del _DISPATCH_COUNTS[i]
                break


def note_dispatch(key: ProblemKey, impl: KernelImpl, params: dict,
                  source: str) -> None:
    """Record one dispatch into every active :func:`record_dispatches` log
    and :func:`count_dispatches` count and, when tracing is on, as an
    instant event on the ``kernels`` track."""
    if _DISPATCH_COUNTS:
        label = f"{impl.name}[{source}]"
        for counts in _DISPATCH_COUNTS:
            counts[label] = counts.get(label, 0) + 1
    for log in _DISPATCH_LOGS:
        log.append({"key": key, "impl": impl.name, "params": dict(params),
                    "source": source})
    tr = obs.get_tracer()
    if tr.enabled:
        tr.instant(f"{impl.name}[{source}]", track="kernels", cat="dispatch",
                   fmt=key.fmt, m=key.m, k=key.k, n=key.n,
                   backend=key.backend, source=source)


def dispatch_counts(log: list) -> dict[str, int]:
    """Dispatch totals per ``impl[source]`` for a recorded log (e.g.
    ``{"cuda_fused[tuned]": 12}``)."""
    out: dict[str, int] = {}
    for rec in log:
        k = f"{rec['impl']}[{rec['source']}]"
        out[k] = out.get(k, 0) + 1
    return out


def kernel_hash() -> str:
    """Short content hash over the kernel sources — the Python wrappers and
    the CUDA sources (``csrc/*.cu``, ``csrc/*.cuh``) — that versions the
    tuning cache: edit any of them and every persisted winner is invalid."""
    h = hashlib.sha256()
    pkg = pathlib.Path(__file__).parent
    for p in sorted([*pkg.glob("*.py"), *pkg.glob("csrc/*.cu"),
                     *pkg.glob("csrc/*.cuh")]):
        h.update(str(p.relative_to(pkg)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# built-in implementations
# ---------------------------------------------------------------------------
# Axes of the CUDA impls' param spaces, the wrappers' defaults first.  ``bm``
# is the widest compiled M block, which the wrappers clamp to the smallest
# block that holds M — the untuned launch.
_STAGES = (8, 4, 2)            # the ring's stage cap (MAX_STAGES first)


def _run_cuda_fused(x2, w, *, out_dtype=None, **launch):
    from repro_torch.kernels import sod_matmul

    return sod_matmul.sod_matmul(x2, w, out_dtype, **launch)


def _run_cuda_block(x2, w, *, out_dtype=None, **launch):
    from repro_torch.kernels import block_matmul

    return block_matmul.block_matmul(x2, w, out_dtype, **launch)


def _run_torch_oracle(x2, w, *, out_dtype=None):
    if x2.device.type != "cpu":
        raise RuntimeError(
            f"torch_oracle is the plain version and runs on the CPU only; a "
            f"{x2.device.type} tensor goes to a CUDA kernel")
    from repro_torch.kernels import ref
    from repro_torch.kernels.sod_matmul import check_operands

    # the operands the kernels would take, checked as their wrappers check
    # them (a quantized operand's codes and side band included)
    if isinstance(w, TiledCSC):
        check_operands("torch_oracle", x2, w, out_dtype or x2.dtype,
                       {"vals": w.vals, "rows": w.rows})
        return ref.sod_matmul_ref(x2, w, out_dtype)
    check_operands("torch_oracle", x2, w, out_dtype or x2.dtype,
                   {"block_vals": w.block_vals, "block_ids": w.block_ids,
                    "tile_nnz": w.tile_nnz})
    return ref.block_matmul_ref(x2, w, out_dtype)


def _run_dense(x2, w, *, out_dtype=None):
    from repro_torch.kernels import ops

    return ops.dense_matmul(x2, w, out_dtype or x2.dtype)


def _fused_space(key: ProblemKey) -> dict[str, tuple]:
    from repro_torch.kernels.sod_matmul import M_BLOCKS

    return {"bm": M_BLOCKS[::-1], "max_stages": _STAGES}


def _block_space(key: ProblemKey) -> dict[str, tuple]:
    from repro_torch.kernels.block_matmul import M_BLOCKS, M_GROUPS

    groups = tuple(dict.fromkeys((M_GROUPS, 2, 1)))
    return {"bm": M_BLOCKS[::-1], "m_groups": groups, "max_stages": _STAGES}


def _fused_canonical(key: ProblemKey, params: dict, m: int) -> dict:
    from repro_torch.kernels.sod_matmul import M_BLOCKS, m_block

    return {**params, "bm": m_block(m, params.get("bm", M_BLOCKS[-1]))}


def _block_canonical(key: ProblemKey, params: dict, m: int) -> dict:
    from repro_torch.kernels.block_matmul import M_BLOCKS, row_groups
    from repro_torch.kernels.sod_matmul import m_block

    bm = m_block(m, params.get("bm", M_BLOCKS[-1]), M_BLOCKS)
    return {**params, "bm": bm,
            "m_groups": row_groups(m, bm, key.tile[1], params.get("m_groups"))}


register(KernelImpl(
    name="cuda_fused",
    formats=("tiled_csc",),
    backends=("cuda",),
    priority=30,
    param_space=_fused_space,
    run=_run_cuda_fused,
    canonicalize=_fused_canonical,
))

register(KernelImpl(
    name="cuda_block",
    formats=("block_csr",),
    backends=("cuda",),
    priority=30,
    param_space=_block_space,
    run=_run_cuda_block,
    canonicalize=_block_canonical,
))

register(KernelImpl(
    name="torch_oracle",
    formats=("tiled_csc", "block_csr"),
    backends=("cpu",),
    priority=20,
    param_space=lambda key: {},
    run=_run_torch_oracle,
))

register(KernelImpl(
    name="dense_ref",
    formats=("dense",),
    backends=BACKENDS,
    priority=10,
    param_space=lambda key: {},
    run=_run_dense,
))
