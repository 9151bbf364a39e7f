"""Layer-wise Sparse-on-Dense packing plans.

Twin of :mod:`repro.core.plan`, whole: a :class:`PackPlan` is the per-layer
answer to "how should this weight be stored and dispatched": storage format,
tile geometry, slot capacity (``cap`` / ``bcap``), pruning settings, a
dispatch hint (impl + tuned parameters from the tuning cache), and an
optional SPMD partition plan (the planner's mesh pass fills it;
:mod:`repro_torch.runtime.spmd` runs it).  A :class:`ModelPlan` maps every packable parameter path of
a model to its :class:`PackPlan` and round-trips through JSON, so a plan
built once replays byte-identically, and a plan file written by either
package loads in the other: the paths (``.blocks.attn.wq``), the stacked
``lead`` dims ``(groups, period)`` and :data:`PLAN_VERSION` are the
reference's.

The module is dependency-free: the sizing math and the (de)serialization
live here; the code that builds plans is :mod:`repro_torch.runtime.planner`,
and :mod:`repro_torch.core.sod` consumes plans when packing
(``sodify_params`` / ``sodify_abstract``) and dispatching (``sod.apply``
reads the active plan installed with :func:`use_plan`).

Sizing is the one place abstract and concrete packing must agree
(tuning-cache keys are derived from it), so both go through the shared
functions below: :func:`tiled_cap` / :func:`block_bcap` return the
deterministic budget when no data is available and reproduce the packer's
data-dependent capacity when an observed count is supplied.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import math
import pathlib
from typing import Any

__all__ = [
    "PLAN_VERSION",
    "QMODES",
    "QVALUE_BITS",
    "SCALE_BITS",
    "CODEBOOK_SIZE",
    "PackPlan",
    "ModelPlan",
    "expected_cap",
    "tiled_cap",
    "block_bcap",
    "use_plan",
    "active_plan",
    "active_entry",
    "active_subplans",
    "lookup_active",
]

PLAN_VERSION = 1

VALUE_BITS = 16
TILED_INDEX_BITS = 8
BLOCK_INDEX_BITS = 16

#: Quantized value-storage modes (the ``qmode`` plan axis; mirrored by the
#: executable formats in :mod:`repro_torch.core.formats`).
QMODES = ("none", "int8", "fp8", "codebook")
#: Paper-accounting bits per stored value slot under each qmode — codebook
#: slots store only the index into the shared table.
QVALUE_BITS = {"none": 16, "int8": 8, "fp8": 8, "codebook": 4}
#: Bits for one per-tile scale or one codebook entry (side band).
SCALE_BITS = 16
#: Entries in the codebook's shared-value table (entry 0 reserved for 0.0).
CODEBOOK_SIZE = 16


def _align_slots(cap: int, align: int = 8) -> int:
    return max((int(cap) + align - 1) // align * align, align)


def expected_cap(bk: int, density: float) -> int:
    """Static per-column slot budget for Bernoulli(density) sparsity.

    mean + 4σ of Binomial(bk, density), sublane-aligned — the deterministic
    cap used when no weight values are available (dry-run / abstract
    packing), so shapes never depend on data.
    """
    density = min(max(float(density), 0.0), 1.0)
    mean = bk * density
    sigma = math.sqrt(max(bk * density * (1 - density), 1e-9))
    cap = min(bk, int(math.ceil(mean + 4 * sigma)))
    return _align_slots(cap)


def tiled_cap(bk: int, density: float, observed: int | None = None) -> int:
    """TiledCSC slot capacity: observed max column non-zero count when the
    planner saw concrete weights (matches ``pack_tiled_csc``'s lossless
    data-dependent cap exactly), else the deterministic budget."""
    if observed is not None:
        return _align_slots(max(int(observed), 1))
    return expected_cap(bk, density)


def block_bcap(nb: int, density: float, prune_method: str = "magnitude",
               block_elems: int = 1024, observed: int | None = None) -> int:
    """BlockCSR per-macro-tile sub-block capacity (shared sizing function).

    ``observed`` (concrete weights) reproduces ``pack_block_csr``'s
    data-dependent cap.  Otherwise the budget is mean + 4σ of
    Binomial(nb, p) where p is the sub-block survival probability: the
    target density itself under block pruning, and
    ``1 - (1-density)^block_elems`` (≈1 for any realistic density) under
    element-granular pruning — a whole (br, bn) sub-block only dies when
    every one of its ``block_elems`` entries is zero.
    """
    if observed is not None:
        return max(int(observed), 1)
    d = min(max(float(density), 0.0), 1.0)
    if prune_method == "block":
        p = d
    else:
        p = 1.0 - (1.0 - d) ** block_elems
    mean = nb * p
    sigma = math.sqrt(max(nb * p * (1 - p), 1e-9))
    return max(min(int(math.ceil(mean + 4 * sigma)), nb), 1)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """How one parameter leaf is pruned, packed, and dispatched."""

    mode: str                        # dense | tiled_csc | block_csr
    shape: tuple[int, int]           # logical (K, N) of the matrix dims
    lead: tuple[int, ...] = ()       # leading layer-stack / expert dims
    density: float = 1.0
    prune_method: str = "magnitude"
    tile: tuple[int, int] = (128, 128)
    br: int = 8
    cap: int | None = None           # TiledCSC slot capacity
    bcap: int | None = None          # BlockCSR sub-block capacity
    dtype: str = "bfloat16"
    qmode: str = "none"              # value quantization: none|int8|fp8|codebook
    impl: str = "auto"               # dispatch hint: auto | jnp | pallas
    dispatch_params: dict = dataclasses.field(default_factory=dict)
    spmd: dict | None = None         # SpmdPlan fields (runtime.spmd), or None
    note: str = ""                   # informational (chosen impl / reason)

    def __post_init__(self):
        if self.mode not in ("dense", "tiled_csc", "block_csr"):
            raise ValueError(f"unknown plan mode {self.mode!r}")
        if self.qmode not in QMODES:
            raise ValueError(f"unknown plan qmode {self.qmode!r} "
                             f"(expected one of {QMODES})")

    # -- derived layout facts ------------------------------------------------
    @property
    def grid(self) -> tuple[int, int]:
        """Tile-grid shape ``(k_tiles, n_tiles)`` over the (K, N) weight."""
        bk, bn = self.tile
        k, n = self.shape
        return _ceil_div(k, bk), _ceil_div(n, bn)

    def layout_key(self) -> tuple:
        """Identity of the packed layout this plan produces — what dispatch
        can observe from the operand alone (no parameter path)."""
        slot = self.cap if self.mode == "tiled_csc" else self.bcap
        return (self.mode, tuple(self.shape), tuple(self.tile),
                int(slot or 0), self.br if self.mode == "block_csr" else 0,
                self.qmode)

    def _lead_n(self) -> int:
        n = 1
        for d in self.lead:
            n *= int(d)
        return n

    def _qside_bytes(self, kt: int, nt: int) -> int:
        """Per-lead-slice side-band bytes of the qmode (scales / codebook)."""
        if self.qmode in ("int8", "fp8"):
            return kt * nt * SCALE_BITS // 8
        if self.qmode == "codebook":
            return CODEBOOK_SIZE * SCALE_BITS // 8
        return 0

    def compressed_bytes(self) -> int:
        """Footprint of the packed (or dense) leaf under this plan — same
        accounting as the formats' ``nbytes_compressed`` (value slots at the
        qmode's width plus the quantization side band)."""
        k, n = self.shape
        if self.mode == "dense":
            return self._lead_n() * k * n * VALUE_BITS // 8
        kt, nt = self.grid
        bk, bn = self.tile
        vbits = QVALUE_BITS[self.qmode]
        side = self._qside_bytes(kt, nt)
        if self.mode == "tiled_csc":
            cap = self.cap if self.cap is not None else tiled_cap(
                bk, self.density)
            slots = kt * nt * cap * bn
            return self._lead_n() * (
                slots * (vbits + TILED_INDEX_BITS) // 8 + side)
        bcap = self.bcap if self.bcap is not None else block_bcap(
            bk // self.br, self.density, self.prune_method, self.br * bn)
        vals = kt * nt * bcap * self.br * bn * vbits // 8
        ids = kt * nt * bcap * BLOCK_INDEX_BITS // 8
        return self._lead_n() * (vals + ids + side)

    def dense_bytes(self) -> int:
        """Footprint the same leaf would take stored dense — the baseline
        ``compressed_bytes`` is measured against."""
        k, n = self.shape
        return self._lead_n() * k * n * VALUE_BITS // 8

    def describe(self) -> str:
        """One-line human-readable summary (mode, tile, caps, impl/spmd
        hints) for plan dumps and ``ModelPlan.summary``."""
        if self.mode == "dense":
            s = "dense"
        elif self.mode == "tiled_csc":
            s = (f"tiled_csc t={self.tile[0]}x{self.tile[1]} cap={self.cap}")
        else:
            s = (f"block_csr t={self.tile[0]}x{self.tile[1]} br={self.br} "
                 f"bcap={self.bcap}")
        if self.lead:
            s += f" lead={tuple(self.lead)}"
        if self.qmode != "none":
            s += f" q={self.qmode}"
        if self.impl != "auto":
            s += f" impl={self.impl}"
        if self.dispatch_params:
            s += f" params={self.dispatch_params}"
        if self.spmd:
            parts = []
            if self.spmd.get("batch_axes"):
                parts.append("dp=" + "+".join(self.spmd["batch_axes"]))
            for f in ("col_axis", "row_axis", "gather_axis"):
                if self.spmd.get(f):
                    parts.append(f"{f.split('_')[0]}={self.spmd[f]}")
            s += f" spmd={';'.join(parts) or 'replicated'}"
        if self.note:
            s += f" ({self.note})"
        return s

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> dict:
        """JSON-safe dict, dropping empty fields (keeps plan files small
        and diffable); inverse of :meth:`from_json`."""
        d = dataclasses.asdict(self)
        if d.get("qmode") == "none":
            del d["qmode"]  # default; keeps pre-qmode plan files diff-clean
        return {k: v for k, v in d.items() if v not in (None, {}, "", ())
                or k in ("mode", "shape", "cap", "bcap")}

    @classmethod
    def from_json(cls, d: dict) -> "PackPlan":
        """Rebuild a plan from :meth:`to_json` output, normalizing JSON
        lists back to tuples and ignoring unknown fields."""
        kw = dict(d)
        kw["shape"] = tuple(int(s) for s in kw["shape"])
        kw["lead"] = tuple(int(s) for s in kw.get("lead", ()))
        kw["tile"] = tuple(int(s) for s in kw.get("tile", (128, 128)))
        if kw.get("spmd"):
            # normalize to lists so a loaded plan compares equal to the
            # built one (json has no tuples)
            sp = dict(kw["spmd"])
            sp["batch_axes"] = list(sp.get("batch_axes", ()))
            kw["spmd"] = sp
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kw.items() if k in known})


class ModelPlan:
    """Per-parameter-path :class:`PackPlan` for one model.

    ``mesh`` is the mesh signature the SPMD sub-plans were derived for
    (``data=4,model=2``; empty when the plan was built without a mesh).
    """

    def __init__(self, entries: dict[str, PackPlan], mesh: str = "",
                 meta: dict[str, Any] | None = None):
        self.entries: dict[str, PackPlan] = dict(entries)
        self.mesh = mesh
        self.meta: dict[str, Any] = dict(meta or {})
        self._layouts: dict[tuple, PackPlan | None] | None = None
        # memos of the per-call lookups below (eager dispatch asks them on
        # every forward, where the reference asks once per trace)
        self._suffixes: dict[str, PackPlan | None] = {}
        self._subplans: dict[str, dict[str, PackPlan]] = {}

    # -- lookups -------------------------------------------------------------
    def get(self, path: str) -> PackPlan | None:
        """Entry for an exact parameter path, or None."""
        return self.entries.get(path)

    def for_suffix(self, suffix: str) -> PackPlan | None:
        """The unique entry whose path ends with ``suffix`` (dot-separated
        components), or None when absent/ambiguous."""
        if suffix not in self._suffixes:
            parts = suffix.split(".")
            hits = [e for p, e in self.entries.items()
                    if p.strip(".").split(".")[-len(parts):] == parts]
            self._suffixes[suffix] = hits[0] if len(hits) == 1 else None
        return self._suffixes[suffix]

    def subplans(self, component: str) -> dict[str, PackPlan]:
        """Leaf-name → entry for paths that contain ``component`` as a
        non-final segment (e.g. ``subplans("mlp")`` → the w_gate/w_up/w_down
        entries of the unique mlp subtree).  Ambiguous names are dropped —
        dispatch then falls back to layout matching."""
        if component not in self._subplans:
            grouped: dict[str, list[PackPlan]] = {}
            for p, e in self.entries.items():
                segs = p.strip(".").split(".")
                if component in segs[:-1]:
                    grouped.setdefault(segs[-1], []).append(e)
            self._subplans[component] = {n: es[0] for n, es in grouped.items()
                                         if all(e == es[0] for e in es)}
        return dict(self._subplans[component])

    def for_layout(self, key: tuple) -> PackPlan | None:
        """Entry matching a packed operand's layout signature; None when no
        entry (or more than one distinct entry) produces that layout."""
        if self._layouts is None:
            # Stacked (lead-dim) entries participate too: the scan body
            # slices layer stacks to per-matrix operands whose layout is
            # exactly the entry's (layout_key ignores lead).  Distinct
            # entries colliding on one layout resolve to None — dispatch
            # then falls back to ordinary auto resolution.
            table: dict[tuple, PackPlan | None] = {}
            for e in self.entries.values():
                if e.mode == "dense":
                    continue
                k = e.layout_key()
                if k in table and table[k] != e:
                    table[k] = None
                elif k not in table:
                    table[k] = e
            self._layouts = table
        return self._layouts.get(key)

    # -- accounting / reporting ---------------------------------------------
    def compressed_bytes(self) -> int:
        """Total packed weight bytes across every planned leaf."""
        return sum(e.compressed_bytes() for e in self.entries.values())

    def summary(self) -> dict[str, str]:
        """Parameter path → :meth:`PackPlan.describe` line, sorted."""
        return {p: e.describe() for p, e in sorted(self.entries.items())}

    def __len__(self) -> int:
        return len(self.entries)

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> dict:
        """Versioned JSON document (``PLAN_VERSION``-stamped) holding every
        entry; inverse of :meth:`from_json`."""
        return {
            "version": PLAN_VERSION,
            "mesh": self.mesh,
            "meta": self.meta,
            "entries": {p: e.to_json() for p, e in self.entries.items()},
        }

    @classmethod
    def from_json(cls, d: dict) -> "ModelPlan":
        """Rebuild from :meth:`to_json` output; rejects other plan-format
        versions rather than guessing at field meanings."""
        if d.get("version") != PLAN_VERSION:
            raise ValueError(
                f"unsupported plan version {d.get('version')!r} "
                f"(want {PLAN_VERSION})")
        entries = {p: PackPlan.from_json(e)
                   for p, e in d.get("entries", {}).items()}
        return cls(entries, mesh=d.get("mesh", ""), meta=d.get("meta"))

    def save(self, path) -> pathlib.Path:
        """Write the plan as indented JSON (parents created); returns the
        path for chaining into log lines."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1, sort_keys=True))
        return path

    @classmethod
    def load(cls, path) -> "ModelPlan":
        """Read a plan saved by :meth:`save`."""
        return cls.from_json(json.loads(pathlib.Path(path).read_text()))


# ---------------------------------------------------------------------------
# active-plan context: how model blocks receive their layer's plan
# ---------------------------------------------------------------------------
_ACTIVE: contextvars.ContextVar[ModelPlan | None] = contextvars.ContextVar(
    "repro_torch_pack_plan", default=None)


def active_plan() -> ModelPlan | None:
    """The :class:`ModelPlan` installed by the innermost
    :func:`use_plan` context, or None outside any."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_plan(plan: ModelPlan | None):
    """Install ``plan`` for every ``sod.apply`` dispatch traced inside the
    block (the step functions of :mod:`repro_torch.launch.steps` wrap their
    bodies in this).  ``None`` is a no-op."""
    if plan is None:
        yield None
        return
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


def active_entry(suffix: str) -> PackPlan | None:
    """Unique entry of the active plan ending with ``suffix``, else None."""
    mp = active_plan()
    return mp.for_suffix(suffix) if mp is not None else None


def active_subplans(component: str) -> dict[str, PackPlan] | None:
    """``subplans(component)`` of the active plan, or None when no plan is
    active (callers pass the result straight to ``layers.mlp(plans=...)``)."""
    mp = active_plan()
    return mp.subplans(component) if mp is not None else None


def lookup_active(layout_key: tuple) -> PackPlan | None:
    """Layout-signature lookup into the active plan (dispatch fallback when
    the call site doesn't know its parameter path)."""
    mp = active_plan()
    return mp.for_layout(layout_key) if mp is not None else None
