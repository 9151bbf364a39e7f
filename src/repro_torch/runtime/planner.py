"""Packing planner: tuning cache + cost model → per-layer ModelPlan.

Twin of :mod:`repro.runtime.planner`.  :func:`build_plan` walks a parameter
tree — concrete tensors, or ``device="meta"`` tensors standing in for the
reference's ``ShapeDtypeStruct``s — and emits one
:class:`~repro_torch.core.plan.PackPlan` per packable stacked leaf, under
the reference's paths (:func:`repro_torch.core.sod.plan_leaves`):

* **capacity** — from the shared sizing functions of
  :mod:`repro_torch.core.plan`: the exact data-dependent capacity when the
  weights are concrete (what a lossless global-config pack would use), the
  deterministic mean + 4σ budget otherwise.  Either way the number is
  recorded, so replaying the plan produces byte-identical packed layouts
  and hence identical tuning-cache keys;
* **format** — per layer, the configured packed mode or plain dense,
  whichever stores fewer bytes;
* **qmode** — as configured, or with ``qmode="auto"`` the narrowest mode
  whose round-trip drift fits the budget (measured on the first layer's
  pruned weights when concrete, :data:`NOMINAL_QDRIFT` otherwise);
* **dispatch hint** — the tuning cache's winner at the plan's first M rides
  along in ``dispatch_params`` (it seeds dispatch on a cold cache only);
  otherwise the prior's choice is recorded in ``note``;
* **SpmdPlan** — with a mesh (an :class:`~repro_torch.launch.mesh.AbstractMesh`
  or a :class:`~repro_torch.launch.mesh.Mesh`) and a model config, each
  lead-less entry gets the partition plan of its resident spec
  (:func:`repro_torch.runtime.sharding.packed_matmul_plans`), and the plan
  records the mesh signature (``ModelPlan.mesh``).

:func:`choose_draft_density` picks the speculative-decoding draft tier's
density by the reference's cost model, :func:`build_draft_plan` plans that
tier, :func:`warmup_plan` tunes every planned layout at the plan's M values
from the plan alone, and :func:`load_or_build` resolves a launch script's
``--plan``.
"""
from __future__ import annotations

import dataclasses
import zlib
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.core import formats, pruning, sod
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import ModelPlan, PackPlan
from repro_torch.core.sod import SoDConfig
from repro_torch.kernels import registry

__all__ = ["build_plan", "build_draft_plan", "choose_draft_density",
           "warmup_plan", "load_or_build", "DRAFT_DENSITY_LADDER",
           "NOMINAL_QDRIFT"]

def _is_abstract(ws: list[torch.Tensor]) -> bool:
    return ws[0].device.type == "meta"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def _period(cfg) -> int:
    return cfg.pattern_period if cfg is not None else 1


def _pruned(ws, sod_cfg: SoDConfig, tile, prune: bool) -> list[torch.Tensor]:
    """The layers pruned as ``sodify_params`` prunes them (``--plan auto``
    prunes twice by design: here to observe capacities, there to pack, so
    the plan stays a pure value; pruning is deterministic)."""
    if prune and sod_cfg.density < 1.0:
        return [sod._prune_leaf(w, sod_cfg.density, sod_cfg.prune_method, tile,
                                sod_cfg.br) for w in ws]
    return ws


def _packed_candidate(ws, lead, sod_cfg: SoDConfig, tile, prune: bool) -> PackPlan:
    shape = tuple(int(s) for s in ws[0].shape[-2:])
    bk, bn = tile
    common = dict(shape=shape, lead=tuple(lead), density=sod_cfg.density,
                  prune_method=sod_cfg.prune_method, tile=tuple(tile),
                  br=sod_cfg.br, dtype=_dtype_name(ws[0].dtype))
    pruned = None if _is_abstract(ws) else _pruned(ws, sod_cfg, tile, prune)
    if sod_cfg.mode == "tiled_csc":
        observed = (None if pruned is None else
                    max(formats.observed_tiled_cap(w, tile) for w in pruned))
        return PackPlan(mode="tiled_csc",
                        cap=plan_mod.tiled_cap(bk, sod_cfg.density, observed),
                        **common)
    observed = (None if pruned is None else
                max(formats.observed_block_cap(w, tile, sod_cfg.br) for w in pruned))
    bcap = plan_mod.block_bcap(bk // sod_cfg.br, sod_cfg.density,
                               sod_cfg.prune_method, sod_cfg.br * bn,
                               observed=observed)
    return PackPlan(mode="block_csr", bcap=bcap, **common)


def _abstract_operand(e: PackPlan, dtype: torch.dtype):
    """A packed container of meta tensors with the entry's exact layout
    (enough for :func:`repro_torch.kernels.registry.problem_key`), built as
    ``sodify_abstract`` builds it."""
    k, n = e.shape
    if e.mode == "tiled_csc":
        return sod.abstract_tiled(k, n, dtype, e.tile, e.cap, e.qmode)
    return sod.abstract_block(k, n, dtype, e.tile, e.br, e.bcap, e.qmode)


# Nominal relative-RMS round-trip drift per quantization mode, used when the
# planner only has shapes (the reference's constants); a measured pass
# always wins when the weights are concrete.
NOMINAL_QDRIFT = {"none": 0.0, "int8": 0.005, "fp8": 0.03, "codebook": 0.1}

# auto-mode search order: ascending stored bits (codebook 4 < int8/fp8 8 <
# none 16); int8 before fp8 because it drifts less at the same width
_QMODE_ORDER = ("codebook", "int8", "fp8", "none")


def _measured_qdrift(pruned2d: torch.Tensor, e: PackPlan) -> dict[str, float]:
    """Relative-RMS round-trip drift of each candidate qmode on one pruned
    2-D weight, packed at the entry's exact layout."""
    packed = (formats.pack_tiled_csc(pruned2d, tile=e.tile, cap=e.cap)
              if e.mode == "tiled_csc" else
              formats.pack_block_csr(pruned2d, tile=e.tile, br=e.br, bcap=e.bcap))
    base = packed.to_dense()
    bnorm = float(torch.linalg.norm(base)) or 1.0
    out = {"none": 0.0}
    for q in _QMODE_ORDER[:-1]:
        dq = formats.quantize_packed(packed, q).to_dense()
        out[q] = float(torch.linalg.norm(dq - base)) / bnorm
    return out


def _select_qmode(e: PackPlan, ws, requested: str, drift_budget: float,
                  sod_cfg: SoDConfig, prune: bool) -> PackPlan:
    """Resolve a plan entry's quantization mode: an explicit mode as it is;
    ``"auto"`` walks the modes from the narrowest up and keeps the first
    whose round-trip drift fits ``drift_budget`` — measured on the first
    layer's pruned weights when concrete, :data:`NOMINAL_QDRIFT` otherwise.
    The chosen drift goes into the entry's ``note``."""
    if requested == "none":
        return e
    if requested != "auto":
        return dataclasses.replace(e, qmode=requested)
    if _is_abstract(ws):
        drifts, tag = dict(NOMINAL_QDRIFT), "nominal"
    else:
        w2 = ws[0].reshape((-1,) + tuple(ws[0].shape[-2:]))[0]   # the first matrix
        if prune and sod_cfg.density < 1.0:
            w2 = sod.prune_weight(w2, sod_cfg.density, e.prune_method, e.tile, e.br)
        drifts, tag = _measured_qdrift(w2, e), "measured"
    for q in _QMODE_ORDER:
        if drifts[q] <= drift_budget:
            if q == "none":
                return e
            return dataclasses.replace(e, qmode=q,
                                       note=f"qdrift({tag})={drifts[q]:.4f}")
    return e


def _attach_hint(e: PackPlan, dtype: torch.dtype, cache, backend, m: int) -> PackPlan:
    """Dispatch hint from the tuning cache (a measured winner) or the
    analytical prior at the plan's layout."""
    from repro_torch.kernels import autotune  # deferred: autotune imports registry

    cache = autotune.get_cache() if cache is None else cache
    key = registry.problem_key(_abstract_operand(e, dtype), m=int(m),
                               backend=backend)
    hit = cache.get(key)
    prefix = f"{e.note}; " if e.note else ""
    if hit is not None:
        return dataclasses.replace(
            e, dispatch_params=dict(hit.get("params") or {}),
            note=f"{prefix}tuned:{hit.get('impl', '?')}")
    ranked = autotune.rank_candidates(key)
    if ranked:
        return dataclasses.replace(e, note=f"{prefix}prior:{ranked[0][1].name}")
    return e


def build_plan(
    params,
    sod_cfg: SoDConfig,
    *,
    cfg=None,
    mesh=None,
    cache=None,
    backend: str | None = None,
    m_values: tuple[int, ...] = (128, 8),
    tiles: tuple[tuple[int, int], ...] | None = None,
    allow_dense: bool = True,
    prune: bool = True,
    qmode: str | None = None,
    drift_budget: float = 0.05,
) -> ModelPlan:
    """Per-layer :class:`~repro_torch.core.plan.ModelPlan` for a parameter
    tree of concrete tensors (exact observed capacities) or meta tensors
    (deterministic budgets).  ``cfg`` (the model config) gives the layer
    pattern's period and the plan's ``arch``; ``tiles`` widens the tile
    search beyond ``sod_cfg.tile`` (ranked by compressed bytes).

    ``qmode``: ``None`` inherits ``sod_cfg.qmode``, an explicit mode applies
    everywhere, ``"auto"`` picks per entry the narrowest mode whose drift
    fits ``drift_budget`` (the entries are measured in threads: the codebook
    fit runs in numpy on the host).  The dense fallback compares against the
    quantized compressed bytes, so a plan never stores more than dense.
    """
    req_qmode = sod_cfg.qmode if qmode is None else qmode
    if req_qmode not in (*plan_mod.QMODES, "auto"):
        raise ValueError(f"unknown qmode {req_qmode!r}")
    entries: dict[str, PackPlan] = {}
    if sod_cfg.enabled:
        stacks = []
        for name, ws, lead in sod.plan_leaves(params, _period(cfg)):
            if isinstance(ws[0], (formats.TiledCSC, formats.BlockCSR)):
                raise ValueError(
                    f"build_plan expects unpacked params; {name} is already "
                    f"a {type(ws[0]).__name__}")
            if not (sod._packable(name, ws[0].shape)
                    and min(ws[0].shape[-2:]) >= sod_cfg.min_dim):
                continue
            cands = [_packed_candidate(ws, lead, sod_cfg, tuple(t), prune)
                     for t in (tiles or (tuple(sod_cfg.tile),))]
            stacks.append((name, ws, min(cands, key=lambda e: e.compressed_bytes())))
        with ThreadPoolExecutor(max_workers=max(min(len(stacks), 8), 1)) as pool:
            chosen = list(pool.map(
                lambda s: _select_qmode(s[2], s[1], req_qmode, drift_budget,
                                        sod_cfg, prune), stacks))
        for (name, ws, _), best in zip(stacks, chosen):
            if allow_dense and best.dense_bytes() < best.compressed_bytes():
                # keep the pruning geometry: the dense fallback changes the
                # storage format, not the sparsity pattern
                best = PackPlan(
                    mode="dense", shape=best.shape, lead=best.lead,
                    density=sod_cfg.density, prune_method=sod_cfg.prune_method,
                    tile=tuple(sod_cfg.tile), br=sod_cfg.br, dtype=best.dtype,
                    note="packed would exceed dense bytes")
            if best.mode != "dense":
                best = _attach_hint(best, ws[0].dtype, cache, backend,
                                    m_values[0] if m_values else 128)
            entries[name] = best
    mesh_sig = ""
    if mesh is not None and cfg is not None and entries:
        from repro_torch.runtime import sharding as shard_mod
        from repro_torch.runtime import spmd as spmd_mod

        packed_abs = sod.sodify_abstract(_to_meta(params), sod_cfg,
                                         plan=ModelPlan(entries))
        for path, sp in shard_mod.packed_matmul_plans(packed_abs, cfg, mesh).items():
            e = entries.get(path)
            if e is not None:
                entries[path] = dataclasses.replace(e, spmd=_spmd_dict(sp))
        mesh_sig = spmd_mod.mesh_key(mesh)
    meta = {
        "sod": {"mode": sod_cfg.mode, "density": sod_cfg.density,
                "prune_method": sod_cfg.prune_method,
                "tile": list(sod_cfg.tile), "br": sod_cfg.br,
                "min_dim": sod_cfg.min_dim, "qmode": req_qmode},
        "m_values": [int(m) for m in m_values],
        "backend": backend or registry.current_backend(),
        "arch": getattr(cfg, "name", ""),
    }
    return ModelPlan(entries, mesh=mesh_sig, meta=meta)


def _spmd_dict(sp) -> dict:
    return {"batch_axes": list(sp.batch_axes), "col_axis": sp.col_axis,
            "row_axis": sp.row_axis, "gather_axis": sp.gather_axis}


# ---------------------------------------------------------------------------
# draft tier (speculative decoding)
# ---------------------------------------------------------------------------
DRAFT_DENSITY_LADDER = (0.05, 0.08, 0.12, 0.2, 0.3, 0.5)


def _draft_sod_cfg(sod_cfg: SoDConfig, density: float,
                   qmode: str | None = None) -> SoDConfig:
    """The draft tier's :class:`~repro_torch.core.sod.SoDConfig`: the
    target's packing geometry (format, tile, prune method) re-pruned to
    ``density``.  A dense target still gets a packed draft, magnitude-pruned
    ``tiled_csc``: the same dense matmul path serves the compressed tier.
    ``qmode`` (optional) stores the draft's values quantized."""
    if sod_cfg.enabled:
        draft = dataclasses.replace(sod_cfg, density=float(density))
    else:
        draft = SoDConfig(mode="tiled_csc", density=float(density),
                          prune_method="magnitude", min_dim=64)
    if qmode is not None:
        draft = dataclasses.replace(draft, qmode=qmode)
    return draft


def _expected_window_tokens(alpha: float, k: int) -> float:
    """Expected committed tokens per k-draft window under i.i.d. per-token
    acceptance ``alpha``: E = sum_{i=0..k} alpha^i."""
    return float(sum(alpha ** i for i in range(k + 1)))


def _draft_alpha(density: float) -> float:
    """The reference's acceptance heuristic for a draft tier keeping
    ``density`` of the target's weights (monotone, alpha(1) ≈ 1)."""
    return 0.95 * float(density) ** 0.5


def _to_meta(tree):
    """The tree with every tensor replaced by a meta tensor of its shape."""
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_meta(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def choose_draft_density(
    params,
    sod_cfg: SoDConfig,
    *,
    spec_k: int = 4,
    candidates: tuple[float, ...] = DRAFT_DENSITY_LADDER,
    cfg=None,
    cache=None,
    m_values: tuple[int, ...] = (128, 8),
    draft_qmode: str | None = None,
) -> tuple[float, dict]:
    """The reference's cost-model choice of the draft tier's density.

    Each candidate tier is planned on shapes alone and costed by the decode
    model: decode is bound by weight bytes, so a window of k draft steps and
    one verify costs ``k·r + 1`` target steps, ``r`` the draft/target ratio
    of planned compressed bytes.  The expected yield is the speculative
    window formula under :func:`_draft_alpha`; the density with the most
    tokens per cost wins.  Returns ``(density, diagnostics)``.
    """
    shapes = _to_meta(params)

    def _ratio(plan: ModelPlan) -> float:
        dense = sum(e.dense_bytes() for e in plan.entries.values())
        return plan.compressed_bytes() / dense if dense else 1.0

    if sod_cfg.enabled:
        t_ratio = _ratio(build_plan(shapes, sod_cfg, cfg=cfg, cache=cache,
                                    m_values=m_values))
    else:
        t_ratio = 1.0
    diag: dict = {"spec_k": int(spec_k), "target_ratio": round(t_ratio, 4),
                  "candidates": {}}
    if draft_qmode is not None:
        diag["draft_qmode"] = draft_qmode
    best_d, best_score = None, -1.0
    for d in candidates:
        dplan = build_plan(shapes, _draft_sod_cfg(sod_cfg, d, qmode=draft_qmode),
                           cfg=cfg, cache=cache, m_values=m_values)
        r = _ratio(dplan) / max(t_ratio, 1e-9)
        alpha = _draft_alpha(d)
        score = _expected_window_tokens(alpha, spec_k) / (spec_k * r + 1.0)
        diag["candidates"][f"{d:g}"] = {
            "cost_ratio": round(r, 4), "alpha": round(alpha, 4),
            "tokens_per_cost": round(score, 4)}
        if score > best_score:
            best_d, best_score = float(d), score
    diag["chosen"] = best_d
    return best_d, diag


def build_draft_plan(
    params,
    sod_cfg: SoDConfig,
    *,
    draft_density: float | None = None,
    spec_k: int = 4,
    cfg=None,
    mesh=None,
    cache=None,
    backend: str | None = None,
    m_values: tuple[int, ...] = (128, 8),
    draft_qmode: str | None = None,
) -> tuple[SoDConfig, ModelPlan]:
    """A second :class:`~repro_torch.core.plan.ModelPlan` over the same raw
    weights — the speculative-decoding draft tier.  ``draft_density=None``
    delegates to :func:`choose_draft_density`.  Returns ``(draft_cfg,
    draft_plan)``; the plan's meta records the tier and the diagnostics of
    the density choice.  Pack the draft with ``sodify_params(params,
    draft_cfg, plan=draft_plan)`` on the raw weights."""
    diag = None
    if draft_density is None:
        draft_density, diag = choose_draft_density(
            params, sod_cfg, spec_k=spec_k, cfg=cfg, cache=cache,
            m_values=m_values, draft_qmode=draft_qmode)
    draft_cfg = _draft_sod_cfg(sod_cfg, draft_density, qmode=draft_qmode)
    plan = build_plan(params, draft_cfg, cfg=cfg, mesh=mesh, cache=cache,
                      backend=backend, m_values=m_values)
    plan.meta["tier"] = "draft"
    plan.meta["spec_k"] = int(spec_k)
    if diag is not None:
        plan.meta["density_choice"] = diag
    return draft_cfg, plan


def _concrete_operand(e: PackPlan, gen: torch.Generator):
    """Random concrete operand with the entry's exact packed layout."""
    w = pruning.random_sparse(gen, e.shape, min(max(e.density, 0.05), 1.0))
    if e.prune_method == "block" and e.density < 1.0:
        w = pruning.block_prune(w, e.density, block=(e.br, e.tile[1]))
    w = w.to(_dtype_of(e.dtype))
    if e.mode == "tiled_csc":
        packed = formats.pack_tiled_csc(w, tile=e.tile, cap=e.cap)
    else:
        packed = formats.pack_block_csr(w, tile=e.tile, br=e.br, bcap=e.bcap)
    return formats.quantize_packed(packed, e.qmode)


def warmup_plan(
    plan: ModelPlan,
    m_values: tuple[int, ...] | None = None,
    *,
    mesh=None,
    backend: str | None = None,
    cache=None,
    iters: int = 9,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """Tune every distinct planned layout at the plan's M values, from the
    plan alone: random weights packed at the planned capacity (a kernel's
    time depends on the static layout, not the values) on ``device`` (the
    backend's: ``cuda`` or ``cpu``), activations in the entry's dtype.
    Returns ``{"tuned", "cached", "skipped"}`` (dense entries are skipped).

    With ``mesh``, an entry that carries an SPMD sub-plan is tuned at its
    per-local-shard shape under the mesh-qualified key instead (an entry
    whose plan does not divide the mesh is skipped), as
    :func:`repro_torch.runtime.spmd.warmup_params_spmd` tunes."""
    from repro_torch.kernels import autotune

    backend = backend or registry.current_backend(device)
    device = torch.device(device or backend)
    cache = autotune.get_cache() if cache is None else cache
    m_values = tuple(int(m) for m in
                     (m_values or plan.meta.get("m_values") or (128,)))
    operands: dict[tuple, tuple] = {}
    meshed: dict[tuple, tuple] = {}
    skipped = 0
    for path, e in sorted(plan.entries.items()):
        if e.mode == "dense":
            skipped += 1
            continue
        sig = e.layout_key() + (e.dtype, repr(sorted((e.spmd or {}).items())))
        if sig in operands or sig in meshed:
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed((seed + zlib.crc32(path.encode())) % (2**31))
        w = _concrete_operand(e, gen)
        if mesh is None or not e.spmd:
            operands[sig] = (w, _dtype_of(e.dtype))
            continue
        from repro_torch.runtime import spmd as spmd_mod

        sp = spmd_mod.SpmdPlan.from_dict(e.spmd)
        try:
            spmd_mod._validate(sp, mesh, w)
        except ValueError:
            skipped += 1
            continue
        meshed[sig] = (spmd_mod._local_packed(w, mesh, sp),
                       f"{spmd_mod.mesh_key(mesh)}|{sp.signature()}",
                       spmd_mod._axes_size(mesh, sp.batch_axes), _dtype_of(e.dtype))
    stats = autotune.tune_layouts(operands, m_values, backend=backend, cache=cache,
                                  iters=iters, seed=seed)
    for sig, (w, mesh_sig, dp, dtype) in meshed.items():
        for m in dict.fromkeys(m_values):
            m_local = max(-(-m // dp), 1)
            if cache.get(registry.problem_key(w, m=m_local, backend=backend,
                                              mesh=mesh_sig)) is not None:
                stats["cached"] += 1
                continue
            gen = torch.Generator(device=w.device)
            gen.manual_seed((seed + zlib.crc32(repr(sig).encode()) ^ m) % (2**31))
            x = torch.randn(m_local, w.shape[0], generator=gen, device=w.device)
            autotune.tune(x.to(dtype), w, backend=backend, mesh=mesh_sig,
                          cache=cache, iters=iters)
            stats["tuned"] += 1
    return {**stats, "skipped": skipped}


def load_or_build(
    plan_arg: str | None,
    params,
    sod_cfg: SoDConfig,
    *,
    cfg=None,
    mesh=None,
    cache=None,
    m_values: tuple[int, ...] = (),
    qmode: str | None = None,
) -> ModelPlan | None:
    """Resolve a launch script's ``--plan``: ``None``/empty → no plan
    (global-config packing); ``"auto"`` → build one with the planner (with
    ``qmode`` from ``--quantize``); anything else is a JSON path to replay
    (a plan written by either package)."""
    if not plan_arg:
        return None
    if plan_arg == "auto":
        return build_plan(params, sod_cfg, cfg=cfg, mesh=mesh, cache=cache,
                          m_values=tuple(m_values) or (128, 8), qmode=qmode)
    return ModelPlan.load(plan_arg)
