"""Dry-run of the production cells on one rank of a counting mesh — twin of
:mod:`repro.launch.dryrun`.

The reference lowers and compiles each (arch × shape × mesh) cell for 256
or 512 forced host devices and reads XLA's memory and cost analyses and
the partitioned HLO.  Eager PyTorch has no such compiler, so the port runs
the cell's step itself, once, on one rank of the production mesh with no
process group (:class:`repro_torch.launch.mesh.DryMesh`) and every tensor
on ``device="meta"``: shapes flow, nothing is computed, allocated or
launched.  Per cell it:

1. builds the mesh (16×16, or 2×16×16 with ``--multi-pod``) at rank 0,
2. builds meta parameters (optionally Sparse-on-Dense packed under the
   planner's per-layer plan, :func:`_plan_for_cell`), places them as that
   rank holds them (:func:`repro_torch.runtime.sharding.place`: every leaf
   reduced to the block its spec names), the AdamW state (its ZeRO-1
   blocks) and the inputs (:mod:`repro_torch.launch.specs`; the rank's
   rows and cache block where the step is partitioned),
3. runs the step (train, prefill or decode) on the counting mesh, where
   each packed product resolves its kernel as the card would (backend
   ``cuda``, the mesh-qualified key, tuned or prior: ``kernel_dispatch``)
   and computes its shape through the plain version,
4. writes one JSON record: ``memory`` (``argument_bytes`` and
   ``output_bytes``, exact sums of the rank's placed leaves, optimizer
   state and inputs, and of the step's outputs; ``peak_bytes``, the most
   bytes alive at once, arguments included, from a dispatch mode that
   tracks every storage the step allocates; ``temp_bytes`` the peak less
   the arguments), ``cost.flops`` (:class:`torch.utils.flop_counter.
   FlopCounterMode`; a packed product counts as the dense unit computes
   it, 2·M·Kp·Np of the rank's local problem, Kp and Np its whole tiles),
   and ``collectives`` (the bytes the counting mesh's collectives would
   move, in the reference's kinds: an all-gather counts its gathered
   result, an all-reduce twice its float32 buffer, an all-to-all its
   buffer; ``counts`` their calls).

These are counts of the port's own eager program, not compile results.
Every family's train, prefill and decode steps run the partitioned
program (the rank's rows, its share of heads, Mamba2 and mLSTM heads,
MLP columns, routed experts, vocabulary and codebook columns, its ZeRO-1
optimizer blocks, its rows and heads of a decode cache;
:mod:`repro_torch.launch.steps`), so rank 0 counts a shard's work as the
reference's partitioned HLO does.  Eager code
runs every layer, so nothing is counted once per loop body: the
reference's ``cost_scan_hlo``, ``collectives_scan_hlo`` and depth probes
have no counterpart; :func:`_extrapolate` (and :func:`measure` at a cut
depth) keep its depth law for checking.  A cell whose step fails records
``status: error`` and its traceback, as the reference's does (the MoE
archs with ``--sod`` meet fault R4, packed routed experts).

Usage::

    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k \\
        [--sod tiled_csc] [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--sod tiled_csc]

Records go to ``build/dryrun_torch/<arch>__<shape>__<mesh>__<sod>.json``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core.sod import SoDConfig
from repro_torch.core.tree import PACKED_FIELDS
from repro_torch.kernels import registry
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.runtime import sharding as shard_mod
from repro_torch.runtime import spmd

ROOT = pathlib.Path(__file__).resolve().parents[3]
RESULTS_DIR = ROOT / "build" / "dryrun_torch"

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _tensors(tree):
    """Every tensor of a tree of dicts, lists, tuples and packed containers
    (other leaves, such as a decode position, skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif type(tree) in PACKED_FIELDS:
        for f in PACKED_FIELDS[type(tree)]:
            yield from _tensors(getattr(tree, f))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class LiveBytes(TorchDispatchMode):
    """The most storage bytes alive at once: every storage an op returns is
    counted from its first appearance until it is freed (a weak reference
    to the storage); :meth:`add` counts tensors made before the mode (the
    step's arguments)."""

    def __init__(self):
        super().__init__()
        self._live: dict[int, tuple] = {}
        self.now = self.peak = 0

    def add(self, tree) -> None:
        """Count every tensor of ``tree`` (once per storage)."""
        for t in _tensors(tree):
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (weakref.ref(st, functools.partial(self._free, key)), n)
        self.now += n
        self.peak = max(self.peak, self.now)

    def _free(self, key: int, _ref) -> None:
        _, n = self._live.pop(key, (None, 0))
        self.now -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


def _collective_record(counts: dict) -> dict:
    """The reference's ``collectives`` entry from a
    :func:`repro_torch.runtime.spmd.count_collectives` dict: bytes per
    kind, their ``total``, and ``counts`` of calls per kind."""
    out = {k: int(counts.get(k, 0)) for k in _COLLECTIVES}
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = {k: int(counts.get("counts", {}).get(k, 0)) for k in _COLLECTIVES}
    return out


def _step_and_args(cfg, shape, mesh, plan=None, params=None, inputs=None):
    """The cell's step and its arguments as rank ``mesh.rank`` holds them:
    meta tensors, or the whole ``params`` and ``inputs`` given (as
    :func:`~repro_torch.launch.specs.input_specs` lays them out) placed on
    a real mesh.  The rank holds its placed parameters, its ZeRO-1 blocks
    of the optimizer state and, where the step runs the partitioned
    program (``steps.PARTITIONED``), its rows of the batch (a VLM's patches
    too) and its block of the decode cache, its rows and a KV leaf's
    positions (the reference's dry-run default; ``SOD_SEQ_SHARD_CACHE=0``
    keeps every position) or heads
    (:func:`repro_torch.runtime.sharding.decode_cache_specs`)."""
    model = LM(cfg)
    if params is None:
        params = specs_mod.abstract_params(model, cfg.sod if cfg.sod.enabled else None,
                                           plan=plan)
    p_specs = shard_mod.param_specs(params, cfg, mesh)
    placed = shard_mod.place(params, p_specs, mesh)
    inputs = specs_mod.input_specs(cfg, shape) if inputs is None else inputs
    split = cfg.family in steps_mod.PARTITIONED

    def rows_of(batch):
        """The batch as the rank holds it and the axes its rows lie on."""
        if not split:
            return batch, None
        b_specs = shard_mod.batch_specs(batch, mesh)
        rows = next(iter(b_specs.values()))[0]
        return (shard_mod.place(batch, b_specs, mesh),
                () if rows is None else ((rows,) if isinstance(rows, str) else tuple(rows)))

    if shape.kind == "train":
        opt = AdamW(AdamWConfig())
        state = opt.init(params)
        state = shard_mod.place(state, shard_mod.opt_state_specs(state, p_specs, mesh, cfg=cfg),
                                mesh)
        batch, rows = rows_of(inputs["batch"])
        step = steps_mod.make_train_step(model, opt, mesh=mesh, plan=plan, rows=rows)
        return step, (placed, state, batch)
    if shape.kind == "prefill":
        batch, rows = rows_of(inputs["batch"])
        prefill = steps_mod.make_prefill_step(model, mesh=mesh, plan=plan, rows=rows)

        def step(params, batch):
            return prefill(params, batch["tokens"], patch_embeds=batch.get("patch_embeds"))

        return step, (placed, batch)
    cache, tokens = inputs["cache"], inputs["tokens"]
    toks, rows = rows_of({"tokens": tokens})
    seq_shard = os.environ.get("SOD_SEQ_SHARD_CACHE", "1") == "1"
    if split:
        cache = shard_mod.place(cache, shard_mod.decode_cache_specs(
            cache, cfg, mesh, tokens.shape[0], seq_shard=seq_shard), mesh)
    step = steps_mod.make_decode_step(model, mesh=mesh, plan=plan, rows=rows,
                                      seq_len=shape.seq_len if seq_shard else None)
    # the position the 0-d ``pos`` spec stands for: the cache's last
    return step, (placed, cache, toks["tokens"], shape.seq_len - 1)


def measure(cfg, shape, mesh, plan=None, params=None, inputs=None) -> dict:
    """Run the cell's step once on ``mesh`` (the counting mesh, or a real
    one with ``params`` and ``inputs``); ``memory``, ``cost``,
    ``collectives`` and the dispatch log."""
    step, args = _step_and_args(cfg, shape, mesh, plan, params, inputs)
    live = LiveBytes()
    flops = FlopCounterMode(display=False)
    with registry.record_dispatches() as log, spmd.count_collectives() as counts:
        with flops, live:
            live.add(args)
            out = step(*args)
        peak = live.peak
    arg_bytes, out_bytes = _nbytes(args), _nbytes(out)
    del out
    return {
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": peak - arg_bytes, "peak_bytes": peak},
        "cost": {"flops": float(flops.get_total_flops())},
        "collectives": _collective_record(counts),
        "dispatch_log": log,
    }


def _plan_for_cell(cfg, shape, mesh, plan_path: str | None):
    """Per-layer pack plan for a cell: replayed from ``plan_path`` when
    given, else built by the planner against the cell's meta shapes and the
    mesh (its pass attaches the SPMD plans), with dispatch hints for the
    mesh's backend and the persisted tuning cache."""
    if not cfg.sod.enabled:
        return None
    from repro_torch.core.plan import ModelPlan
    from repro_torch.runtime import planner

    if plan_path:
        return ModelPlan.load(plan_path)
    shapes = LM(cfg).init(torch.Generator(), "meta")
    m_probe = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return planner.build_plan(
        shapes, cfg.sod, cfg=cfg, mesh=mesh, backend=mesh.backend,
        m_values=(max(min(m_probe, 4096), 1), shape.global_batch))


def build_cell(arch: str, shape_name: str, multi_pod: bool, sod_mode: str | None,
               density: float, n_layers: int | None = None,
               plan_path: str | None = None):
    """``(cfg, shape, mesh, plan)`` of one cell: the arch's config (at
    ``n_layers`` when given) with the SoD mode, MoE dispatch blocks = the
    data-parallel size (``SOD_MOE_BLOCKS=0`` keeps the config's), the
    counting mesh at rank 0 and the cell's plan."""
    cfg = configs.get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    if sod_mode:
        cfg = cfg.with_(sod=SoDConfig(mode=sod_mode, density=density))
    if cfg.family == "moe" and os.environ.get("SOD_MOE_BLOCKS", "1") == "1":
        dp = 32 if multi_pod else 16
        cfg = cfg.with_(moe_dispatch_blocks=dp)
    shape = SHAPES[shape_name]
    mesh = make_dry_mesh(multi_pod=multi_pod)
    return cfg, shape, mesh, _plan_for_cell(cfg, shape, mesh, plan_path)


def _group_size(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.hybrid_attn_every
    if cfg.family == "ssm":
        return cfg.slstm_every or 1
    return cfg.pattern_period


def _extrapolate(a1: dict, a2: dict, g1: int, g2: int, g_full: int) -> dict:
    """Linear-in-depth extrapolation from two shallow probes.

    Layer stacks are homogeneous per group, so every cost counter is affine
    in the group count: total(g) = outside + per_group·g.  Exact — no
    modelling assumption beyond homogeneity.
    """
    out = {}
    for sec in ("cost",):
        if "error" in a1.get(sec, {}) or "error" in a2.get(sec, {}):
            out[sec] = {"error": "probe failed"}
            continue
        out[sec] = {}
        for key in a1[sec]:
            per = (a2[sec][key] - a1[sec][key]) / (g2 - g1)
            outside = a1[sec][key] - per * g1
            out[sec][key] = outside + per * g_full
    c1, c2 = a1.get("collectives", {}), a2.get("collectives", {})
    coll = {}
    for key in _COLLECTIVES + ("total",):
        if key in c1 and key in c2:
            per = (c2[key] - c1[key]) / (g2 - g1)
            coll[key] = max(c1[key] - per * g1 + per * g_full, 0.0)
    out["collectives"] = coll
    return out


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             sod_mode: str | None = None, density: float = 0.3,
             plan_path: str | None = None, plan_out: str | None = None) -> dict:
    """One cell's record (the reference's keys, less its HLO scans and
    probes; plus ``device`` and ``run_s``)."""
    rec = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "sod": sod_mode or "dense", "density": density if sod_mode else 1.0,
    }
    if not shape_applicable(configs.get_config(arch), SHAPES[shape_name]):
        rec["status"] = "skipped"
        rec["reason"] = "full-attention arch; long_500k requires sub-quadratic"
        return rec
    t0 = time.perf_counter()
    cfg, shape, mesh, plan = build_cell(arch, shape_name, multi_pod, sod_mode, density,
                                        plan_path=plan_path)
    found = measure(cfg, shape, mesh, plan)
    rec["run_s"] = round(time.perf_counter() - t0, 1)
    log = found.pop("dispatch_log")
    rec["kernel_dispatch"] = registry.dispatch_summary(log)
    rec["dispatch_counts"] = registry.dispatch_counts(log)
    if plan is not None:
        rec["pack_plan"] = plan.summary()
        rec["pack_plan_bytes"] = plan.compressed_bytes()
        if plan_out:
            plan.save(plan_out)
            rec["pack_plan_file"] = str(plan_out)
    rec.update(found)
    rec["device"] = "meta"
    rec["n_devices"] = mesh.size
    rec["params_b"] = cfg.param_count()
    rec["active_params_b"] = cfg.active_param_count()
    rec["status"] = "ok"
    return rec


def _result_path(arch, shape, multi_pod, sod_mode) -> pathlib.Path:
    return RESULTS_DIR / f"{arch}__{shape}__{_mesh_name(multi_pod)}__{sod_mode or 'dense'}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sod", choices=("tiled_csc", "block_csr"), default=None)
    ap.add_argument("--density", type=float, default=0.3)
    ap.add_argument("--plan", default=None,
                    help="replay a pack-plan JSON instead of building one")
    ap.add_argument("--plan-json", default=None,
                    help="dump the cell's per-layer pack plan to this path "
                         "(replayable by train/serve --plan)")
    ap.add_argument("--all", action="store_true", help="run every cell in subprocesses")
    ap.add_argument("--force", action="store_true", help="recompute cached")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    if args.all:
        failures = 0
        for arch in configs.ARCH_NAMES:
            for shape in SHAPES:
                for mp in (False, True):
                    path = _result_path(arch, shape, mp, args.sod)
                    if path.exists() and not args.force:
                        print(f"[cached] {path.name}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape]
                    if mp:
                        cmd.append("--multi-pod")
                    if args.sod:
                        cmd += ["--sod", args.sod, "--density", str(args.density)]
                    print(f"[run] {' '.join(cmd[3:])}", flush=True)
                    r = subprocess.run(cmd, timeout=args.timeout, cwd=ROOT)
                    failures += bool(r.returncode)
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    if (args.plan or args.plan_json) and not args.sod:
        ap.error("--plan/--plan-json require --sod tiled_csc|block_csr")
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, args.sod, args.density,
                       plan_path=args.plan, plan_out=args.plan_json)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": _mesh_name(args.multi_pod),
               "sod": args.sod or "dense",
               "status": "error", "traceback": traceback.format_exc()[-4000:]}
    path = _result_path(args.arch, args.shape, args.multi_pod, args.sod)
    path.write_text(json.dumps(rec, indent=2))
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}, indent=2))
    if rec["status"] == "error":
        print(rec.get("traceback", ""), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
