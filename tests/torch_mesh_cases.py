"""Rank bodies of the port's mesh tests (no JAX here: every rank imports
this file).

:func:`spmd_cases` runs, on each rank of a (4, 2) ``gloo`` group on the
CPU, every case that ``tests/test_torch_spmd.py`` wrote to its directory
(``cases.pt``: the operands as the port's containers, the activations, the
reduced model's packed parameters and batch), and saves what it found to
``rank<r>.pt`` for the test to hold against the JAX package.
"""
from __future__ import annotations

import dataclasses
import pathlib

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core import sod
from repro_torch.core.tree import PACKED_FIELDS
from repro_torch.kernels import autotune, registry
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.runtime import sharding, sod_fsdp, spmd

PLANS = {
    "dp": {"batch_axes": ("data",)},
    "col": {"batch_axes": ("data",), "col_axis": "model"},
    "row": {"batch_axes": ("data",), "row_axis": "model"},
    "gather_model": {"batch_axes": ("data",), "gather_axis": "model"},
    "gather_data": {"gather_axis": "data"},
}


def _product(x, w, plan):
    """y and the gradients of ``sum(y ** 2)`` (x and every float field)."""
    x = x.clone().requires_grad_(True)
    leaves = {f: getattr(w, f).clone().requires_grad_(True)
              for f in PACKED_FIELDS[type(w)]
              if getattr(w, f) is not None and getattr(w, f).is_floating_point()}
    w = dataclasses.replace(w, **leaves)
    with spmd.count_collectives() as counts, registry.record_dispatches() as log:
        y = spmd.sod_matmul_spmd(x, w, plan=spmd.SpmdPlan(**plan))
        (y.float() ** 2).sum().backward()
    return {"y": y.detach(), "x": x.grad, **{f: t.grad for f, t in leaves.items()},
            "counts": counts, "keys": [r["key"].mesh for r in log],
            "impls": [r["impl"] for r in log]}


def _tuned_dispatch(w, workdir: pathlib.Path, rank: int) -> dict:
    """A tuned local-shard entry feeds the mesh dispatch (its own cache)."""
    mesh = spmd.active_mesh()
    plan = spmd.auto_plan(mesh, w)
    sig = f"{spmd.mesh_key(mesh)}|{plan.signature()}"
    local = spmd._local_packed(w, mesh, plan)
    cache = autotune.TuningCache(workdir / f"cache{rank}.json")
    autotune.set_cache(cache)
    try:
        x_l = torch.randn(12, local.shape[0], generator=torch.Generator().manual_seed(5))
        entry = autotune.tune(x_l, local, backend="cpu", mesh=sig, cache=cache,
                              measure_fn=lambda fn: 1.0)
        key = registry.problem_key(local, m=12, backend="cpu", mesh=sig)
        x = torch.randn(48, w.shape[0], generator=torch.Generator().manual_seed(6))
        with registry.record_dispatches() as log:
            from repro_torch.kernels import ops

            ops.sod_matmul(x, w)
        return {"entry": entry, "lookup": autotune.lookup(key),
                "sources": [r["source"] for r in log], "keys": [r["key"].mesh for r in log]}
    finally:
        autotune.set_cache(None)


def _model_runs(cfg, params, batch, mesh) -> dict:
    """The mesh ``loss_and_grads`` on the rank's resident blocks (and again
    under remat), and one mesh ``train_step``."""
    model = LM(cfg)
    specs = sharding.param_specs(params, cfg, mesh)
    placed = sharding.place(params, specs, mesh)
    with spmd.count_collectives() as counts, registry.record_dispatches() as log:
        p_loss, _, p_grads = steps.make_loss_and_grads(model, mesh=mesh)(placed, batch)
    r_loss, _, r_grads = steps.make_loss_and_grads(LM(cfg.with_(remat=True)), mesh=mesh)(
        placed, batch)
    opt = AdamW(AdamWConfig(lr=1e-3))
    with registry.record_dispatches() as t_log:
        _, _, metrics = steps.make_train_step(model, opt, mesh=mesh)(
            placed, opt.init(placed), batch)
    return {"placed_loss": p_loss, "placed_grads": p_grads,
            "placed": placed, "placed_counts": counts,
            "train_loss": metrics["loss"], "remat_loss": r_loss, "remat_grads": r_grads,
            "dispatch": [(r["impl"], r["key"].mesh) for r in log + t_log]}


def spmd_cases(workdir: str) -> dict:
    """Every case of ``cases.pt``; returns a summary, saves the tensors."""
    workdir = pathlib.Path(workdir)
    cases = torch.load(workdir / "cases.pt", weights_only=False)
    mesh = mesh_mod.make_fake_mesh(device="cpu")
    rank = mesh.rank
    out = {}
    with mesh_mod.mesh_context(mesh):
        for name, (x, w, plan) in cases["products"].items():
            out[name] = _product(x, w, PLANS[plan])
        out["tuned"] = _tuned_dispatch(cases["tuned"], workdir, rank)
        x, w = cases["fsdp"]
        resident = sod_fsdp.shard_packed(w, mesh, axis="data")
        with spmd.count_collectives() as counts:
            y = sod_fsdp.sod_fsdp_matmul(x, resident, mesh, axis="data")
        out["fsdp"] = {"y": y, "counts": counts, "resident_vals": resident.vals,
                       "resident_shape": resident.shape}
        x, packed, plan = cases["planned"]
        out["planned"] = {}
        with plan_mod.use_plan(plan):
            for name, w in packed["blocks"]["mlp"].items():
                with registry.record_dispatches() as log:
                    y = sod.apply(x[name], w)
                out["planned"][name] = {"y": y, "keys": [r["key"].mesh for r in log]}
        g, ratio = cases["grad"]
        rows = g.shape[0] // mesh.shape["data"]
        mean, resid = sod_fsdp.compressed_grad_allreduce(
            g[mesh.coords["data"] * rows:(mesh.coords["data"] + 1) * rows], mesh, ratio)
        out["grad"] = {"mean": mean, "resid": resid}
    out["model"] = _model_runs(cases["cfg"], cases["params"], cases["batch"], mesh)
    torch.save(out, workdir / f"rank{rank}.pt")
    return {"rank": rank, "coords": mesh.coords}


def card_plans(workdir: str) -> dict:
    """On the card, a (2, 2) mesh: each plan kind of ``PLANS`` on the two
    formats at bf16, one full-width and a ragged shape, at M = 4 and 77;
    the largest error against the single-process kernel's y and against the
    plain version, both as fractions of the plain output's largest
    magnitude, and a checksum of y (every rank must hold the same).  The
    ragged shapes are (300, 512) and, for the row plan, (512, 300), as
    ``tests/test_spmd.py`` shards them."""
    from repro_torch.core.formats import pack_block_csr, pack_tiled_csc
    from repro_torch.core.pruning import block_prune, magnitude_prune
    from repro_torch.kernels import block_matmul as bmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import sod_matmul as sm

    mesh = mesh_mod.make_test_mesh((2, 2), device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for fmt in ("tiled_csc", "block_csr"):
        for k, n in ((2048, 2048), (300, 512), (512, 300)):
            g = torch.Generator(device="cuda").manual_seed(k + n)
            w = torch.randn(k, n, generator=g, device="cuda").to(torch.bfloat16)
            if fmt == "tiled_csc":
                p, kernel, plain = pack_tiled_csc(magnitude_prune(w, 0.3)), sm, ref.sod_matmul_ref
            else:
                p, kernel, plain = (pack_block_csr(block_prune(w, 0.3)), bmm,
                                    ref.block_matmul_ref)
            for m in (4, 77):
                x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
                y1 = (kernel.sod_matmul if fmt == "tiled_csc" else kernel.block_matmul)(x, p)
                yp = plain(x, p, torch.bfloat16)
                scale = yp.float().abs().max().item()
                for name, plan in PLANS.items():
                    try:
                        spmd._validate(spmd.SpmdPlan(**plan), mesh, p)
                    except ValueError:        # the ragged grid dim does not divide
                        continue
                    before = kernel.launches
                    y = spmd.sod_matmul_spmd(x, p, mesh=mesh, plan=spmd.SpmdPlan(**plan))
                    torch.cuda.synchronize()
                    out[f"{fmt}-{k}x{n}-m{m}-{name}"] = {
                        "vs_kernel": (y.float() - y1.float()).abs().max().item() / scale,
                        "vs_plain": (y.float() - yp.float()).abs().max().item() / scale,
                        "launches": kernel.launches - before,
                        "checksum": float(y.float().sum().item())}
    return out
