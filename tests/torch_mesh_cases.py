"""Rank bodies of the port's mesh tests (no JAX here: every rank imports
this file).

:func:`spmd_cases` runs, on each rank of a (4, 2) ``gloo`` group on the
CPU, every case that ``tests/test_torch_spmd.py`` wrote to its directory
(``cases.pt``: the operands as the port's containers, the activations, the
reduced model's packed parameters and batch), and saves what it found to
``rank<r>.pt`` for the test to hold against the JAX package: besides the
products and the model's mesh step, MoE's all-to-all dispatch, the engine
on the mesh against a mesh static decode, and a restore of the
reference's checkpoint onto the mesh.  :func:`_partition_runs` runs the
dense family's partitioned steps on a (4, 2) and a (2, 4) mesh of the
same group: loss and gradients, one ZeRO-1 train step, prefill and four
decode steps, a batch whose rows do not divide the data axes, and the
vocab-parallel head and loss; then every other family's (a recurrent
family's prompt stepped through the partitioned decode step).
"""
from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import plan as plan_mod
from repro_torch.core import sod
from repro_torch.core.tree import PACKED_FIELDS, leaves_with_path
from repro_torch.kernels import autotune, ops, registry
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.models import layers, moe
from repro_torch.models.model import LM, RECURRENT
from repro_torch.optim.adamw import AdamW, AdamWConfig, state_dist
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


def _moe_run(params, x, spec) -> dict:
    """y, aux and the gradients of ``sum(y ** 2) + aux`` w.r.t. the
    routed experts and the router, with the collectives counted."""
    live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    with spmd.count_collectives() as counts:
        y, aux = moe.moe_mlp(live, x, moe.MoESpec(**spec))
        ((y ** 2).sum() + aux).backward()
    return {"y": y.detach(), "aux": aux.detach(), "counts": counts,
            "grads": {k: live[k].grad for k in ("w_gate", "w_up", "w_down", "router")}}


def _moe_cases(cases: dict) -> dict:
    """Under the active mesh: the a2a spec, the same spec without its axis
    (the capacity dispatch in 8 blocks), and the t = 17 spec whose tokens
    do not divide (the block path)."""
    out = {}
    for name, (params, x, spec) in cases.items():
        out[name] = _moe_run(params, x, spec)
        if spec.get("a2a_axis"):
            out[name + "_block"] = _moe_run(params, x, dict(spec, a2a_axis=None))
    return out


def _engine_case(cfg, params, prompts, mesh) -> dict:
    """The engine on the mesh (placed weights) against the mesh static
    decode, request by request."""
    from repro_torch.serving.engine import Engine, mesh_static_generate
    from repro_torch.serving.scheduler import Request

    model = LM(cfg)
    placed = sharding.place(params, sharding.param_specs(params, cfg, mesh), mesh)
    reqs = [Request(rid=i, tokens=np.asarray(p, np.int32), max_new=6, arrival=i)
            for i, p in enumerate(prompts)]
    with registry.record_dispatches() as log:
        got = Engine(model, placed, max_slots=2, page_size=8, max_len=48,
                     mesh=mesh).run(reqs)["tokens"]
    return {"engine": {int(k): list(v) for k, v in got.items()},
            "static": {r.rid: mesh_static_generate(model, placed, r, mesh) for r in reqs},
            "keys": sorted({r["key"].mesh for r in log})}


def _restore_case(ckdir, cfg, params, mesh) -> dict:
    """A checkpoint the reference wrote, restored onto the mesh, against
    ``place`` of the whole leaves; and ``unplace(place(p))`` against p."""
    specs = sharding.param_specs(params, cfg, mesh)
    want = sharding.place(params, specs, mesh)
    got = Checkpointer(ckdir).restore(0, want, shardings=(specs, mesh))
    back = sharding.unplace(want, specs, mesh)

    def same(a, b):
        pairs = list(zip(leaves_with_path(a), leaves_with_path(b)))
        return len(pairs) == len(list(leaves_with_path(b))) and all(
            na == nb and ta.dtype == tb.dtype and torch.equal(ta, tb)
            for (na, ta), (nb, tb) in pairs)

    def meta(tree):
        return [(w.shape, w.shard) for _, w in _packed_items(tree)]

    return {"restored_equal": same(got, want), "restored_meta": meta(got) == meta(want),
            "unplaced_equal": same(back, params), "unplaced_meta": meta(back) == meta(params),
            "n_sharded": sum(w.shard is not None for _, w in _packed_items(want))}


def _packed_items(tree, path=""):
    if isinstance(tree, tuple(PACKED_FIELDS)):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _packed_items(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _packed_items(v, f"{path}[{i}]")


def _dry_cases(cases: dict, mesh) -> dict:
    """Each cell's step on this rank's real tensors, counted as the dry-run
    counts it (:func:`repro_torch.launch.dryrun.measure`)."""
    from repro_torch.launch import dryrun

    out = {}
    for name, (cfg, shape, plan, params, inputs) in cases.items():
        found = dryrun.measure(cfg, shape, mesh, plan, params=params, inputs=inputs)
        found.pop("dispatch_log")
        out[name] = found
    return out


PARTITION_MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x8": (1, 8)}
DENSE_MESHES = ("4x2", "2x4")       # the dense family's cases run on these
# AdamW's first step moves each parameter by about lr · sign(g): a gradient
# within rounding of 0 may take the other sign on the mesh (one of 8192
# elements did, at 1e-3), which at 1e-4 stays within 1e-5 of the leaf
PARTITION_LR = 1e-4


def _serve(model, params, tokens, mesh, n_steps: int = 4, patch_embeds=None,
           max_len: int | None = None, offsets=None, seq_shard: bool = True) -> dict:
    """Prefill of ``tokens`` (a VLM's after its ``patch_embeds``; a
    recurrent family's stepped through the decode step from a zeroed
    cache) into a cache of ``max_len`` positions and ``n_steps`` greedy
    decode steps from the prompt's true end, each fed the step before's
    tokens, at ``start + t`` or, with ``offsets`` (B,), at ``start +
    offsets + t`` a row: every step's tokens and logits, the cache's
    length and the KV leaf's shape as the rank keeps it (or None).  With
    ``seq_shard`` the decode step is given ``max_len`` (by default what
    the steps need, rounded up to a multiple of ``model`` on a mesh), so
    it splits the cache's sequence; without, ``max_len`` is what the steps
    need and the cache keeps every position."""
    start = tokens.shape[1] + (0 if patch_embeds is None else patch_embeds.shape[1])
    far = start + n_steps + 1 + (0 if offsets is None else int(offsets.max()))
    tp = 1 if mesh is None or not seq_shard else mesh.shape["model"]
    max_len = max_len or -(-far // tp) * tp
    with torch.no_grad():
        if model.cfg.family in RECURRENT:     # stepped, as prefill_cache does
            nxt, cache = steps.make_stepped_prefill(model, mesh=mesh, seq_shard=seq_shard)(
                params, tokens, max_len)
        else:
            nxt, cache = steps.make_prefill_step(model, mesh=mesh)(
                params, tokens, patch_embeds=patch_embeds)
            cache = model.grow_cache(cache, max_len)
        decode = steps.make_decode_step(model, mesh=mesh,
                                        seq_len=max_len if seq_shard else None)
        toks, logits, tok = [nxt], [], nxt[:, None]
        for t in range(n_steps):
            pos = start + t if offsets is None else start + offsets + t
            tok, lg, cache = decode(params, cache, tok, pos)
            toks.append(tok[:, 0])
            logits.append(lg)
    kv = cache.get("k") if isinstance(cache, dict) else None
    return {"tokens": torch.stack(toks), "logits": torch.stack(logits), "max_len": max_len,
            "kv_shape": None if kv is None else tuple(kv.shape)}


def _seq_runs(cases: dict, mesh) -> dict:
    """Each sequence-split decode case on ``mesh``: its weights placed,
    :func:`_serve` of its prompt into its cache length."""
    out = {}
    for name, case in cases.items():
        placed = sharding.place(case["params"],
                                sharding.param_specs(case["params"], case["cfg"], mesh), mesh)
        with spmd.count_collectives() as counts:
            out[name] = _serve(LM(case["cfg"]), placed, case["tokens"], mesh,
                               n_steps=case["n_steps"], max_len=case["max_len"],
                               offsets=case.get("offsets"))
        out[name]["counts"] = counts
    return out


def seq_cases(workdir: str) -> dict:
    """The cases of ``seq_cases.pt`` (``tests/test_torch_seq_partition.py``)
    on each of PARTITION_MESHES over the 8 ranks; saves each rank's
    results to ``seq_rank<r>.pt``."""
    t0 = time.perf_counter()
    workdir = pathlib.Path(workdir)
    cases = torch.load(workdir / "seq_cases.pt", weights_only=False)
    mesh = mesh_mod.make_fake_mesh(device="cpu")
    out = {}
    for name, shape in PARTITION_MESHES.items():
        m = mesh if name == "4x2" else mesh_mod.make_test_mesh(shape, device="cpu")
        out[name] = _seq_runs(cases, m)
    torch.save(out, workdir / f"seq_rank{mesh.rank}.pt")
    return {"rank": mesh.rank, "seconds": time.perf_counter() - t0}


def _vocab_case(case: dict, mesh) -> dict:
    """The vocab-parallel head (gemma-2's soft-cap), cross-entropy with a
    loss mask, and embedding on the rank's vocabulary block of a tied
    table: the loss, the whole table's gradient, and the embedded rows."""
    part = spmd.Partition(mesh, mesh_mod.dp_axes(mesh))
    table, h, targets, mask, tokens = (case[k] for k in ("table", "h", "targets", "mask",
                                                          "tokens"))
    vocab, tp = table.shape[0], mesh.shape["model"]
    rows = h.shape[0] // mesh.shape["data"]
    block = table.narrow(0, mesh.coords["model"] * (vocab // tp), vocab // tp)
    live = block.clone().requires_grad_(True)
    own = slice(mesh.coords["data"] * rows, (mesh.coords["data"] + 1) * rows)
    with spmd.use_partition(part):
        logits = layers.lm_head(h[own], live, True, case["cap"], vocab=vocab)
        loss = layers.cross_entropy(logits, targets[own], mask[own], vocab=vocab)
        loss.backward()
        x = layers.embed(live.detach(), tokens[own], vocab=vocab)
    grad = spmd.all_reduce(live.grad, mesh, "data")
    return {"loss": loss.detach(), "table_grad": sharding.unplace(grad, ("model", None), mesh),
            "embed": spmd.all_gather(x, mesh, "data", 0, "output_bytes")}


def _padded_local(cases: dict, mesh) -> dict:
    """A packed product inside the partitioned program whose split grid dim
    has a padded tail (N = 500 over Nt = 4 column tiles; K = 500 over 4
    row tiles): the rank's rows of x in, the whole N out; y and the
    gradients of ``sum(y ** 2)`` (x's rows, and the whole ``vals`` after
    ``unplace``)."""
    out = {}
    part = spmd.Partition(mesh, ("data",))
    for name, (x, w, spec) in cases.items():
        specs = spmd.packed_specs(w, *spec)
        placed = sharding.place(w, specs, mesh)
        rows = x.shape[0] // mesh.shape["data"]
        x_l = x[mesh.coords["data"] * rows:(mesh.coords["data"] + 1) * rows].clone()
        x_l.requires_grad_(True)
        vals = placed.vals.clone().requires_grad_(True)
        with spmd.use_partition(part), spmd.count_collectives() as counts:
            y = ops.sod_matmul(x_l, dataclasses.replace(placed, vals=vals))
            (y ** 2).sum().backward()
        grad = dataclasses.replace(placed, vals=vals.grad)
        out[name] = {"y": y.detach(), "x": x_l.grad,
                     "vals": sharding.unplace(grad, specs, mesh).vals, "counts": counts}
    return out


def _steps_on_mesh(cfg, params, batch, mesh, serve: dict, seq_shard: bool = True) -> dict:
    """The partitioned steps of ``cfg`` on ``mesh``: ``loss_and_grads`` on
    the global batch and on its first 3 rows (which divide no data axis:
    the whole-rows rule), every gradient ``unplace``d; one ZeRO-1
    ``train_step`` (the optimizer state placed by ``opt_state_specs``),
    the whole state after it; prefill and four decode steps of ``serve``
    (``tokens``, and a VLM's ``patch_embeds``), the cache's sequence split
    over ``model`` where ``seq_shard`` (:func:`_serve`)."""
    model = LM(cfg)
    specs = sharding.param_specs(params, cfg, mesh)
    placed = sharding.place(params, specs, mesh)
    row = {}
    for name, b in (("batch", batch), ("rows3", {k: v[:3] for k, v in batch.items()})):
        with spmd.count_collectives() as counts, registry.record_dispatches() as log:
            loss, metrics, grads = steps.make_loss_and_grads(model, mesh=mesh)(placed, b)
        row[name] = {"loss": loss, "metrics": metrics, "counts": counts,
                     "grads": sharding.unplace(grads, specs, mesh),
                     "keys": sorted({r["key"].mesh for r in log})}
    opt = AdamW(AdamWConfig(lr=PARTITION_LR))
    whole = opt.init(params)
    o_specs = sharding.opt_state_specs(whole, specs, mesh, cfg=cfg)
    state = sharding.place(whole, o_specs, mesh)
    new_p, new_s, metrics = steps.make_train_step(model, opt, mesh=mesh)(placed, state, batch)
    row["train"] = {
        "metrics": metrics,
        "state": sharding.unplace({"params": new_p, "opt": new_s},
                                  sharding.train_state_specs(specs, o_specs), mesh),
        "zero_split": sum(sharding.is_split(a) for a in _spec_leaves(o_specs["m"]))}
    with spmd.count_collectives() as counts:
        row["serve"] = _serve(model, placed, serve["tokens"], mesh,
                              patch_embeds=serve.get("patch_embeds"), seq_shard=seq_shard)
    row["serve"]["counts"] = counts
    return row


def _partition_runs(cases: dict, mesh, name: str) -> dict:
    """The partitioned steps on ``mesh`` (``name``, its shape): the dense
    family's reduced llama in fp32 packed (``tiled_csc``) and dense
    (:func:`_steps_on_mesh`), and the vocab-parallel head, loss and
    embedding (on DENSE_MESHES); then each of ``cases["families"]`` whose meshes hold
    ``name``: the MoE, VLM, audio, hybrid and xLSTM families (reduced,
    fp32)."""
    out = {}
    if name in DENSE_MESHES:
        for mode in ("tiled_csc", "dense"):
            cfg, params = cases["partition"][mode]
            # the dense weights serve at the length the steps need, every
            # position kept: the layout where the sequence does not split
            out[mode] = _steps_on_mesh(cfg, params, cases["batch"], mesh,
                                       {"tokens": cases["batch"]["tokens"][:, :16]},
                                       seq_shard=mode == "tiled_csc")
        out["vocab"] = _vocab_case(cases["vocab"], mesh)
        out["padded"] = _padded_local(cases["padded"], mesh)
    for case, (cfg, params, batch, serve, meshes) in cases["families"].items():
        if name in meshes:
            out[case] = _steps_on_mesh(cfg, params, batch, mesh, serve)
    return out


def _spec_leaves(specs):
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    if isinstance(specs, tuple(PACKED_FIELDS)):
        return [getattr(specs, f) for f in PACKED_FIELDS[type(specs)]
                if getattr(specs, f) is not None]
    return [specs]


def spmd_cases(workdir: str) -> dict:
    """Every case of ``cases.pt``; returns a summary, saves the tensors."""
    t0 = time.perf_counter()
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
        out["moe"] = _moe_cases(cases["moe"])
    out["model"] = _model_runs(cases["cfg"], cases["params"], cases["batch"], mesh)
    out["dry"] = _dry_cases(cases["dry"], mesh)
    out["engine"] = _engine_case(cases["cfg"], cases["params"], cases["prompts"], mesh)
    out["restore"] = _restore_case(workdir / "ref_ckpt", cases["cfg"], cases["params"], mesh)
    seconds = {"before_partition": time.perf_counter() - t0}
    out["partition"] = {}
    for name, shape in PARTITION_MESHES.items():
        t0 = time.perf_counter()
        m = mesh if name == "4x2" else mesh_mod.make_test_mesh(shape, device="cpu")
        out["partition"][name] = _partition_runs(cases, m, name)
        seconds[name] = time.perf_counter() - t0
    torch.save(out, workdir / f"rank{rank}.pt")
    return {"rank": rank, "coords": mesh.coords, "seconds": seconds}


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


def elastic_case(workdir: str) -> dict:
    """Six ranks as a (3, 2) mesh take two train steps and save the whole
    state; ranks 2 and 3 then fail, the other four re-mesh to (2, 2)
    (``fault.surviving_mesh``), restore the checkpoint onto it and take one
    more step.  Returns the step's loss on the survivors, and on the new
    rank 0 the whole state after the step (``sharding.unplace``) against
    one process's step on the same checkpoint (``adamw.state_dist``)."""
    import torch.distributed as dist

    from repro_torch.runtime import fault

    workdir = pathlib.Path(workdir)
    cases = torch.load(workdir / "elastic.pt", weights_only=False)
    cfg, params, batches = cases["cfg"], cases["params"], cases["batches"]
    mesh = mesh_mod.make_test_mesh((3, 2), device="cpu")
    model, opt = LM(cfg), AdamW(AdamWConfig(lr=1e-3))
    specs = sharding.param_specs(params, cfg, mesh)
    placed = sharding.place(params, specs, mesh)
    state = opt.init(placed)
    step = steps.make_train_step(model, opt, mesh=mesh)
    for batch in batches[:2]:
        placed, state, _ = step(placed, state, batch)
    whole = sharding.unplace({"params": placed, "opt": state},
                             sharding.train_state_specs(specs), mesh)
    if mesh.rank == 0:
        Checkpointer(workdir / "elastic_ckpt").save(2, whole)
    dist.barrier()
    failed = set(cases["failed"])
    if mesh.rank in failed:        # these ranks are lost: they leave the group
        dist.destroy_process_group()
        return {"rank": mesh.rank, "failed": True}
    new = fault.surviving_mesh(range(mesh.size), failed, mesh.shape["model"], device="cpu")
    if new is None:
        return {"rank": mesh.rank, "failed": False, "left": True}
    new_specs = sharding.train_state_specs(sharding.param_specs(params, cfg, new))
    ck = Checkpointer(workdir / "elastic_ckpt")
    restored = ck.restore(2, {"params": placed, "opt": state}, shardings=(new_specs, new))
    with registry.record_dispatches() as log:
        p, s, metrics = steps.make_train_step(model, opt, mesh=new)(
            restored["params"], restored["opt"], batches[2])
    after = sharding.unplace({"params": p, "opt": s}, new_specs, new)
    out = {"rank": mesh.rank, "failed": False, "new_rank": new.rank,
           "shape": list(new.axis_sizes), "loss": float(metrics["loss"]),
           "keys": sorted({r["key"].mesh for r in log})}
    if new.rank == 0:       # one process on the same checkpoint, the same step
        one = ck.restore(2, {"params": params, "opt": opt.init(params)})
        p1, s1, _ = steps.make_train_step(model, opt)(one["params"], one["opt"], batches[2])
        out["state_err"] = state_dist(after, {"params": p1, "opt": s1})
    return out


def card_phase15(workdir: str) -> dict:
    """On the card, a (2, 2) mesh of four ranks at reduced size (bf16):
    MoE's all-to-all against the capacity dispatch in 4 blocks (the
    largest error as a fraction of the block dispatch's largest magnitude,
    the exchange's calls); ``Engine(mesh=)`` against the mesh
    static decode (reduced llama, tiled_csc); a whole checkpoint restored
    onto the mesh against ``place`` and ``unplace(place(p))`` against p;
    last, the elastic re-mesh (ranks 2 and 3 lost, (1, 2), one step's loss
    and whole state after it against one process's on the same
    checkpoint)."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLMData, to_device
    from repro_torch.runtime import fault
    from repro_torch.serving.engine import Engine, mesh_static_generate
    from repro_torch.serving.scheduler import Request

    workdir = pathlib.Path(workdir)
    mesh = mesh_mod.make_test_mesh((2, 2), device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": mesh.rank}

    spec = dict(n_experts=8, n_experts_padded=8, top_k=2, d_model=256, d_ff=512,
                capacity_factor=8.0, dispatch_blocks=4, a2a_axis="model")
    gen = torch.Generator(device="cuda").manual_seed(3)
    mp = moe.init_moe(gen, moe.MoESpec(**spec), torch.bfloat16, torch.device("cuda"))
    x = torch.randn(4, 32, 256, generator=gen, device="cuda").to(torch.bfloat16)
    with mesh_mod.mesh_context(mesh), spmd.count_collectives() as counts:
        y, aux = moe.moe_mlp(mp, x, moe.MoESpec(**spec))
        yb, auxb = moe.moe_mlp(mp, x, moe.MoESpec(**dict(spec, a2a_axis=None)))
    torch.cuda.synchronize()
    scale = yb.float().abs().max().item()
    out["moe"] = {"rel_err": (y.float() - yb.float()).abs().max().item() / scale,
                  "aux_err": abs(float(aux) - float(auxb)),
                  "all_to_all": counts.get("counts", {}).get("all-to-all", 0),
                  "checksum": float(y.float().sum())}

    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        sod=sod.SoDConfig(mode="tiled_csc", density=0.3, min_dim=64))
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = sod.sodify_params(LM(cfg).init(gen, "cuda"), cfg.sod)
    specs = sharding.param_specs(params, cfg, mesh)
    placed = sharding.place(params, specs, mesh)
    model = LM(cfg)
    reqs = [Request(rid=i, tokens=list(range(3 + i, 3 + i + n)), max_new=6, arrival=i)
            for i, n in enumerate((5, 11, 8))]
    with torch.inference_mode():
        eng = Engine(model, placed, max_slots=2, page_size=8, max_len=48, mesh=mesh).run(reqs)
        static = {r.rid: mesh_static_generate(model, placed, r, mesh) for r in reqs}
    out["engine"] = {"equal": {int(k): list(v) for k, v in eng["tokens"].items()} == static}

    Checkpointer(workdir / f"whole{mesh.rank}").save(0, params)
    got = Checkpointer(workdir / f"whole{mesh.rank}").restore(0, placed,
                                                               shardings=(specs, mesh))
    back = sharding.unplace(placed, specs, mesh)
    out["restore"] = {
        "restored": all(torch.equal(a, b) for (_, a), (_, b) in
                        zip(leaves_with_path(got), leaves_with_path(placed))),
        "unplaced": all(torch.equal(a, b) for (_, a), (_, b) in
                        zip(leaves_with_path(back), leaves_with_path(params)))}

    opt = AdamW(AdamWConfig(lr=1e-3))
    state = opt.init(placed)
    data = SyntheticLMData(cfg, 4, 32, seed=0)
    step = steps.make_train_step(model, opt, mesh=mesh)
    for i in range(2):
        placed, state, _ = step(placed, state, to_device(data.batch(i), "cuda"))
    whole = sharding.unplace({"params": placed, "opt": state},
                             sharding.train_state_specs(specs), mesh)
    ck = Checkpointer(workdir / "elastic")
    if mesh.rank == 0:
        ck.save(2, whole)
    dist.barrier()
    if mesh.rank in (2, 3):
        dist.destroy_process_group()
        out["elastic"] = {"failed": True}
        return out
    new = fault.surviving_mesh(range(4), {2, 3}, 2, device="cuda")
    new_specs = sharding.train_state_specs(sharding.param_specs(params, cfg, new))
    restored = ck.restore(2, {"params": placed, "opt": state}, shardings=(new_specs, new))
    batch = to_device(data.batch(2), "cuda")
    p, s, m = steps.make_train_step(model, opt, mesh=new)(restored["params"],
                                                         restored["opt"], batch)
    after = sharding.unplace({"params": p, "opt": s}, new_specs, new)
    one = ck.restore(2, {"params": params, "opt": opt.init(params)})
    p1, s1, m1 = steps.make_train_step(model, opt)(one["params"], one["opt"], batch)
    out["elastic"] = {"failed": False, "shape": list(new.axis_sizes), "loss": float(m["loss"]),
                      "loss_one_process": float(m1["loss"]),
                      "state_err": state_dist(after, {"params": p1, "opt": s1})}
    return out


def card_seq_decode(workdir: str) -> dict:
    """On the card, a (2, 2) mesh: reduced llama3.2-1b (fp32, tiled_csc), a
    22-token prompt of 8 rows into a 48-position cache and 4 greedy steps,
    the partitioned decode step on each rank's block of positions against
    one process on the card: the largest logit error as a fraction of the
    largest logit, tokens equal, the rank's KV leaf's shape and its
    ``sod_matmul`` launches."""
    from repro_torch import configs
    from repro_torch.kernels import sod_matmul as sm

    mesh = mesh_mod.make_test_mesh((2, 2), device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        dtype="float32", sod=sod.SoDConfig(mode="tiled_csc", density=0.5, min_dim=64))
    model = LM(cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = sod.sodify_params(model.init(gen, "cuda"), cfg.sod)
    placed = sharding.place(params, sharding.param_specs(params, cfg, mesh), mesh)
    tokens = torch.randint(0, cfg.vocab, (8, 22), generator=gen, device="cuda")
    one = _serve(model, params, tokens, None, max_len=48)
    before = sm.launches
    got = _serve(model, placed, tokens, mesh, max_len=48)
    torch.cuda.synchronize()
    scale = one["logits"].abs().max().item()
    return {"rank": mesh.rank,
            "rel_err": (got["logits"] - one["logits"]).abs().max().item() / scale,
            "tokens_equal": bool(torch.equal(got["tokens"], one["tokens"])),
            "kv_shape": list(got["kv_shape"]),
            "launches": sm.launches - before}
