"""Training entry point: language-model training over Sparse-on-Dense
weights with checkpointing and fault tolerance — twin of
:mod:`repro.launch.train`.

Every packed projection's forward runs the hand-written kernel of its
format (``sod_matmul`` for ``--sod tiled_csc``, ``block_matmul`` for
``--sod block_csr``) under its analytical VJP
(:mod:`repro_torch.kernels.vjp`), whose backward re-densifies each
TiledCSC weight once a step through the ``decompress`` kernel; at full
width (``cfg.remat``) every block is checkpointed, so each forward kernel
launches twice a step.  The optimizer is AdamW with float32 masters and
moments the size of the stored slots (:mod:`repro_torch.optim`); the
padding slots and the integer leaves never move, so training stays on the
pruning mask.  Every family trains through :meth:`LM.loss` on the synthetic
batches of :mod:`repro_torch.data.pipeline`: a VLM's ``--seq`` counts its
patches (the loss reads the text after them; ``patch_proj`` trains through
autograd of its dense product), an audio model's loss averages every
codebook.

Runs on CUDA unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.  The flags are the reference's, and the
summary JSON is the reference's plus ``device``, ``tok_s`` (tokens over
the median seconds of a step after the first), ``step_s``,
``peak_mem_gb``, the kernels' launches and the registry's dispatches over
the training loop, and each checkpoint's seconds and bytes.  As in the
reference, ``--resume`` starts at the latest checkpoint's step, which
already holds that step's update (``ROADMAP.md`` §C).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --steps 12 --batch 8 \\
      --seq 128 --sod tiled_csc --density 0.3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 25 --batch 4 --seq 64 --lr 3e-3 --sod tiled_csc
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import tempfile
import time

import torch

from repro_torch import configs, obs
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.sod import SoDConfig, sodify_params, tree_weight_bytes
from repro_torch.data.pipeline import SyntheticLMData, to_device
from repro_torch.kernels import autotune, build
from repro_torch.kernels import block_matmul as block_matmul_kernel
from repro_torch.kernels import decompress as decompress_kernel
from repro_torch.kernels import registry as kreg
from repro_torch.kernels import sod_matmul as sod_matmul_kernel
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.serve import resolve_device
from repro_torch.models.model import LM
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
from repro_torch.runtime import planner
from repro_torch.runtime.fault import FaultConfig, ResilientRunner

KERNELS = {"sod_matmul": sod_matmul_kernel, "block_matmul": block_matmul_kernel,
           "decompress": decompress_kernel}


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's tiny same-family variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--sod", choices=("tiled_csc", "block_csr"), default=None)
    ap.add_argument("--density", type=float, default=0.3)
    ap.add_argument("--quantize", default="none",
                    choices=("none", "int8", "fp8", "codebook", "auto"),
                    help="packed value quantization: int8/fp8 store "
                         "per-tile-scaled codes, codebook a shared-value table "
                         "+ 4-bit indices; 'auto' lets the planner pick per "
                         "layer under its drift budget (requires --plan auto)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--autotune", action="store_true",
                    help="measure the kernels' launch parameters for this "
                         "model's packed layouts at M = batch·seq into the "
                         "tuning cache before training")
    ap.add_argument("--tuning-cache", default=None,
                    help="tuning-cache JSON path (default: "
                         "$REPRO_TORCH_TUNING_CACHE or "
                         "~/.cache/repro_torch/tuning_cache.json)")
    ap.add_argument("--plan", default=None,
                    help="pack plan: a JSON path to replay (written by either "
                         "package), or 'auto' to build one with the planner; "
                         "default: global-config packing")
    ap.add_argument("--plan-json", default=None,
                    help="write the pack plan used to this path")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON timeline (train "
                         "steps, autotune measurements, kernel dispatch)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write a counters/gauges/histograms snapshot")
    args = ap.parse_args(argv)
    if args.quantize != "none" and not args.sod:
        ap.error("--quantize requires Sparse-on-Dense packing "
                 "(pass --sod tiled_csc|block_csr)")
    if args.quantize == "auto" and args.plan != "auto":
        ap.error("--quantize auto needs the planner (pass --plan auto)")
    if args.plan and not args.sod:
        ap.error("--plan requires Sparse-on-Dense packing "
                 "(pass --sod tiled_csc|block_csr)")
    return args


def prepare(args: argparse.Namespace, cfg: configs.ModelConfig | None = None):
    """``(model, packed params, plan or None)`` on the requested device:
    weights drawn from a ``torch.Generator`` seeded with ``--seed``, then
    (with ``--sod``) planned, pruned, packed and quantized, with the tuning
    cache of ``--tuning-cache`` installed first and, with ``--autotune``,
    the packed layouts tuned at M = batch·seq.  ``cfg`` replaces the model
    config that ``--arch``/``--reduced`` select (a caller's depth cut).  On
    CUDA the kernels are built here."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = configs.get_config(args.arch)
        if args.reduced:
            cfg = configs.reduced(cfg)
    if args.sod:
        cfg = cfg.with_(sod=SoDConfig(
            mode=args.sod, density=args.density, min_dim=64,
            qmode="none" if args.quantize == "auto" else args.quantize))
    if device.type == "cuda":
        build.build_all()
    model = LM(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen, device)
    plan = None
    m = (args.batch * args.seq,)
    if cfg.sod.enabled:
        # installed before planning: the plan's dispatch hints come from
        # the file dispatch reads
        cache = autotune.install_cache(args.tuning_cache)
        plan = planner.load_or_build(
            args.plan, params, cfg.sod, cfg=cfg, cache=cache, m_values=m,
            qmode="auto" if args.quantize == "auto" else None)
        if plan is not None:
            n_dense = sum(e.mode == "dense" for e in plan.entries.values())
            print(f"pack plan: {len(plan)} layers ({len(plan) - n_dense} packed, "
                  f"{n_dense} dense), {plan.compressed_bytes():,} planned bytes")
        params = sodify_params(params, cfg.sod, plan=plan)
        print("sod weight bytes:", tree_weight_bytes(params))
        if args.autotune:
            stats = (planner.warmup_plan(plan, m, cache=cache, device=device)
                     if plan is not None else
                     autotune.warmup_params(params, m, cache=cache))
            print(f"autotune: {stats} -> {cache.path}")
    if args.plan_json and plan is not None:
        print(f"pack plan -> {plan.save(args.plan_json)}")
    return model, params, plan


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, prepared=None) -> dict:
    """CLI entry point: trains, prints the summary JSON and returns it, with
    the per-step ``losses``, ``aux_losses`` (the MoE router aux loss within
    each loss; 0 for the dense family) and ``grad_norms`` and the final
    ``state``
    (``{"params", "opt"}``, not printed).  ``prepared`` is ``(model,
    params, plan)`` from :func:`prepare` on the same flags, trained instead
    of a fresh draw."""
    args = parse_args(argv)
    tracer = obs.install_tracer(obs.Tracer()) if args.trace else None
    mets = obs.Metrics() if args.metrics_json else None
    device = resolve_device(args.device)
    model, params, plan = prepared if prepared is not None else prepare(args)
    cfg = model.cfg

    opt = AdamW(AdamWConfig(lr=args.lr),
                schedule=cosine_schedule(args.lr, args.warmup, args.steps))
    data = SyntheticLMData(cfg, args.batch, args.seq, seed=args.seed)
    train_step = steps_mod.make_train_step(model, opt, plan=plan)
    ckpt = Checkpointer(args.ckpt_dir)

    state = {"params": params, "opt": opt.init(params)}
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        state = ckpt.restore(start, state)
        print(f"resumed from step {start}")

    def do_step(step: int) -> dict:
        batch = to_device(data.batch(step), device)
        p, o, metrics = train_step(state["params"], state["opt"], batch)
        state["params"], state["opt"] = p, o
        _sync(device)
        return metrics

    runner = ResilientRunner(
        step_fn=do_step, checkpointer=ckpt,
        fault=FaultConfig(ckpt_every=args.ckpt_every),
        state_of=lambda: state, load_state=state.update)

    losses, auxes, gnorms, seconds = [], [], [], []
    launches0 = {k: mod.launches for k, mod in KERNELS.items()}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tr = obs.get_tracer()
    toks = args.batch * args.seq
    t0 = time.perf_counter()
    with kreg.count_dispatches() as dispatch_counts:
        for step in range(start, args.steps):
            with tr.span("train_step", track="train", step=step):
                res = runner.run_step(step)
            loss = float(res.metrics["loss"])
            losses.append(loss)
            auxes.append(float(res.metrics["aux"]))
            gnorms.append(float(res.metrics["grad_norm"]))
            seconds.append(res.seconds)
            if mets is not None:
                mets.counter("train_steps")
                mets.observe("train_step_s", res.seconds)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d}  loss {loss:7.4f}  "
                      f"lr {float(res.metrics['lr']):.2e}  gnorm {gnorms[-1]:6.3f}  "
                      f"{toks / max(res.seconds, 1e-9):,.0f} tok/s", flush=True)
    launches = {k: mod.launches - launches0[k] for k, mod in KERNELS.items()}
    ckpt.save(args.steps - 1, state, blocking=True)
    dt = time.perf_counter() - t0
    step_s = statistics.median(seconds[1:] or seconds) if seconds else 0.0
    summary = {
        "arch": cfg.name, "steps": args.steps,
        "first_loss": losses[0], "last_loss": losses[-1],
        "mean_last10": sum(losses[-10:]) / min(len(losses), 10),
        "wall_s": round(dt, 1),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "start_step": start, "step_s": step_s,
        "tok_s": toks / step_s if step_s > 0 else 0.0,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
        "kernel_launches": launches, "kernel_dispatch": dispatch_counts,
        "checkpoints": ckpt.history,
        "losses": losses, "aux_losses": auxes, "grad_norms": gnorms,
    }
    if plan is not None:
        summary["plan_layers"] = len(plan)
        summary["plan_bytes"] = plan.compressed_bytes()
    if mets is not None:
        mets.gauge("wall_s", dt)
        pathlib.Path(args.metrics_json).write_text(json.dumps(mets.snapshot(), indent=2))
    if tracer is not None:
        summary["trace"] = str(tracer.export(args.trace))
        obs.install_tracer(None)
    print(json.dumps(summary))
    summary["state"] = state
    return summary


if __name__ == "__main__":
    main()
