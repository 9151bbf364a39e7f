"""Serving driver: batched prefill + greedy decode, or the continuous-batching
engine (``--engine``).

Twin of :mod:`repro.launch.serve`.  Static mode: one batch of synthetic
prompts is prefilled in one forward, the KV cache grown to the generation
horizon, and ``--gen`` greedy tokens decoded step by step; the recurrent
families (``zamba2-2.7b``, ``xlstm-125m``) build their state by stepping
the prompt through the decode step instead, and their engine keeps one
slot-state cache (it refuses the paged-KV features).  ``pixtral-12b`` (the
VLM) serves a prompt of ``--prompt-len`` positions: its ``n_patches`` patch
embeddings, then the text; so ``--prompt-len`` must exceed ``n_patches``
and, once above ``attn_chunk``, be a multiple of it.  As in the reference,
its decode starts at the text's length, not the prompt's (fault R5, kept:
``ROADMAP.md`` §C).  ``musicgen-medium`` (audio) decodes the 4 codebooks of
a step at once, tokens (B, 1, 4).  The engine refuses both families, as
the reference's does.  ``--engine``
replays a synthetic Poisson trace of ``--requests`` requests (prompts of
``--prompt-len // 2`` to ``--prompt-len`` tokens) through
:class:`repro_torch.serving.Engine`: ``--max-slots`` running rows over a
paged KV pool of ``--page-size``-token pages, each prompt prefilled at
admission in one forward or, with ``--prefill-chunk C``, C tokens an engine
step.  The engine's features are the reference CLI's flags:
``--preemption`` (swap the youngest sequence's pages to host memory under
pool pressure), ``--prefix-sharing`` (needs ``--prefill-chunk``),
``--prefix-cache-budget`` / ``--prefix-cache-dir`` (need
``--prefix-sharing``) and ``--spec-decode K``: a draft tier of the same
raw weights in the target's format, at density 1 - ``--draft-sparsity``, or
without that flag at the density the planner's cost model picks
(:func:`repro_torch.runtime.planner.build_draft_plan`).

Runs on CUDA unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.  ``--quantize int8|fp8|codebook`` stores the
packed values quantized (it needs ``--sod``).  The planning flags are the
reference's: ``--plan auto`` builds a per-layer pack plan from the weights
(:mod:`repro_torch.runtime.planner`; ``--quantize auto`` then picks each
layer's qmode under the drift budget), ``--plan PATH`` replays a plan file
written by either package, ``--plan-json PATH`` writes the plan used;
``--autotune`` measures the kernels' launch parameters for every packed
layout at the run's M values into the tuning cache (``--tuning-cache
PATH``, else ``$REPRO_TORCH_TUNING_CACHE``, else
``~/.cache/repro_torch/tuning_cache.json``), which dispatch then reads.

``--trace PATH`` writes a Chrome trace-event JSON timeline (the static
path's ``prefill`` and ``decode_step`` spans on track ``serve``, the
engine's phases and request lifecycle, every kernel dispatch as an
instant on track ``kernels``) and names it in the summary's ``trace``;
``--metrics-json PATH`` writes a metrics snapshot (the static path's
``generated_tokens``, ``prefill_s``, ``warmup_s``, ``steady_s`` and
``decode_step_s``; the engine's registry), as the reference's flags do.

``--sod block_csr`` keeps the reference CLI's magnitude pruning; a caller
that wants block pruning (as the reference's serving bench uses for this
format) passes its own ``SoDConfig`` to :func:`main`.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 4 --prompt-len 32 --gen 16 --sod tiled_csc --density 0.3 \\
      --quantize int8
  PYTHONPATH=src python -m repro_torch.launch.serve --sod tiled_csc \\
      --plan auto --quantize auto --autotune --tuning-cache $TMPDIR/tc.json \\
      --plan-json $TMPDIR/plan.json
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --engine \\
      --requests 8 --prefill-chunk 16 --sod tiled_csc --device cpu \\
      --preemption --prefix-sharing --spec-decode 2 --draft-sparsity 0.9
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import NamedTuple

import torch

from repro_torch import configs, obs
from repro_torch.configs import ModelConfig
from repro_torch.core.plan import ModelPlan, use_plan
from repro_torch.core.sod import SoDConfig, sodify_params, tree_weight_bytes
from repro_torch.data.pipeline import SyntheticLMData, to_device
from repro_torch.kernels import autotune
from repro_torch.kernels import block_matmul as block_matmul_kernel
from repro_torch.kernels import build
from repro_torch.kernels import registry as kreg
from repro_torch.kernels import sod_matmul as sod_matmul_kernel
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import LM, RECURRENT
from repro_torch.runtime import planner
from repro_torch.serving import Engine, bucket_len, poisson_trace


def parse_args(argv=None) -> argparse.Namespace:
    """Command-line flags of the static serve and the engine."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's tiny same-family variant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sod", choices=("tiled_csc", "block_csr"), default=None,
                    help="prune and pack the projections (default: dense)")
    ap.add_argument("--density", type=float, default=0.3)
    ap.add_argument("--quantize", default="none",
                    choices=("none", "int8", "fp8", "codebook", "auto"),
                    help="packed value quantization: int8/fp8 store "
                         "per-tile-scaled codes, codebook a shared-value "
                         "table per layer + 4-bit indices; 'auto' lets the "
                         "planner pick per layer under its drift budget "
                         "(requires --plan auto)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine mode: replay a synthetic "
                         "Poisson request trace (ragged prompt/gen lengths) "
                         "instead of one static batch")
    ap.add_argument("--requests", type=int, default=8,
                    help="engine mode: number of requests in the trace")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="engine mode: Poisson arrival rate, requests per "
                         "engine step")
    ap.add_argument("--max-slots", type=int, default=4,
                    help="engine mode: running-batch capacity")
    ap.add_argument("--page-size", type=int, default=16,
                    help="engine mode: KV page size")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="engine mode: split prompt prefill into chunks of "
                         "this many tokens, interleaved with running decode "
                         "steps (default: fused whole-prompt prefill)")
    ap.add_argument("--preemption", action="store_true",
                    help="engine mode: under pool pressure, swap the youngest "
                         "running sequence's KV pages to host memory instead "
                         "of blocking admission")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="engine mode: map identical prompt prefixes onto "
                         "refcounted KV pages (copy-on-write); requires "
                         "--prefill-chunk")
    ap.add_argument("--prefix-cache-budget", type=int, default=0,
                    metavar="BYTES",
                    help="engine mode: keep completed prompts' prefix pages "
                         "resident under this LRU byte budget, demoting cold "
                         "pages to host memory; requires --prefix-sharing")
    ap.add_argument("--prefix-cache-dir", default=None, metavar="DIR",
                    help="engine mode: spill demoted prefix pages to "
                         "DIR/<token-hash>.npz so the cache survives engine "
                         "restarts; requires --prefix-sharing")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="engine mode: speculative decoding — a sparser pack "
                         "of the same weights drafts K tokens a slot, verified "
                         "in one batched pass (greedy output unchanged)")
    ap.add_argument("--draft-sparsity", type=float, default=None,
                    help="fraction of the draft tier's weights pruned away "
                         "(density = 1 - sparsity); default: the planner's "
                         "cost model picks it from its ladder")
    ap.add_argument("--autotune", action="store_true",
                    help="measure the kernels' launch parameters for this "
                         "model's packed layouts into the tuning cache before "
                         "serving")
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
                    help="write a Chrome trace-event JSON timeline (prefill and "
                         "decode steps, engine phases, request lifecycle, kernel "
                         "dispatch) to PATH; open it in Perfetto or chrome://tracing")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write a counters/gauges/histograms metrics snapshot to PATH")
    args = ap.parse_args(argv)
    if args.prefix_sharing and not args.prefill_chunk:
        ap.error("--prefix-sharing requires --prefill-chunk (prefill must "
                 "be able to start mid-prompt to skip shared positions)")
    if ((args.prefix_cache_budget or args.prefix_cache_dir)
            and not args.prefix_sharing):
        ap.error("--prefix-cache-budget/--prefix-cache-dir require "
                 "--prefix-sharing (the cache retains trie-held pages)")
    if args.spec_decode and not args.engine:
        ap.error("--spec-decode requires --engine (draft/verify windows "
                 "run against the paged KV cache)")
    if args.draft_sparsity is not None and not args.spec_decode:
        ap.error("--draft-sparsity requires --spec-decode")
    if args.quantize != "none" and not args.sod:
        ap.error("--quantize requires Sparse-on-Dense packing "
                 "(pass --sod tiled_csc|block_csr)")
    if args.quantize == "auto" and args.plan != "auto":
        ap.error("--quantize auto needs the planner (pass --plan auto)")
    if args.plan and not args.sod:
        ap.error("--plan requires Sparse-on-Dense packing "
                 "(pass --sod tiled_csc|block_csr)")
    return args


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) or ``cpu``; never a silent CPU fallback."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name)


class Prepared(NamedTuple):
    """What a run serves: the model, its (packed) weights and prompt tokens,
    the pack plan they were packed under (or None), the draft tier's packed
    weights and plan (``--spec-decode``), the autotuner's stats, the wall
    seconds of planning (``plan_s``: building or loading the plan, the
    drift pass of ``--quantize auto`` included) and of ``autotune_s``, and
    a VLM prompt's patch embeddings (float32; None for the other
    families)."""
    model: LM
    params: dict
    tokens: torch.Tensor
    plan: ModelPlan | None = None
    draft: dict | None = None
    draft_plan: ModelPlan | None = None
    tune_stats: dict | None = None
    seconds: dict | None = None
    patch_embeds: torch.Tensor | None = None


def m_values(args: argparse.Namespace, cfg: ModelConfig) -> tuple[int, int]:
    """The (prefill M, decode M) the planner hints and the autotuner tunes
    at, as the reference: static serving prefills ``batch · prompt`` rows
    and decodes ``batch`` (a VLM's prompt counts its patches); the engine
    prefills one prompt at its page bucket
    (or a chunk) and decodes ``max_slots`` rows — a recurrent family's
    engine replays a prompt through the batch-1 decode step (M = 1)."""
    if not args.engine:
        return args.batch * args.prompt_len, args.batch
    if cfg.family in RECURRENT:
        return 1, args.max_slots
    prefill = args.prefill_chunk or bucket_len(args.prompt_len, args.page_size,
                                               cfg.attn_chunk)
    return prefill, args.max_slots


def _raw_params(args: argparse.Namespace, model: LM, device: torch.device):
    """The unpacked weights of ``--seed``, drawn on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    return model.init(gen, device)


def prepare(args: argparse.Namespace, sod: SoDConfig | None = None,
            cfg: ModelConfig | None = None) -> Prepared:
    """The run's :class:`Prepared` on the requested device.

    Weights come from a ``torch.Generator`` seeded with ``--seed`` on the
    device.  With ``--sod`` (or ``sod``, which replaces the config the flags
    build) they are pruned, packed and quantized: under ``--plan`` (built
    from these weights, or loaded) when given, with the tuning cache of
    ``--tuning-cache`` installed first, so the plan's dispatch hints come
    from the file dispatch reads; with ``--spec-decode`` the draft tier is
    packed from the same raw weights first (:func:`prepare_draft`); with
    ``--autotune`` the packed layouts are then tuned at :func:`m_values`.
    ``cfg`` replaces the model config that ``--arch``/``--reduced`` select (a
    caller's depth cut).  On CUDA the kernels are built here, before
    anything is timed.
    """
    device = resolve_device(args.device)
    if cfg is None:
        cfg = configs.get_config(args.arch)
        if args.reduced:
            cfg = configs.reduced(cfg)
    if sod is None and args.sod:
        sod = SoDConfig(mode=args.sod, density=args.density, min_dim=64,
                        qmode="none" if args.quantize == "auto" else args.quantize)
    if sod is not None:
        cfg = cfg.with_(sod=sod)
    if device.type == "cuda":
        build.build_all()
    model = LM(cfg)
    raw = _raw_params(args, model, device)
    plan = draft = draft_plan = tune_stats = None
    seconds = {}
    if cfg.sod.enabled or args.spec_decode:
        cache = autotune.install_cache(args.tuning_cache)
        if cfg.sod.enabled:
            t0 = time.perf_counter()
            plan = planner.load_or_build(
                args.plan, raw, cfg.sod, cfg=cfg, cache=cache,
                m_values=m_values(args, cfg),
                qmode="auto" if args.quantize == "auto" else None)
            _sync(device)
            seconds["plan_s"] = time.perf_counter() - t0
        if args.spec_decode:
            draft, draft_plan = prepare_draft(args, model, raw)
    params = sodify_params(raw, cfg.sod, plan=plan)
    del raw
    if cfg.sod.enabled and args.autotune:
        ms = m_values(args, cfg)
        t0 = time.perf_counter()
        tune_stats = (planner.warmup_plan(plan, ms, cache=cache, device=device)
                      if plan is not None else
                      autotune.warmup_params(params, ms, cache=cache))
        seconds["autotune_s"] = time.perf_counter() - t0
    if args.plan_json and plan is not None:
        plan.save(args.plan_json)
    data = SyntheticLMData(cfg, args.batch, args.prompt_len, seed=args.seed)
    prompt = to_device(data.batch(0), device)
    return Prepared(model, params, prompt["tokens"], plan, draft, draft_plan,
                    tune_stats, seconds, prompt.get("patch_embeds"))


def prepare_draft(args: argparse.Namespace, model: LM, raw=None):
    """``(draft weights, draft plan)`` of ``--spec-decode``: the raw weights
    (``raw``, or drawn again from ``--seed`` on the device, the same bits)
    planned and packed as the draft tier
    (:func:`repro_torch.runtime.planner.build_draft_plan`) in the target's
    format (a dense target gets a ``tiled_csc`` draft), at density ``1 -
    --draft-sparsity`` or the planner's choice."""
    device = resolve_device(args.device)
    raw = _raw_params(args, model, device) if raw is None else raw
    density = None if args.draft_sparsity is None else 1.0 - args.draft_sparsity
    draft_cfg, draft_plan = planner.build_draft_plan(
        raw, model.cfg.sod, draft_density=density, spec_k=args.spec_decode,
        cfg=model.cfg, cache=autotune.get_cache(),
        m_values=m_values(args, model.cfg))
    return sodify_params(raw, draft_cfg, plan=draft_plan), draft_plan


def prefill_cache(model: LM, params, tokens: torch.Tensor, max_len: int,
                  plan: ModelPlan | None = None,
                  patch_embeds: torch.Tensor | None = None):
    """(last-position logits, cache for ``max_len`` positions, the position
    decoding starts at), dispatched under ``plan``: the attention families'
    fused prefill with the KV cache grown to ``max_len``; the recurrent
    families (``hybrid``, ``ssm``) step the prompt through the decode step
    from a zeroed cache, which builds their state exactly, as the reference
    does.  A VLM's ``patch_embeds`` go before its text in the cache, but
    the position returned is the text's length, as the reference's
    (``src/repro/launch/serve.py:31-48``): fault R5, kept for parity, so
    its first decode step writes over a patch's slot (``ROADMAP.md`` §C)."""
    b, s = tokens.shape[:2]
    with use_plan(plan):
        if model.cfg.family in RECURRENT:
            cache = model.init_cache(b, max_len, tokens.device)
            for t in range(s):
                logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1], t)
            return logits[:, -1], cache, s
        last_logits, cache = model.prefill(params, tokens, patch_embeds=patch_embeds)
    return last_logits, model.grow_cache(cache, max_len), s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_tokens(nxt: torch.Tensor, batch: int, cfg: ModelConfig) -> torch.Tensor:
    """Greedy ids as the next decode step's tokens: (B, 1), or (B, 1,
    n_codebooks) for audio (every codebook of a step at once)."""
    if cfg.family == "audio":
        return nxt.reshape(batch, 1, cfg.n_codebooks)
    return nxt.reshape(batch, 1)


def _launches() -> dict[str, int]:
    return {"sod_matmul": sod_matmul_kernel.launches,
            "block_matmul": block_matmul_kernel.launches}


def engine_main(args: argparse.Namespace, model: LM, params, draft=None,
                plan: ModelPlan | None = None,
                draft_plan: ModelPlan | None = None) -> dict:
    """``--engine``: continuous batching over a synthetic Poisson trace, with
    ``draft`` the draft tier's packed weights under ``--spec-decode``, each
    tier dispatched under its plan.  Returns the summary (the reference's
    keys, and the kernels' launches over the engine's run, warmup and both
    tiers included)."""
    cfg = model.cfg
    page = args.page_size
    if cfg.family in RECURRENT:
        max_len = args.prompt_len + args.gen
    else:
        max_len = bucket_len(args.prompt_len, page, cfg.attn_chunk) + args.gen
    eng = Engine(model, params, max_slots=args.max_slots, page_size=page,
                 max_len=max_len, plan=plan, prefill_chunk=args.prefill_chunk,
                 preemption=args.preemption, prefix_sharing=args.prefix_sharing,
                 spec_k=args.spec_decode, draft_params=draft, draft_plan=draft_plan,
                 prefix_cache_budget=args.prefix_cache_budget,
                 prefix_cache_dir=args.prefix_cache_dir)
    trace = poisson_trace(args.requests, args.arrival_rate,
                          max_prompt=args.prompt_len, max_new=args.gen,
                          vocab=cfg.vocab, seed=args.seed)
    launches0 = _launches()
    res = eng.run(trace)
    if args.metrics_json:
        pathlib.Path(args.metrics_json).write_text(
            json.dumps(eng.metrics.snapshot(), indent=2))
    summary = {
        "engine": True, "arch": cfg.name, "requests": args.requests,
        "max_slots": args.max_slots, "page_size": page if eng.paged else None,
        "prefill_chunk": args.prefill_chunk, "preemption": args.preemption,
        "prefix_sharing": args.prefix_sharing, "spec_decode": args.spec_decode,
        "prefix_cache_budget": args.prefix_cache_budget,
        "prefix_cache_dir": args.prefix_cache_dir,
        "sample": res["tokens"][trace[0].rid][:8],
        **res["stats"],
        "kernel_launches": {k: v - launches0[k] for k, v in _launches().items()},
        "tokens": res["tokens"], "trace": trace,
    }
    if draft is not None:
        summary["draft_density"] = (1.0 - args.draft_sparsity
                                    if args.draft_sparsity is not None else
                                    draft_plan.meta["density_choice"]["chosen"])
        summary["draft_bytes"] = tree_weight_bytes(draft)["compressed"]
        if "density_choice" in draft_plan.meta:
            summary["draft_density_choice"] = draft_plan.meta["density_choice"]
    return summary


def _plan_summary(args: argparse.Namespace, prep: Prepared) -> dict:
    """The summary's planning keys: the reference's, and the seconds the
    weights' plan and (with ``--autotune``) their tuning took."""
    seconds = prep.seconds or {}
    out = {k: v for k, v in seconds.items() if k == "plan_s"}
    if args.autotune and prep.tune_stats is not None:
        out["autotune"] = prep.tune_stats
        out["autotune_s"] = seconds.get("autotune_s")
    if prep.plan is not None:
        out["plan_layers"] = len(prep.plan)
        out["plan_bytes"] = prep.plan.compressed_bytes()
    return out


def main(argv=None, sod: SoDConfig | None = None, prepared=None) -> dict:
    """CLI entry point: prints and returns a JSON summary of the run.

    ``sod`` replaces the storage config that ``--sod``/``--density``/
    ``--quantize`` build.  ``prepared`` is a :class:`Prepared` (or its first
    three fields, ``(model, params, tokens)``) from :func:`prepare` on the
    same flags, which the run then serves instead of building its own (a
    caller that keeps the weights packs them once); its plan is the one the
    run dispatches under.  With ``--spec-decode`` and no draft in
    ``prepared``, the draft tier is drawn and packed here.  The engine's
    summary keeps its requests under ``trace``, or with ``--trace`` under
    ``request_trace`` (``trace`` then names the trace file).
    """
    args = parse_args(argv)
    # installed before the registry dispatches or the engine is built:
    # both capture the process's tracer
    tracer = obs.install_tracer(obs.Tracer()) if args.trace else None
    try:
        with torch.inference_mode():
            prep = Prepared(*prepared) if prepared is not None else prepare(args, sod)
            if args.spec_decode and prep.draft is None:
                prep = prep._replace(**dict(zip(("draft", "draft_plan"),
                                                prepare_draft(args, prep.model))))
        with kreg.count_dispatches() as dispatch_counts:
            summary = (_serve_engine(args, prep) if args.engine
                       else _serve_static(args, prep))
        summary["kernel_dispatch"] = dispatch_counts
        summary.update(_plan_summary(args, prep))
        _finish_trace(tracer, args, summary)
    finally:
        if tracer is not None:
            obs.install_tracer(None)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("tokens", "request_trace")
                      and not (k == "trace" and not isinstance(v, str))}))
    return summary


def _finish_trace(tracer, args: argparse.Namespace, summary: dict) -> None:
    """Export the run's trace (with ``--trace``) into the summary's
    ``trace`` and uninstall the tracer, so a later run in the process
    starts with none."""
    if tracer is None:
        return
    if "trace" in summary:
        summary["request_trace"] = summary.pop("trace")
    summary["trace"] = str(tracer.export(args.trace))
    obs.install_tracer(None)


def _serve_engine(args: argparse.Namespace, prep: Prepared) -> dict:
    with torch.inference_mode():
        summary = engine_main(args, prep.model, prep.params, prep.draft,
                              plan=prep.plan, draft_plan=prep.draft_plan)
    summary["device"] = (torch.cuda.get_device_name(prep.tokens.device)
                         if prep.tokens.device.type == "cuda" else "cpu")
    summary["weight_bytes"] = tree_weight_bytes(prep.params)
    return summary


def _serve_static(args: argparse.Namespace, prep: Prepared) -> dict:
    model, params, tokens, plan = prep.model, prep.params, prep.tokens, prep.plan
    tr = obs.get_tracer()
    mets = obs.Metrics() if args.metrics_json else None
    with torch.inference_mode():
        device = tokens.device
        max_len = args.prompt_len + args.gen
        launches0 = _launches()

        _sync(device)
        t0 = time.perf_counter()
        with tr.span("prefill", track="serve", batch=args.batch,
                     prompt_len=args.prompt_len):
            last_logits, cache, pos0 = prefill_cache(model, params, tokens, max_len,
                                                     plan=plan,
                                                     patch_embeds=prep.patch_embeds)
            _sync(device)
        prefill_s = time.perf_counter() - t0

        decode = steps_mod.make_decode_step(model, plan=plan)
        tok = step_tokens(last_logits.argmax(dim=-1), args.batch, model.cfg)
        logits = last_logits
        outs = []
        warmup_s = steady_s = 0.0
        t0 = time.perf_counter()
        for t in range(args.gen):
            ts = time.perf_counter()
            with tr.span("decode_step", track="serve", t=t):
                nxt, logits, cache = decode(params, cache, tok, pos0 + t)
            tok = step_tokens(nxt, args.batch, model.cfg)
            outs.append(nxt)
            if mets is not None:   # the host's time to enqueue the step
                mets.observe("decode_step_s", time.perf_counter() - ts)
            if t == 0:   # the first step pays one-time costs: reported apart
                _sync(device)
                warmup_s = time.perf_counter() - t0
                t0 = time.perf_counter()
        _sync(device)
        if args.gen > 1:
            steady_s = time.perf_counter() - t0
        launches = {k: v - launches0[k] for k, v in _launches().items()}
    if mets is not None:
        mets.counter("generated_tokens", args.batch * args.gen)
        mets.gauge("prefill_s", prefill_s)
        mets.gauge("warmup_s", warmup_s)
        mets.gauge("steady_s", steady_s)
        pathlib.Path(args.metrics_json).write_text(json.dumps(mets.snapshot(), indent=2))

    return {
        "arch": model.cfg.name,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "batch": args.batch, "prompt_len": args.prompt_len,
        "generated": args.gen,
        "prefill_s": prefill_s,
        "warmup_s": warmup_s,
        "steady_tok_per_s": (args.batch * (args.gen - 1) / steady_s
                             if steady_s > 0 else 0.0),
        # row 0's id a step (codebook 0 of an audio step)
        "sample": [int(o.reshape(-1)[0]) for o in outs[:8]],
        # (B, gen), or (B, gen, n_codebooks) for audio
        "generated_ids": torch.cat(outs, 1).tolist() if outs else [],
        "logits_finite": bool(torch.isfinite(logits).all()),
        "kernel_launches": launches,
        "weight_bytes": tree_weight_bytes(params),
    }


if __name__ == "__main__":
    main()
