"""Serving driver: batched prefill + greedy decode, or the continuous-batching
engine (``--engine``).

Twin of :mod:`repro.launch.serve`.  Static mode: one batch of synthetic
prompts is prefilled in one forward, the KV cache grown to the generation
horizon, and ``--gen`` greedy tokens decoded step by step.  ``--engine``
replays a synthetic Poisson trace of ``--requests`` requests (prompts of
``--prompt-len // 2`` to ``--prompt-len`` tokens) through
:class:`repro_torch.serving.Engine`: ``--max-slots`` running rows over a
paged KV pool of ``--page-size``-token pages, each prompt prefilled at
admission in one forward or, with ``--prefill-chunk C``, C tokens an engine
step.  The engine's features are the reference CLI's flags:
``--preemption`` (swap the youngest sequence's pages to host memory under
pool pressure), ``--prefix-sharing`` (needs ``--prefill-chunk``),
``--prefix-cache-budget`` / ``--prefix-cache-dir`` (need
``--prefix-sharing``) and ``--spec-decode K`` with ``--draft-sparsity S``:
a draft tier of the same raw weights pruned to density 1 - S in the
target's format.  The reference lets its planner pick the draft density
when ``--draft-sparsity`` is absent; the port has no planner yet and errors.

Runs on CUDA unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.  ``--quantize int8|fp8|codebook`` stores the
packed values quantized (it needs ``--sod``).  ``--plan`` (and so
``--quantize auto``) and ``--autotune`` are not ported yet.

``--sod block_csr`` keeps the reference CLI's magnitude pruning; a caller
that wants block pruning (as the reference's serving bench uses for this
format) passes its own ``SoDConfig`` to :func:`main`.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 4 --prompt-len 32 --gen 16 --sod tiled_csc --density 0.3 \\
      --quantize int8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --engine \\
      --requests 8 --prefill-chunk 16 --sod tiled_csc --device cpu \\
      --preemption --prefix-sharing --spec-decode 2 --draft-sparsity 0.9
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs
from repro_torch.configs import ModelConfig
from repro_torch.core.sod import SoDConfig, sodify_params, tree_weight_bytes
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import block_matmul as block_matmul_kernel
from repro_torch.kernels import build
from repro_torch.kernels import sod_matmul as sod_matmul_kernel
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import LM
from repro_torch.runtime.planner import _draft_sod_cfg
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
                         "table per layer + 4-bit indices ('auto' needs the "
                         "planner, not ported yet)")
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
                         "(density = 1 - sparsity); required with "
                         "--spec-decode")
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
    if args.spec_decode and args.draft_sparsity is None:
        ap.error("--spec-decode: the draft density choice comes with the "
                 "planner (ROADMAP queue A item 4); pass --draft-sparsity")
    if args.quantize != "none" and not args.sod:
        ap.error("--quantize requires Sparse-on-Dense packing "
                 "(pass --sod tiled_csc|block_csr)")
    if args.quantize == "auto":
        ap.error("--quantize auto needs the planner (--plan auto), which is "
                 "not ported yet")
    return args


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) or ``cpu``; never a silent CPU fallback."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name)


def prepare(args: argparse.Namespace, sod: SoDConfig | None = None,
            cfg: ModelConfig | None = None):
    """(model, params, prompt tokens (B, S) int64) on the requested device.

    Weights come from a ``torch.Generator`` seeded with ``--seed`` on the
    device; with ``--sod`` (or ``sod``, which replaces the config the flags
    build) they are pruned, packed and quantized.  ``cfg`` replaces the
    model config that ``--arch``/``--reduced`` select (a caller's depth
    cut).  On CUDA the kernels are built here, before anything is timed.
    """
    device = resolve_device(args.device)
    if cfg is None:
        cfg = configs.get_config(args.arch)
        if args.reduced:
            cfg = configs.reduced(cfg)
    if sod is None and args.sod:
        sod = SoDConfig(mode=args.sod, density=args.density, min_dim=64,
                        qmode=args.quantize)
    if sod is not None:
        cfg = cfg.with_(sod=sod)
    if device.type == "cuda":
        build.build_all()
    model = LM(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = sodify_params(model.init(gen, device), cfg.sod)
    data = SyntheticLMData(cfg, args.batch, args.prompt_len, seed=args.seed)
    tokens = torch.from_numpy(data.batch(0)["tokens"]).long().to(device)
    return model, params, tokens


def prepare_draft(args: argparse.Namespace, model: LM):
    """The draft tier of ``--spec-decode``: the raw weights :func:`prepare`
    drew (drawn again from ``--seed`` on the same device, so the same bits)
    pruned to density ``1 - --draft-sparsity`` and packed in the target's
    format (``_draft_sod_cfg``; a dense target gets a ``tiled_csc`` draft).
    The raw weights are dropped once packed."""
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    return sodify_params(model.init(gen, device),
                         _draft_sod_cfg(model.cfg.sod, 1.0 - args.draft_sparsity))


def prefill_cache(model: LM, params, tokens: torch.Tensor, max_len: int):
    """(last-position logits, KV cache grown to ``max_len``, prompt length)."""
    last_logits, cache = model.prefill(params, tokens)
    return last_logits, model.grow_cache(cache, max_len), tokens.shape[1]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict[str, int]:
    return {"sod_matmul": sod_matmul_kernel.launches,
            "block_matmul": block_matmul_kernel.launches}


def engine_main(args: argparse.Namespace, model: LM, params, draft=None) -> dict:
    """``--engine``: continuous batching over a synthetic Poisson trace, with
    ``draft`` the draft tier's packed weights under ``--spec-decode``.
    Returns the summary (the reference's keys, and the kernels' launches
    over the engine's run, warmup and both tiers included)."""
    cfg = model.cfg
    page = args.page_size
    max_len = bucket_len(args.prompt_len, page, cfg.attn_chunk) + args.gen
    eng = Engine(model, params, max_slots=args.max_slots, page_size=page,
                 max_len=max_len, prefill_chunk=args.prefill_chunk,
                 preemption=args.preemption, prefix_sharing=args.prefix_sharing,
                 spec_k=args.spec_decode, draft_params=draft,
                 prefix_cache_budget=args.prefix_cache_budget,
                 prefix_cache_dir=args.prefix_cache_dir)
    trace = poisson_trace(args.requests, args.arrival_rate,
                          max_prompt=args.prompt_len, max_new=args.gen,
                          vocab=cfg.vocab, seed=args.seed)
    launches0 = _launches()
    res = eng.run(trace)
    summary = {
        "engine": True, "arch": cfg.name, "requests": args.requests,
        "max_slots": args.max_slots, "page_size": page,
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
        summary["draft_density"] = 1.0 - args.draft_sparsity
        summary["draft_bytes"] = tree_weight_bytes(draft)["compressed"]
    return summary


def main(argv=None, sod: SoDConfig | None = None, prepared=None) -> dict:
    """CLI entry point: prints and returns a JSON summary of the run.

    ``sod`` replaces the storage config that ``--sod``/``--density``/
    ``--quantize`` build.  ``prepared`` is ``(model, params, tokens)`` from
    :func:`prepare` on the same flags, which the run then serves instead of
    building its own (a caller that keeps the weights packs them once).
    """
    args = parse_args(argv)
    if args.engine:
        with torch.inference_mode():
            model, params, tokens = prepared or prepare(args, sod)
            draft = prepare_draft(args, model) if args.spec_decode else None
            summary = engine_main(args, model, params, draft)
        summary["device"] = (torch.cuda.get_device_name(tokens.device)
                             if tokens.device.type == "cuda" else "cpu")
        summary["weight_bytes"] = tree_weight_bytes(params)
        print(json.dumps({k: v for k, v in summary.items()
                          if k not in ("tokens", "trace")}))
        return summary
    with torch.inference_mode():
        model, params, tokens = prepared or prepare(args, sod)
        device = tokens.device
        max_len = args.prompt_len + args.gen
        launches0 = _launches()

        _sync(device)
        t0 = time.perf_counter()
        last_logits, cache, pos0 = prefill_cache(model, params, tokens, max_len)
        _sync(device)
        prefill_s = time.perf_counter() - t0

        decode = steps_mod.make_decode_step(model)
        tok = last_logits.argmax(dim=-1).reshape(args.batch, 1)
        logits = last_logits
        outs = []
        warmup_s = steady_s = 0.0
        t0 = time.perf_counter()
        for t in range(args.gen):
            nxt, logits, cache = decode(params, cache, tok, pos0 + t)
            tok = nxt.reshape(args.batch, 1)
            outs.append(nxt)
            if t == 0:   # the first step pays one-time costs: reported apart
                _sync(device)
                warmup_s = time.perf_counter() - t0
                t0 = time.perf_counter()
        _sync(device)
        if args.gen > 1:
            steady_s = time.perf_counter() - t0
        launches = {k: v - launches0[k] for k, v in _launches().items()}

    summary = {
        "arch": model.cfg.name,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "batch": args.batch, "prompt_len": args.prompt_len,
        "generated": args.gen,
        "prefill_s": prefill_s,
        "warmup_s": warmup_s,
        "steady_tok_per_s": (args.batch * (args.gen - 1) / steady_s
                             if steady_s > 0 else 0.0),
        "sample": [int(o.reshape(-1)[0]) for o in outs[:8]],
        "logits_finite": bool(torch.isfinite(logits).all()),
        "kernel_launches": launches,
        "weight_bytes": tree_weight_bytes(params),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
