"""Serving driver: batched prefill + greedy decode (static mode).

Twin of :mod:`repro.launch.serve` without ``--engine``: one batch of
synthetic prompts is prefilled in one forward, the KV cache grown to the
generation horizon, and ``--gen`` greedy tokens decoded step by step.  Runs
on CUDA unless ``--device cpu`` is given; with no GPU and no ``--device cpu``
it raises.  ``--quantize int8|fp8|codebook`` stores the packed values
quantized (it needs ``--sod``).  The continuous-batching engine, ``--plan``
(and so ``--quantize auto``) and ``--autotune`` are not ported yet.

``--sod block_csr`` keeps the reference CLI's magnitude pruning; a caller
that wants block pruning (as the reference's serving bench uses for this
format) passes its own ``SoDConfig`` to :func:`main`.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 4 --prompt-len 32 --gen 16 --sod tiled_csc --density 0.3 \\
      --quantize int8
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


def parse_args(argv=None) -> argparse.Namespace:
    """Command-line flags of the static serve."""
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
    args = ap.parse_args(argv)
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


def main(argv=None, sod: SoDConfig | None = None, prepared=None) -> dict:
    """CLI entry point: prints and returns a JSON summary of the run.

    ``sod`` replaces the storage config that ``--sod``/``--density``/
    ``--quantize`` build.  ``prepared`` is ``(model, params, tokens)`` from
    :func:`prepare` on the same flags, which the run then serves instead of
    building its own (a caller that keeps the weights packs them once).
    """
    args = parse_args(argv)
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
