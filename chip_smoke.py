#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it imports neither JAX nor the JAX package.
Phases, each of which raises on failure (so the script exits non-zero):

1. device — the card's name and power limit; TF32 off everywhere;
2. build  — compile every CUDA kernel of the path from ``src/repro_torch/
   kernels/csrc`` (nvcc, sm_90a);
3. kernels — each kernel against its plain PyTorch version at the serving
   path's shapes (and ragged ones), in bf16 and f32, plus timings: kernel,
   plain version, one ``torch.matmul`` on the dense weight (the yardstick),
   and the bound max(bytes / 3.35 TB/s, operations / peak rate);
4. slice  — ``repro_torch.launch.serve`` at the full width of llama3.2-1b
   (bf16, tiled_csc at density 0.3, batch 4, prompt 32, 16 greedy tokens),
   with the launch counts read around the run; then the prefill again with
   the packed weights densified through plain ``torch.matmul``, held
   against the kernel path's logits;
5. profile — one decode step under ``torch.profiler``: device time by kernel.

The last lines are the ``nvidia-smi`` name/power line, one JSON object with
the kernels' numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.formats import TiledCSC, pack_tiled_csc  # noqa: E402
from repro_torch.core.pruning import magnitude_prune  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import sod_matmul as sm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # tensor cores, bf16
                  torch.float32: 67e12}     # float32 outside the tensor cores
# Kernel vs plain version, as a fraction of the plain output's largest
# magnitude: float32 sums in another order (1e-4); bf16 may round the output
# one bf16 step (2**-8 relative) apart.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-7}
# Kernel path vs dense torch.matmul path, prefill logits at full width, as a
# fraction of the dense logits' largest magnitude: both round every
# projection's output and the residual stream to bf16, in different places
# of the f32 sums, through 16 layers.
LOGIT_TOL = 0.05

DENSITY = 0.3
LAYERS = 16
SERVE_ARGV = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "32",
              "--gen", "16", "--sod", "tiled_csc", "--density", str(DENSITY),
              "--seed", "0", "--device", "cuda"]
# (K, N) of the path's projections, and how many of each a layer has
PATH_SHAPES = {(2048, 2048): ("wq+wo", 2), (2048, 512): ("wk+wv", 2),
               (2048, 8192): ("w_gate+w_up", 2), (8192, 2048): ("w_down", 1)}
PATH_M = {"decode": 4, "prefill": 128}
RAGGED = [((300, 260), 77), ((2048, 512), 77), ((8192, 2048), 5)]
REPS = 25
FLUSH_BYTES = 512 << 20   # > 50 MB L2: every timed launch reads from HBM


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log({"phase": "device", "name": torch.cuda.get_device_name(0),
         "nvidia_smi": smi, "count": torch.cuda.device_count(),
         "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log({"phase": "build", "seconds": secs, "kernels": sorted(logs),
         "dir": str(build.build_dir())})


def _case(k: int, n: int, m: int, dtype, seed: int):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    w = magnitude_prune(torch.randn(k, n, generator=g, device="cuda").to(dtype),
                        DENSITY)
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    return x, pack_tiled_csc(w)


def _time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of one call, L2 flushed before each, CUDA events."""
    fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(x: torch.Tensor, p: TiledCSC, out_dtype) -> tuple[float, str]:
    """Least time for the same work: each input read once, the output written
    once, and 2 operations for each stored non-zero and row of x."""
    m, n = x.shape[0], p.shape[1]
    nbytes = (x.numel() * x.element_size() + p.vals.numel() * p.vals.element_size()
              + p.rows.numel() * p.rows.element_size()
              + m * n * torch.empty((), dtype=out_dtype).element_size())
    ops = 2 * m * int((p.rows >= 0).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[x.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels() -> dict:
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cases = [((k, n), m, tag) for (k, n) in PATH_SHAPES
             for tag, m in PATH_M.items()]
    cases += [(kn, m, "ragged") for kn, m in RAGGED]
    max_err = {}
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, ((k, n), m, tag) in enumerate(cases):
            x, p = _case(k, n, m, dtype, seed=i)
            y = sm.sod_matmul(x, p)
            yr = ref.sod_matmul_ref(x, p)
            torch.cuda.synchronize()
            err = (y.float() - yr.float()).abs().max().item()
            tol = KERNEL_TOL[dtype] * yr.float().abs().max().item()
            row = {"phase": "kernels", "kernel": "sod_matmul", "K": k, "N": n,
                   "M": m, "case": tag, "dtype": str(dtype).split(".")[-1],
                   "cap": p.cap, "max_abs_err": err, "tol": tol}
            if err > tol:
                log(row)
                raise AssertionError(f"sod_matmul disagrees with its plain "
                                     f"version: {err} > {tol} at {row}")
            max_err[dtype] = max(max_err.get(dtype, 0.0), err)
            if tag != "ragged" and dtype == torch.bfloat16:
                dense = p.to_dense()
                row["kernel_ms"] = _time_ms(lambda: sm.sod_matmul(x, p), flush)
                row["plain_ms"] = _time_ms(lambda: ref.sod_matmul_ref(x, p), flush)
                row["library_ms"] = _time_ms(lambda: torch.matmul(x, dense), flush)
                row["bound_ms"], row["bound_by"] = _bound(x, p, x.dtype)
                row["launches_per_forward"] = LAYERS * PATH_SHAPES[(k, n)][1]
                row["projections"] = PATH_SHAPES[(k, n)][0]
                timed[(k, n, tag)] = row
            log(row)
    return {"max_err": max_err, "timed": timed}


def _densify(tree):
    if isinstance(tree, dict):
        return {k: _densify(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_densify(v) for v in tree]
    return tree.to_dense() if isinstance(tree, TiledCSC) else tree


def phase_slice() -> dict:
    sm.launches = 0
    summary = serve.main(SERVE_ARGV)
    launches = sm.launches
    expect = LAYERS * 7 * (1 + 16)
    if launches != expect or summary["kernel_launches"]["sod_matmul"] != expect:
        raise AssertionError(f"sod_matmul launched {launches} times "
                             f"(summary {summary['kernel_launches']}), "
                             f"want {expect}")
    if not summary["logits_finite"]:
        raise AssertionError("non-finite logits from the full-width serve")
    wb = summary["weight_bytes"]
    if not wb["compressed"] < wb["dense"]:
        raise AssertionError(f"compressed bytes not below dense: {wb}")
    log({"phase": "slice", "launches": launches, "prefill_s": summary["prefill_s"],
         "warmup_s": summary["warmup_s"],
         "steady_tok_per_s": summary["steady_tok_per_s"],
         "sample": summary["sample"], "weight_bytes": wb})

    # the same weights again (same seed), prefill through the kernel and
    # through plain torch.matmul on the densified weights
    model, params, tokens = serve.prepare(serve.parse_args(SERVE_ARGV))
    with torch.inference_mode():
        lk, _ = model.prefill(params, tokens)
        ld, _ = model.prefill(_densify(params), tokens)
        vocab = model.cfg.vocab
        lk, ld = lk[:, :vocab].float(), ld[:, :vocab].float()
        err = (lk - ld).abs().max().item()
        scale = ld.abs().max().item()
        agree = (lk.argmax(-1) == ld.argmax(-1)).float().mean().item()
    caps = {f"{g}.{n}": w.cap for g in ("attn", "mlp")
            for n, w in params["layers"][0][g].items()}
    log({"phase": "slice_vs_dense", "max_abs_err": err, "max_abs_logit": scale,
         "tol": LOGIT_TOL * scale, "argmax_agreement": agree,
         "caps": caps})
    if not (torch.isfinite(lk).all() and err <= LOGIT_TOL * scale):
        raise AssertionError(f"kernel-path logits differ from the dense path: "
                             f"{err} > {LOGIT_TOL * scale}")
    return {"launches": launches, "model": model, "params": params,
            "tokens": tokens}


def phase_profile(model, params, tokens) -> None:
    """Device time by kernel over one steady decode step, and the device's
    idle share of an unprofiled step (the profiler slows the host down)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        _, cache, pos = serve.prefill_cache(model, params, tokens, 48)
        tok = torch.zeros((tokens.shape[0], 1), dtype=torch.long, device="cuda")
        model.decode_step(params, cache, tok, pos)
        step_ms = []
        for t in range(1, 8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_step(params, cache, tok, pos + t)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.decode_step(params, cache, tok, pos + 8)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel: dict[str, tuple[float, int]] = {}
    for ev in prof.events():      # device events only: operators would count twice
        if ev.device_type == DeviceType.CUDA:
            us, n = per_kernel.get(ev.name, (0.0, 0))
            per_kernel[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, k, n) for k, (us, n) in per_kernel.items()), reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    step = statistics.median(step_ms)
    log({"phase": "profile", "what": "one decode step, batch 4, full width",
         "step_ms_median_of_7": step, "profiled_wall_ms": wall_ms,
         "device_ms": total_ms if rows else "not measured",
         "device_idle_share": (1 - total_ms / step) if rows else "not measured",
         "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c}
                 for us, k, c in rows[:12]]})


def main() -> None:
    smi = phase_device()
    phase_build()
    kern = phase_kernels()
    sl = phase_slice()
    phase_profile(sl["model"], sl["params"], sl["tokens"])

    # the kernel's line: the seven projections of one layer at decode
    # (M = 4, bf16), summed from the per-shape medians above
    decode = [(row, PATH_SHAPES[(k, n)][1])
              for (k, n, tag), row in kern["timed"].items() if tag == "decode"]
    entry = {
        "name": "sod_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sod_matmul.cu",
        "replaces": "src/repro/kernels/sod_matmul.py:135",
        "launches": sl["launches"],
        "max_abs_err": max(kern["max_err"].values()),
        "ms": sum(r["kernel_ms"] * c for r, c in decode),
        **{key: sum(r[key] * c for r, c in decode)
           for key in ("plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r, _ in decode)
        else "operations",
        "work": "one layer's 7 projections at decode (M=4, bf16), summed",
    }
    log(smi)
    log({"kernels": [entry]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
