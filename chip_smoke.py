#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it imports neither JAX nor the JAX package.
Phases, each of which raises on failure (so the script exits non-zero):

1. device — the card's name and power limit; TF32 off everywhere;
2. build  — compile every CUDA kernel of the paths (``sod_matmul``,
   ``block_matmul``, ``decompress``) from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a), all at once;
3. kernels — each kernel against its plain PyTorch version at the serving
   paths' shapes (and ragged ones), in bf16 and f32 (``decompress`` bit for
   bit), plus timings: kernel, plain version, one ``torch.matmul`` on the
   dense weight (the yardstick of the two matmuls), and the bound
   max(bytes / 3.35 TB/s, operations / peak rate);
4. slice  — ``repro_torch.launch.serve`` at the full width of llama3.2-1b
   (bf16, batch 4, prompt 32, 16 greedy tokens) in two cells: ``tiled_csc``
   (magnitude-pruned to density 0.3) and ``block_csr`` (block-pruned to
   density 0.3), each with its kernel's launch count read around the run.
   Then each cell's prefill again, held against the same weights densified
   (through ``ops.decompress``) and run through plain ``torch.matmul``;
5. profile — one decode step of each cell under ``torch.profiler``: device
   time by kernel and the device's idle share; and the tied LM head's GEMM
   with f32 output against the same GEMM with bf16 output.

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

from repro_torch.core.formats import pack_block_csr, pack_tiled_csc  # noqa: E402
from repro_torch.core.pruning import block_prune, magnitude_prune  # noqa: E402
from repro_torch.core.sod import SoDConfig  # noqa: E402
from repro_torch.kernels import block_matmul as bmm  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decompress as dk  # noqa: E402
from repro_torch.kernels import sod_matmul as sm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # tensor cores, bf16
                  torch.float32: 67e12}     # float32 outside the tensor cores
# Kernel vs plain version, as a fraction of the plain output's largest
# magnitude: float32 sums in another order (1e-4); bf16 may round the output
# one bf16 step (2**-8 relative) apart.  decompress: bit-equal.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-7}
# Kernel path vs dense torch.matmul path, prefill logits at full width, as a
# fraction of the dense logits' largest magnitude: both round every
# projection's output and the residual stream to bf16, in different places
# of the f32 sums, through 16 layers.
LOGIT_TOL = 0.05

DENSITY = 0.3
LAYERS = 16
BASE_ARGV = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "32",
             "--gen", "16", "--seed", "0", "--device", "cuda"]
# the two cells: the CLI's tiled_csc (magnitude pruning), and block_csr with
# block pruning (as the JAX package's serving bench runs that format)
CELLS = {
    "tiled_csc": {"argv": BASE_ARGV + ["--sod", "tiled_csc", "--density",
                                       str(DENSITY)], "sod": None},
    "block_csr": {"argv": BASE_ARGV,
                  "sod": SoDConfig(mode="block_csr", density=DENSITY,
                                   prune_method="block", min_dim=64)},
}
KERNEL_OF_CELL = {"tiled_csc": "sod_matmul", "block_csr": "block_matmul"}
# (K, N) of the path's projections, and how many of each a layer has
PATH_SHAPES = {(2048, 2048): ("wq+wo", 2), (2048, 512): ("wk+wv", 2),
               (2048, 8192): ("w_gate+w_up", 2), (8192, 2048): ("w_down", 1)}
PATH_M = {"decode": 4, "prefill": 128}
RAGGED = [((300, 260), 77), ((2048, 512), 77), ((8192, 2048), 5)]
REPS = 25
FLUSH_BYTES = 512 << 20   # > 50 MB L2: every timed launch reads from HBM
COUNTERS = {"sod_matmul": sm, "block_matmul": bmm, "decompress": dk}
SOURCES = {"sod_matmul": ("src/repro_torch/kernels/csrc/sod_matmul.cu",
                          "src/repro/kernels/sod_matmul.py:135"),
           "block_matmul": ("src/repro_torch/kernels/csrc/block_matmul.cu",
                            "src/repro/kernels/block_matmul.py:99"),
           "decompress": ("src/repro_torch/kernels/csrc/decompress.cu",
                          "src/repro/kernels/decompress.py:39")}


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def reset_counts() -> None:
    for mod in COUNTERS.values():
        mod.launches = 0


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


def _weights(k: int, n: int, m: int, dtype, seed: int, block: bool):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    w = torch.randn(k, n, generator=g, device="cuda").to(dtype)
    w = block_prune(w, DENSITY) if block else magnitude_prune(w, DENSITY)
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    return x, w


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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bound(nbytes: int, n_ops: int, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _work(name: str, x: torch.Tensor, p) -> tuple[int, int]:
    """(bytes, operations) the function needs on these inputs: each input
    read once and the output written once; a matmul does 2 operations per
    stored value and row of x, counting only what is stored (the real slots
    of a TiledCSC, the tile_nnz sub-blocks of a BlockCSR, with their ids)."""
    k, n = p.shape
    if name == "decompress":   # every slot is read; the dense matrix written
        return _nbytes(p.vals) + _nbytes(p.rows) + k * n * p.vals.element_size(), 0
    m = x.shape[0]
    out = m * n * x.element_size()
    if name == "sod_matmul":
        return (_nbytes(x) + _nbytes(p.vals) + _nbytes(p.rows) + out,
                2 * m * int((p.rows >= 0).sum()))
    stored = int(p.tile_nnz.sum()) * p.br * p.tile[1]
    return (_nbytes(x) + stored * p.block_vals.element_size()
            + int(p.tile_nnz.sum()) * 4 + _nbytes(p.tile_nnz) + out, 2 * m * stored)


def _kernel_cases():
    """(kernel, K, N, M, case) of phase 3."""
    cases = []
    for name in ("sod_matmul", "block_matmul"):
        cases += [(name, k, n, m, tag) for (k, n) in PATH_SHAPES
                  for tag, m in PATH_M.items()]
        cases += [(name, k, n, m, "ragged") for (k, n), m in RAGGED]
    cases.append(("block_matmul", 8192, 2048, 4, "zero_tile_row"))
    cases += [("decompress", k, n, 1, "path") for (k, n) in PATH_SHAPES]
    cases.append(("decompress", 300, 260, 1, "ragged"))
    return cases


def _run_case(name, k, n, m, tag, dtype, seed):
    """(x, packed, kernel fn, plain fn) of one phase-3 case."""
    x, w = _weights(k, n, m, dtype, seed, block=name == "block_matmul")
    if tag == "zero_tile_row":      # a macro-tile row with tile_nnz == 0
        w[2048:2176] = 0
    if name == "block_matmul":
        p = pack_block_csr(w)
        return x, p, lambda: bmm.block_matmul(x, p), lambda: ref.block_matmul_ref(x, p)
    p = pack_tiled_csc(w)
    if name == "sod_matmul":
        return x, p, lambda: sm.sod_matmul(x, p), lambda: ref.sod_matmul_ref(x, p)
    return x, p, lambda: dk.decompress(p), lambda: ref.decompress_tiled_ref(p)


def phase_kernels() -> dict:
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    max_err: dict[str, float] = {}
    timed: dict[tuple, dict] = {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, k, n, m, tag) in enumerate(_kernel_cases()):
            x, p, kernel, plain = _run_case(name, k, n, m, tag, dtype, seed=i)
            y, yr = kernel(), plain()
            torch.cuda.synchronize()
            row = {"phase": "kernels", "kernel": name, "K": k, "N": n, "M": m,
                   "case": tag, "dtype": str(dtype).split(".")[-1]}
            if name == "decompress":
                ok = torch.equal(y, yr)
                row.update(cap=p.cap, bit_equal=ok)
                err = 0.0 if ok else (y.float() - yr.float()).abs().max().item()
            else:
                err = (y.float() - yr.float()).abs().max().item()
                tol = KERNEL_TOL[dtype] * yr.float().abs().max().item()
                ok = err <= tol
                row.update(max_abs_err=err, tol=tol)
                if name == "block_matmul":
                    row.update(bcap=p.bcap, stored_share=int(p.tile_nnz.sum())
                               / (p.tile_nnz.numel() * (p.tile[0] // p.br)),
                               empty_tiles=int((p.tile_nnz == 0).sum()))
                else:
                    row.update(cap=p.cap)
            if not ok:
                log(row)
                raise AssertionError(f"{name} disagrees with its plain version "
                                     f"at {row}")
            max_err[name] = max(max_err.get(name, 0.0), err)
            if tag in ("decode", "prefill", "path") and dtype == torch.bfloat16:
                row["kernel_ms"] = _time_ms(kernel, flush)
                row["plain_ms"] = _time_ms(plain, flush)
                if name == "decompress":
                    row["library_ms"] = None   # no one PyTorch call does this
                else:
                    dense = p.to_dense()
                    row["library_ms"] = _time_ms(lambda: torch.matmul(x, dense), flush)
                row["bound_ms"], row["bound_by"] = _bound(*_work(name, x, p), dtype)
                row["launches_per_forward"] = LAYERS * PATH_SHAPES[(k, n)][1]
                row["projections"] = PATH_SHAPES[(k, n)][0]
                timed[(name, k, n, tag)] = row
            log(row)
    return {"max_err": max_err, "timed": timed}


def _densify(tree):
    """The same tree with every packed leaf made dense through ops.decompress."""
    if isinstance(tree, dict):
        return {k: _densify(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_densify(v) for v in tree]
    return ops.decompress(tree)


def _projections(params):
    return {f"{g}.{n}": [layer[g][n] for layer in params["layers"]]
            for g in ("attn", "mlp") for n in params["layers"][0][g]}


def phase_slice(cell: str) -> dict:
    argv, sod = CELLS[cell]["argv"], CELLS[cell]["sod"]
    kernel = KERNEL_OF_CELL[cell]
    reset_counts()
    summary = serve.main(argv, sod=sod)
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    expect = {"sod_matmul": 0, "block_matmul": 0, "decompress": 0}
    expect[kernel] = LAYERS * 7 * (1 + 16)
    if launches != expect or summary["kernel_launches"] != {
            k: v for k, v in expect.items() if k != "decompress"}:
        raise AssertionError(f"{cell}: launches {launches} (summary "
                             f"{summary['kernel_launches']}), want {expect}")
    if not summary["logits_finite"]:
        raise AssertionError(f"{cell}: non-finite logits from the full-width serve")
    wb = summary["weight_bytes"]
    if not wb["compressed"] < wb["dense"]:
        raise AssertionError(f"{cell}: compressed bytes not below dense: {wb}")
    log({"phase": "slice", "cell": cell, "launches": launches,
         "prefill_s": summary["prefill_s"], "warmup_s": summary["warmup_s"],
         "steady_tok_per_s": summary["steady_tok_per_s"],
         "sample": summary["sample"], "weight_bytes": wb})

    # the same weights again (same seed), prefill through the kernel and
    # through plain torch.matmul on the weights densified by ops.decompress
    model, params, tokens = serve.prepare(serve.parse_args(argv), sod)
    with torch.inference_mode():
        lk, _ = model.prefill(params, tokens)
        dk.launches = 0
        dense = _densify(params)
        decompress_launches = dk.launches
        ld, _ = model.prefill(dense, tokens)
        del dense
        vocab = model.cfg.vocab
        lk, ld = lk[:, :vocab].float(), ld[:, :vocab].float()
        err = (lk - ld).abs().max().item()
        scale = ld.abs().max().item()
        agree = (lk.argmax(-1) == ld.argmax(-1)).float().mean().item()
    want_decompress = LAYERS * 7 if cell == "tiled_csc" else 0
    if decompress_launches != want_decompress:
        raise AssertionError(f"{cell}: densifying launched decompress "
                             f"{decompress_launches} times, want {want_decompress}")
    row = {"phase": "slice_vs_dense", "cell": cell, "max_abs_err": err,
           "max_abs_logit": scale, "tol": LOGIT_TOL * scale,
           "argmax_agreement": agree, "decompress_launches": decompress_launches}
    proj = _projections(params)
    if cell == "tiled_csc":
        row["caps"] = {name: ws[0].cap for name, ws in proj.items()}
    else:
        row["bcaps"] = {name: ws[0].bcap for name, ws in proj.items()}
        row["stored_share"] = {
            name: sum(int(w.tile_nnz.sum()) for w in ws)
            / sum(w.tile_nnz.numel() * (w.tile[0] // w.br) for w in ws)
            for name, ws in proj.items()}
        packed = [w for ws in proj.values() for w in ws]
        row["projection_bytes"] = sum(w.nbytes_compressed() for w in packed)
        row["projection_bytes_dense"] = sum(w.nbytes_dense() for w in packed)
        row["projection_bytes_stored_blocks"] = sum(
            int(w.tile_nnz.sum()) * w.br * w.tile[1] * 2 for w in packed)
    log(row)
    if not (torch.isfinite(lk).all() and err <= LOGIT_TOL * scale):
        raise AssertionError(f"{cell}: kernel-path logits differ from the dense "
                             f"path: {err} > {LOGIT_TOL * scale}")
    return {"launches": launches[kernel], "decompress_launches": decompress_launches,
            "model": model, "params": params, "tokens": tokens}


def phase_profile(cell: str, model, params, tokens) -> None:
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
    log({"phase": "profile", "cell": cell,
         "what": "one decode step, batch 4, full width",
         "step_ms_median_of_7": step, "profiled_wall_ms": wall_ms,
         "device_ms": total_ms if rows else "not measured",
         "device_idle_share": (1 - total_ms / step) if rows else "not measured",
         "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c}
                 for us, k, c in rows[:12]]})


def phase_head(params, batch: int) -> None:
    """The tied LM head's GEMM at decode: f32 output (what project_logits
    runs) against bf16 output widened after (what it ran before)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    embed = params["embed"]
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    x = torch.randn(batch, embed.shape[1], generator=g, device="cuda").to(embed.dtype)
    f32_out = _time_ms(lambda: torch.mm(x, embed.T, out_dtype=torch.float32), flush)
    bf16_out = _time_ms(lambda: torch.mm(x, embed.T).float(), flush)
    log({"phase": "head", "M": batch, "K": embed.shape[1], "N": embed.shape[0],
         "f32_out_ms": f32_out, "bf16_out_then_widen_ms": bf16_out,
         "bound_ms": _bound(_nbytes(embed), 2 * batch * embed.numel(),
                            embed.dtype)[0]})


def _entry(name: str, kern: dict, launches: int) -> dict:
    """One kernel's line: the seven projections of one layer (M = 4 at
    decode for the matmuls), bf16, summed from the per-shape medians."""
    tag = "path" if name == "decompress" else "decode"
    rows = [(row, PATH_SHAPES[(k, n)][1])
            for (kn, k, n, t), row in kern["timed"].items() if kn == name and t == tag]
    total = {key: sum(r[key] * c for r, c in rows)
             for key in ("kernel_ms", "plain_ms", "bound_ms")}
    lib = (None if name == "decompress"
           else sum(r["library_ms"] * c for r, c in rows))
    source, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": kern["max_err"][name],
        "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r, _ in rows)
        else "operations",
        "library_ms": lib,
        "work": ("one layer's 7 projections densified (bf16), summed"
                 if name == "decompress" else
                 "one layer's 7 projections at decode (M=4, bf16), summed"),
    }


def main() -> None:
    smi = phase_device()
    phase_build()
    kern = phase_kernels()
    cells = {cell: phase_slice(cell) for cell in CELLS}
    for cell, sl in cells.items():
        phase_profile(cell, sl["model"], sl["params"], sl["tokens"])
    phase_head(cells["tiled_csc"]["params"], batch=4)

    entries = [_entry("sod_matmul", kern, cells["tiled_csc"]["launches"]),
               _entry("block_matmul", kern, cells["block_csr"]["launches"]),
               _entry("decompress", kern, cells["tiled_csc"]["decompress_launches"])]
    log(smi)
    log({"kernels": entries})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
