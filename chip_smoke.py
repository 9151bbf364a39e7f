#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it imports neither JAX nor the JAX package.
Phases, each of which raises on failure (so the script exits non-zero):

1. device — the card's name and power limit; TF32 off everywhere;
2. build  — compile every CUDA kernel of the paths (``sod_matmul``,
   ``block_matmul``, ``decompress``) from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a), all at once, and report ptxas registers and spills;
3. kernels — each kernel in each qmode (``none``, ``int8``, ``fp8``,
   ``codebook``) against its plain PyTorch version at the serving paths'
   shapes (and ragged ones), in bf16 and f32 (``decompress`` bit for bit;
   ``sod_matmul`` and ``block_matmul`` run twice, bit-equal across the
   calls, with their launch plans: splits, ring stages, shared memory),
   plus timings: kernel, plain version, one ``torch.matmul`` on the dense
   bf16 weight (the yardstick of the two matmuls; for ``decompress`` in
   qmode ``none``, one ``index_put_`` of the stored values at precomputed
   absolute indices into a zeroed matrix), and the bound max(bytes
   / 3.35 TB/s, operations / peak rate).  Each timed call starts with a
   clean L2: a 512 MB buffer is read, not written, so no dirty line of the
   flush drains inside the timed call; a spin kernel then keeps the card
   busy while the host enqueues the call, so no host time is timed;
4. slice  — ``repro_torch.launch.serve`` at the full width of llama3.2-1b
   (bf16, batch 4, prompt 32, 16 greedy tokens) in five cells: ``tiled_csc``
   and ``tiled_csc_int8`` (magnitude-pruned to density 0.3; the second is
   this slice's main path, ``--quantize int8``), ``block_csr`` and
   ``block_csr_fp8`` (block-pruned to density 0.3), and
   ``tiled_csc_codebook`` at 2 layers (the codebook is fitted on the host,
   see CODEBOOK_LAYERS).  Each cell's weights are prepared once, served
   through ``serve.main`` with its kernel's launch count read around the
   run, then its prefill is held against the same weights densified
   (through ``ops.decompress``) and run through the dense matmul;
5. profile — one decode step of four cells under ``torch.profiler``: device
   time by kernel, the device's idle share, and the calls of a separate
   split-K reduce kernel (none in any cell: both matmul kernels reduce
   their splits inside their launch); and the tied LM head's GEMM with
   f32 output against the same GEMM with bf16 output;
6. engine — ``serve.py --engine`` (the continuous-batching engine) at full
   width, bf16, on the weights phase 4 packed, over ``poisson_trace(8, 0.5,
   max_prompt=64, max_new=16)`` (prompts of 32-64 tokens), 4 slots, 16-token
   pages, in three runs: ``tiled_csc`` with the prompt prefilled at
   admission in one forward, ``tiled_csc`` with 16-token chunks, and
   ``block_csr`` fused.  Each run must complete every request, emit for
   every request the tokens of the port's ``static_generate`` on the card
   bit for bit, launch its cell's kernel (and not the other), and keep its
   logits finite; it prints throughput, warmup, latency, wall ms a step and
   the launch plans' K splits at the prefill shapes.  One steady engine
   step of the first run is profiled for its device time and idle share.
   Four more runs drive the engine's other stages, each on the same packed
   weights with 16-token pages, 4 slots and ``max_len`` 80 (FEATURE_RUNS):
   ``tiled_csc_stress`` (preemption with page swapping and prefix sharing on
   a shared-prefix trace and a pool of 8 pages), ``tiled_csc_spec2``
   (``serve --engine --spec-decode 2 --draft-sparsity 0.88``: a draft of the
   same raw weights at density 0.12), ``block_csr_stress_spec`` (every
   feature at once, a block-pruned ``block_csr`` draft at 0.12, a starved
   pool) and ``tiled_csc_cache`` (two identical epochs of a repeated prompt
   through the prefix cache: a 3-page budget and a disk directory).  Each
   holds every request's tokens against ``static_generate`` bit for bit,
   its kernel launched (both tiers counted apart) and the other not, finite
   logits, a clean pool afterwards and its features' counters (preemptions
   of the youngest decoding sequence, swap-ins, shared pages, spec windows,
   rollbacks, no fresh prompt page in epoch 2, disk demotions, the cache-off
   run's tokens).  Last, one spec window (3 draft decode steps and the
   verify) is profiled beside 3 plain decode steps.

Each phase prints its seconds.  The last lines are the ``nvidia-smi``
name/power line, one JSON object with the kernels' numbers (one entry per
kernel and qmode), and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import re
import statistics
import subprocess
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.formats import (pack_block_csr, pack_tiled_csc,  # noqa: E402
                                      quantize_packed)
from repro_torch.core.pruning import block_prune, magnitude_prune  # noqa: E402
from repro_torch.core.sod import SoDConfig  # noqa: E402
from repro_torch.kernels import block_matmul as bmm  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decompress as dk  # noqa: E402
from repro_torch.kernels import sod_matmul as sm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.serving import (Engine, bucket_len, poisson_trace,  # noqa: E402
                                 repeated_prompt_trace, shared_prefix_trace,
                                 static_generate, stress_spec_trace)

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
# The codebook cell's depth: its shared-value tables are fitted on the host
# with numpy (Lloyd k-means, as the reference), about 40 s a full-width layer
# on one CPU core, so the cell runs at full width but 2 layers.
CODEBOOK_LAYERS = 2
QMODES = ("int8", "fp8", "codebook")
BASE_ARGV = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "32",
             "--gen", "16", "--seed", "0", "--device", "cuda"]
TILED_ARGV = BASE_ARGV + ["--sod", "tiled_csc", "--density", str(DENSITY)]


def _block_sod(qmode: str = "none") -> SoDConfig:
    """block_csr with block pruning, as the JAX package's serving bench runs
    that format (the CLI's --sod block_csr keeps magnitude pruning)."""
    return SoDConfig(mode="block_csr", density=DENSITY, prune_method="block",
                     min_dim=64, qmode=qmode)


# name -> argv, caller's SoDConfig, kernel, qmode, layers
CELLS = {
    "tiled_csc": (TILED_ARGV, None, "sod_matmul", "none", LAYERS),
    "block_csr": (BASE_ARGV, _block_sod(), "block_matmul", "none", LAYERS),
    "tiled_csc_int8": (TILED_ARGV + ["--quantize", "int8"], None, "sod_matmul",
                       "int8", LAYERS),
    "block_csr_fp8": (BASE_ARGV, _block_sod("fp8"), "block_matmul", "fp8", LAYERS),
    "tiled_csc_codebook": (TILED_ARGV + ["--quantize", "codebook"], None,
                           "sod_matmul", "codebook", CODEBOOK_LAYERS),
}
UNQUANTIZED = {"sod_matmul": "tiled_csc", "block_matmul": "block_csr"}
PROFILED = ("tiled_csc", "block_csr", "tiled_csc_int8", "block_csr_fp8")
# (K, N) of the path's projections, and how many of each a layer has
PATH_SHAPES = {(2048, 2048): ("wq+wo", 2), (2048, 512): ("wk+wv", 2),
               (2048, 8192): ("w_gate+w_up", 2), (8192, 2048): ("w_down", 1)}
PATH_M = {"decode": 4, "prefill": 128}
RAGGED = [((300, 260), 77), ((2048, 512), 77), ((8192, 2048), 5)]
REPS = 25
FLUSH_BYTES = 512 << 20   # > 50 MB L2: every timed launch reads from HBM
SPIN_HZ = 2e9             # spin cycles a second: at least the H100's top SM clock
PLANS = {"sod_matmul": sm.plan_of, "block_matmul": bmm.plan_of}
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
        log({"phase": "ptxas", "kernel": name, "functions": _ptxas(text)})
    log({"phase": "build", "seconds": secs, "kernels": sorted(logs),
         "dir": str(build.build_dir())})


def _ptxas(text: str) -> list[dict]:
    """Registers and spill bytes of each compiled function, from nvcc's
    ``-Xptxas -v`` report (mangled names)."""
    out, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = {"fn": m.group(1)}
            out.append(fn)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn is not None:
            fn["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["regs"] = int(m.group(1))
    return out


def _weights(k: int, n: int, m: int, dtype, seed: int, block: bool):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    w = torch.randn(k, n, generator=g, device="cuda").to(dtype)
    w = block_prune(w, DENSITY) if block else magnitude_prune(w, DENSITY)
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    return x, w


def _flush_buffer() -> torch.Tensor:
    return torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device="cuda")


def _time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of one call, CUDA events.  Before each, L2 is
    left clean: reading the flush buffer (a reduction, which writes one
    scalar) evicts every line, and dirty ones are written back there, not
    inside the timed call.  A spin kernel after it keeps the card busy
    while the host enqueues the call (at least 1 ms, and 4x the host time
    of one call), so the events hold the call's device time and no host
    time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    cycles = int(SPIN_HZ * max(1e-3, 4 * host_s))
    times = []
    for _ in range(REPS):
        flush.sum()
        torch.cuda._sleep(cycles)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _bound(nbytes: int, n_ops: int, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _work(name: str, x: torch.Tensor, p, y: torch.Tensor) -> tuple[int, int]:
    """(bytes, operations) the function needs on these inputs: each input
    read once (the quantization side band included) and the output ``y``
    written once; a matmul does 2 operations per stored value and row of x,
    counting only what is stored (the real slots of a TiledCSC, the
    tile_nnz sub-blocks of a BlockCSR, with their ids)."""
    side = _nbytes(p.scale) + _nbytes(p.codebook)
    if name == "decompress":   # every slot is read; the dense matrix written
        return _nbytes(p.vals) + _nbytes(p.rows) + side + _nbytes(y), 0
    m = x.shape[0]
    if name == "sod_matmul":
        return (_nbytes(x) + _nbytes(p.vals) + _nbytes(p.rows) + side + _nbytes(y),
                2 * m * int((p.rows >= 0).sum()))
    stored = int(p.tile_nnz.sum()) * p.br * p.tile[1]
    return (_nbytes(x) + stored * p.block_vals.element_size()
            + int(p.tile_nnz.sum()) * 4 + _nbytes(p.tile_nnz) + side + _nbytes(y),
            2 * m * stored)


def _scatter_args(p) -> tuple:
    """((rows, cols), vals) of a TiledCSC's real slots at their absolute
    positions: the arguments of one ``index_put_`` that densifies it."""
    kt, nt, cap, bn = p.vals.shape
    bk = p.tile[0]
    r = p.rows.long()
    real = r >= 0
    rows = r + bk * torch.arange(kt, device=r.device).view(kt, 1, 1, 1)
    cols = (bn * torch.arange(nt, device=r.device).view(1, nt, 1, 1)
            + torch.arange(bn, device=r.device).view(1, 1, 1, bn)).expand_as(r)
    return (rows[real], cols[real]), p.vals[real]


def _kernel_cases():
    """(kernel, qmode, K, N, M, case, dtype) of phase 3: qmode none in bf16
    and f32 as before; each quantized qmode at the path shapes in bf16 and
    one ragged case in f32."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for name in ("sod_matmul", "block_matmul"):
            cases += [(name, "none", k, n, m, tag, dtype) for (k, n) in PATH_SHAPES
                      for tag, m in PATH_M.items()]
            cases += [(name, "none", k, n, m, "ragged", dtype) for (k, n), m in RAGGED]
        cases.append(("block_matmul", "none", 8192, 2048, 4, "zero_tile_row", dtype))
        cases += [("decompress", "none", k, n, 1, "path", dtype) for (k, n) in PATH_SHAPES]
        cases.append(("decompress", "none", 300, 260, 1, "ragged", dtype))
    for q in QMODES:
        for name in ("sod_matmul", "block_matmul"):
            cases += [(name, q, k, n, m, tag, torch.bfloat16) for (k, n) in PATH_SHAPES
                      for tag, m in PATH_M.items()]
            cases.append((name, q, 300, 260, 77, "ragged", torch.float32))
        cases += [("decompress", q, k, n, 1, "path", torch.bfloat16) for (k, n) in PATH_SHAPES]
    return cases


def _quantized_packs(cases) -> dict:
    """One quantized operand per (format, K, N, qmode) of the phase-3 cases,
    made from a bf16 weight and reused across M and the activations' dtype.
    The codebook fits run on the host in numpy, so they run in threads."""
    shapes = {("block" if name == "block_matmul" else "tiled", k, n)
              for name, q, k, n, *_ in cases if q != "none"}
    base = {}
    for i, (fmt, k, n) in enumerate(sorted(shapes)):
        _, w = _weights(k, n, 1, torch.bfloat16, 1000 + i, block=fmt == "block")
        base[(fmt, k, n)] = pack_block_csr(w) if fmt == "block" else pack_tiled_csc(w)
    torch.cuda.synchronize()
    jobs = [(key, q) for key in sorted(base) for q in QMODES]
    with ThreadPoolExecutor(max_workers=8) as pool:
        packs = pool.map(lambda job: quantize_packed(base[job[0]], job[1]), jobs)
        return {(*key, q): p for (key, q), p in zip(jobs, packs)}


def _run_case(name, qmode, k, n, m, tag, dtype, seed, qpacks):
    """(x, packed, kernel fn, plain fn) of one phase-3 case."""
    block = name == "block_matmul"
    if qmode == "none":
        x, w = _weights(k, n, m, dtype, seed, block)
        if tag == "zero_tile_row":      # a macro-tile row with tile_nnz == 0
            w[2048:2176] = 0
        p = pack_block_csr(w) if block else pack_tiled_csc(w)
    else:
        p = qpacks[("block" if block else "tiled", k, n, qmode)]
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    if name == "block_matmul":
        return x, p, lambda: bmm.block_matmul(x, p), lambda: ref.block_matmul_ref(x, p)
    if name == "sod_matmul":
        return x, p, lambda: sm.sod_matmul(x, p), lambda: ref.sod_matmul_ref(x, p)
    return x, p, lambda: dk.decompress(p), lambda: ref.decompress_tiled_ref(p)


def phase_kernels() -> dict:
    flush = _flush_buffer()
    cases = _kernel_cases()
    t0 = time.perf_counter()
    qpacks = _quantized_packs(cases)
    log({"phase": "kernels", "quantized_packs_s": time.perf_counter() - t0,
         "packs": len(qpacks)})
    max_err: dict[tuple, float] = {}
    launches: dict[tuple, int] = {}
    timed: dict[tuple, dict] = {}
    for i, (name, qmode, k, n, m, tag, dtype) in enumerate(cases):
        x, p, kernel, plain = _run_case(name, qmode, k, n, m, tag, dtype, i, qpacks)
        reset_counts()
        y, yr = kernel(), plain()
        torch.cuda.synchronize()
        row = {"phase": "kernels", "kernel": name, "qmode": qmode, "K": k, "N": n,
               "M": m, "case": tag, "dtype": str(dtype).split(".")[-1]}
        if name == "decompress":
            ok = torch.equal(y, yr) and y.dtype == yr.dtype
            row.update(cap=p.cap, out_dtype=str(y.dtype).split(".")[-1], bit_equal=ok)
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
            y2 = kernel()               # a second call: bit-equal, however it splits
            torch.cuda.synchronize()
            plan = PLANS[name](x, p)
            row.update(bm=plan.bm, m_groups=plan.m_groups, splits=plan.splits,
                       stages=plan.stages,
                       x_tiles=plan.x_tiles, smem_bytes=plan.smem_bytes,
                       ctas_per_sm=plan.ctas_per_sm,
                       bit_equal_across_calls=torch.equal(y, y2))
            ok = ok and row["bit_equal_across_calls"]
        if not ok:
            log(row)
            raise AssertionError(f"{name}[{qmode}] disagrees with its plain "
                                 f"version at {row}")
        key = (name, qmode)
        max_err[key] = max(max_err.get(key, 0.0), err)
        if tag in ("decode", "prefill", "path") and dtype == torch.bfloat16:
            row["kernel_ms"] = _time_ms(kernel, flush)
            row["plain_ms"] = _time_ms(plain, flush)
            if name == "decompress" and qmode == "none":
                # one scatter of the stored values at precomputed absolute
                # indices into a zeroed dense matrix
                scatter = _scatter_args(p)
                row["library_ms"] = _time_ms(lambda: torch.zeros(
                    p.shape, dtype=p.vals.dtype, device="cuda").index_put_(*scatter),
                    flush)
            elif name == "decompress":
                row["library_ms"] = None   # dequantizing is a second call
            else:
                dense = p.to_dense().to(x.dtype)
                row["library_ms"] = _time_ms(lambda: torch.matmul(x, dense), flush)
            row["bound_ms"], row["bound_by"] = _bound(*_work(name, x, p, y), dtype)
            row["launches_per_forward"] = LAYERS * PATH_SHAPES[(k, n)][1]
            row["projections"] = PATH_SHAPES[(k, n)][0]
            timed[(name, qmode, k, n, tag)] = row
        launches[key] = launches.get(key, 0) + COUNTERS[name].launches
        log(row)
    return {"max_err": max_err, "timed": timed, "launches": launches}


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
    """Prepare the cell's weights once, serve them through ``serve.main``
    with every launch count read around the run, then hold the prefill
    against the same weights densified."""
    argv, sod, kernel, qmode, layers = CELLS[cell]
    args = serve.parse_args(argv)
    cfg = (None if layers == LAYERS
           else configs.get_config(args.arch).with_(n_layers=layers))
    t0 = time.perf_counter()
    model, params, tokens = serve.prepare(args, sod, cfg)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    reset_counts()
    summary = serve.main(argv, sod=sod, prepared=(model, params, tokens))
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    expect = {"sod_matmul": 0, "block_matmul": 0, "decompress": 0}
    expect[kernel] = layers * 7 * (1 + 16)
    if launches != expect or summary["kernel_launches"] != {
            k: v for k, v in expect.items() if k != "decompress"}:
        raise AssertionError(f"{cell}: launches {launches} (summary "
                             f"{summary['kernel_launches']}), want {expect}")
    if not summary["logits_finite"]:
        raise AssertionError(f"{cell}: non-finite logits from the full-width serve")
    wb = summary["weight_bytes"]
    if not wb["compressed"] < wb["dense"]:
        raise AssertionError(f"{cell}: compressed bytes not below dense: {wb}")
    proj = _projections(params)
    packed = [w for ws in proj.values() for w in ws]
    if {w.qmode for w in packed} != {qmode}:
        raise AssertionError(f"{cell}: packed qmodes {({w.qmode for w in packed})}, "
                             f"want {qmode}")
    log({"phase": "slice", "cell": cell, "qmode": qmode, "layers": layers,
         "pack_s": pack_s, "launches": launches,
         "prefill_s": summary["prefill_s"], "warmup_s": summary["warmup_s"],
         "steady_tok_per_s": summary["steady_tok_per_s"],
         "sample": summary["sample"], "weight_bytes": wb})

    # the same weights, prefill through the kernel and through the dense
    # matmul on the weights densified by ops.decompress
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
    want_decompress = layers * 7 if kernel == "sod_matmul" else 0
    if decompress_launches != want_decompress:
        raise AssertionError(f"{cell}: densifying launched decompress "
                             f"{decompress_launches} times, want {want_decompress}")
    row = {"phase": "slice_vs_dense", "cell": cell, "max_abs_err": err,
           "max_abs_logit": scale, "tol": LOGIT_TOL * scale,
           "argmax_agreement": agree, "decompress_launches": decompress_launches,
           "projection_bytes": sum(w.nbytes_compressed() for w in packed),
           "projection_bytes_dense": sum(w.nbytes_dense() for w in packed)}
    if kernel == "sod_matmul":
        row["caps"] = {name: ws[0].cap for name, ws in proj.items()}
    else:
        row["bcaps"] = {name: ws[0].bcap for name, ws in proj.items()}
        row["stored_share"] = {
            name: sum(int(w.tile_nnz.sum()) for w in ws)
            / sum(w.tile_nnz.numel() * (w.tile[0] // w.br) for w in ws)
            for name, ws in proj.items()}
        row["projection_bytes_stored_blocks"] = sum(
            int(w.tile_nnz.sum()) * w.br * w.tile[1] * w.block_vals.element_size()
            for w in packed)
    log(row)
    if not (torch.isfinite(lk).all() and err <= LOGIT_TOL * scale):
        raise AssertionError(f"{cell}: kernel-path logits differ from the dense "
                             f"path: {err} > {LOGIT_TOL * scale}")
    return {"launches": launches[kernel], "decompress_launches": decompress_launches,
            "weight_bytes": wb, "layer_bytes": row["projection_bytes"] / layers,
            "model": model, "params": params, "tokens": tokens}


def check_quantized_bytes(cells: dict) -> None:
    """Each quantized cell stores fewer bytes than its format's unquantized
    cell: in all (same depth) and per layer of projections."""
    for cell, (_, _, kernel, qmode, layers) in CELLS.items():
        if qmode == "none":
            continue
        base = cells[UNQUANTIZED[kernel]]
        per_layer = cells[cell]["layer_bytes"] < base["layer_bytes"]
        total = (layers != LAYERS or cells[cell]["weight_bytes"]["compressed"]
                 < base["weight_bytes"]["compressed"])
        if not (per_layer and total):
            raise AssertionError(f"{cell}: quantized bytes not below "
                                 f"{UNQUANTIZED[kernel]}'s")


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
    reduce_calls = sum(n for k, (_, n) in per_kernel.items() if "reduce_splits_kernel" in k)
    log({"phase": "profile", "cell": cell,
         "what": "one decode step, batch 4, full width",
         "step_ms_median_of_7": step, "profiled_wall_ms": wall_ms,
         "device_ms": total_ms if rows else "not measured",
         "device_idle_share": (1 - total_ms / step) if rows else "not measured",
         "reduce_splits_calls": reduce_calls,
         "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c}
                 for us, k, c in rows[:12]]})
    if reduce_calls:
        raise AssertionError(f"{cell}: {reduce_calls} reduce_splits_kernel calls in a "
                             "decode step; the matmul kernels reduce their splits in "
                             "their launch")


def phase_head(params, batch: int) -> None:
    """The tied LM head's GEMM at decode: f32 output (what project_logits
    runs) against bf16 output widened after (what it ran before)."""
    flush = _flush_buffer()
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


ENGINE_ARGV = ["--arch", "llama3.2-1b", "--engine", "--requests", "8",
               "--arrival-rate", "0.5", "--prompt-len", "64", "--gen", "16",
               "--max-slots", "4", "--page-size", "16", "--seed", "0",
               "--device", "cuda"]
# run -> (phase-4 cell whose packed weights it serves, prefill chunk)
ENGINE_RUNS = {"tiled_csc": ("tiled_csc", None),
               "tiled_csc_chunk16": ("tiled_csc", 16),
               "block_csr": ("block_csr", None)}


def _prefill_splits(kernel: str, params, ms) -> dict:
    """The K splits of the kernel's launch plan at each projection shape of
    a layer and each row count in ``ms``."""
    out = {}
    for g in ("attn", "mlp"):
        for name, w in params["layers"][0][g].items():
            x = torch.empty((1, w.shape[0]), dtype=torch.bfloat16, device="cuda")
            out[f"{g}.{name}"] = {
                m: PLANS[kernel](x.expand(m, -1), w).splits for m in ms}
    return out


def phase_engine(run: str, cells: dict) -> dict:
    """One engine run through ``serve.main --engine`` on a phase-4 cell's
    packed weights, held against ``static_generate`` request by request."""
    cell, chunk = ENGINE_RUNS[run]
    kernel = CELLS[cell][2]
    argv = ENGINE_ARGV + (["--prefill-chunk", str(chunk)] if chunk else [])
    sl = cells[cell]
    reset_counts()
    summary = serve.main(argv, prepared=(sl["model"], sl["params"], sl["tokens"]))
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    trace, tokens = summary["trace"], summary["tokens"]
    other = "block_matmul" if kernel == "sod_matmul" else "sod_matmul"
    if not (launches[kernel] > 0 and launches[other] == 0
            and launches["decompress"] == 0
            and summary["kernel_launches"] == {kernel: launches[kernel], other: 0}):
        raise AssertionError(f"engine {run}: launches {launches} (summary "
                             f"{summary['kernel_launches']})")
    if summary["completed"] != len(trace) or set(tokens) != {r.rid for r in trace}:
        raise AssertionError(f"engine {run}: {summary['completed']} of "
                             f"{len(trace)} requests completed")
    if not summary["logits_finite"]:
        raise AssertionError(f"engine {run}: non-finite logits")
    t0 = time.perf_counter()
    with torch.inference_mode():
        for req in trace:
            want = static_generate(sl["model"], sl["params"], req)
            if tokens[req.rid] != want:
                first = next(i for i, (a, b) in enumerate(zip(tokens[req.rid], want))
                             if a != b)
                raise AssertionError(
                    f"engine {run}: request {req.rid} (prompt {len(req.tokens)}) "
                    f"differs from static_generate at token {first}: "
                    f"{tokens[req.rid]} vs {want}")
    static_s = time.perf_counter() - t0
    buckets = sorted({bucket_len(len(r.tokens), 16) for r in trace})
    ms = sorted({1, 4, *([chunk] if chunk else buckets)})
    row = {"phase": "engine", "run": run, "cell": cell, "prefill_chunk": chunk,
           "launches": launches[kernel],
           "bit_equal_to_static_generate": True, "static_generate_s": static_s,
           "prompt_lens": [len(r.tokens) for r in trace],
           "splits": _prefill_splits(kernel, sl["params"], ms),
           **{k: summary[k] for k in (
               "completed", "steps", "generated_tokens", "prefill_chunks",
               "warmup_s", "steady_s", "steady_tok_per_s", "p50_latency_s",
               "p99_latency_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
               "tpot_p99_s", "step_ms_p50", "step_ms_p99", "logits_finite")}}
    log(row)
    return row


def phase_engine_profile(cells: dict) -> None:
    """Device time and idle share of one steady engine step (tiled_csc,
    fused prefill): the trace runs until every slot decodes, then one step
    is profiled and the next eight are timed unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sl = cells["tiled_csc"]
    args = serve.parse_args(ENGINE_ARGV)
    max_len = bucket_len(args.prompt_len, args.page_size,
                         sl["model"].cfg.attn_chunk) + args.gen
    eng = Engine(sl["model"], sl["params"], max_slots=4, page_size=16,
                 max_len=max_len)
    for r in poisson_trace(8, 0.5, max_prompt=64, max_new=16,
                           vocab=sl["model"].cfg.vocab, seed=0):
        # all admissible at once: 4 slots decode
        eng.submit(dataclasses.replace(r, arrival=0))
    with torch.inference_mode():
        eng.warmup()
        eng.step()                   # admits 4, each with its fused prefill
        eng.step()
        step_ms = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
    dev_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
    step = statistics.median(step_ms)
    log({"phase": "engine_profile", "cell": "tiled_csc",
         "what": "one engine step, 4 slots decoding, full width",
         "step_ms_median_of_8": step,
         "device_ms": dev_us / 1e3 if dev_us else "not measured",
         "device_idle_share": (1 - dev_us / 1e3 / step) if dev_us else "not measured"})


# run -> (phase-4 cell whose packed weights are the target, the engine's
# features, its pool's pages (None: room for every slot))
FEATURE_RUNS = {
    "tiled_csc_stress": ("tiled_csc", dict(prefill_chunk=16, preemption=True,
                                           prefix_sharing=True), 8),
    "tiled_csc_spec2": ("tiled_csc", dict(spec_k=2), None),
    "block_csr_stress_spec": ("block_csr", dict(prefill_chunk=16, preemption=True,
                                                prefix_sharing=True, spec_k=2), 11),
    "tiled_csc_cache": ("tiled_csc", dict(prefill_chunk=16, prefix_sharing=True),
                        None),
}
DRAFT_SPARSITY = 0.88         # the draft tier keeps 0.12 of the raw weights
SPEC_ARGV = ENGINE_ARGV + ["--spec-decode", "2", "--draft-sparsity", str(DRAFT_SPARSITY)]
CACHE_BUDGET_PAGES = 3
STEP_BUILDERS = ("make_paged_decode_step", "make_prefill_full",
                 "make_chunked_prefill_step", "make_verify_step")


def _matmul_launches() -> int:
    return sm.launches + bmm.launches


@contextlib.contextmanager
def _engine_probe(target_params):
    """While open, every engine built counts the matmul launches of its steps
    by tier (the target's weights or any other: the draft's), and the
    engines ``serve.main`` builds are kept."""
    seen = {"target": 0, "draft": 0, "engines": []}
    builders = {name: getattr(steps_mod, name) for name in STEP_BUILDERS}
    serve_engine = serve.Engine

    def counted(build):
        def make(model):
            step = build(model)

            def run(params, *a, **kw):
                n0 = _matmul_launches()
                out = step(params, *a, **kw)
                tier = "target" if params is target_params else "draft"
                seen[tier] += _matmul_launches() - n0
                return out
            return run
        return make

    def keep(*a, **kw):
        eng = serve_engine(*a, **kw)
        seen["engines"].append(eng)
        return eng

    for name, build in builders.items():
        setattr(steps_mod, name, counted(build))
    serve.Engine = keep
    try:
        yield seen
    finally:
        for name, build in builders.items():
            setattr(steps_mod, name, build)
        serve.Engine = serve_engine


def _youngest_first(eng, log: list) -> None:
    """Record, at each preemption, whether the victim is the youngest
    decoding sequence (the scheduler's rule)."""
    preempt = eng._preempt

    def check(seq):
        decoding = [s for s in eng.sched.active.values() if not s.is_prefilling]
        log.append(seq is max(decoding, key=lambda s: s.req.priority))
        preempt(seq)
    eng._preempt = check


def _page_bytes(model) -> int:
    """KV bytes of one page across every layer (the prefix cache's unit)."""
    k = model.init_paged_pool(1, 16, "cuda")["k"]
    return 2 * k.numel() * k.element_size()


def _check_tokens(run: str, model, params, trace, tokens) -> float:
    t0 = time.perf_counter()
    with torch.inference_mode():
        for req in trace:
            want = static_generate(model, params, req)
            if tokens[req.rid] != want:
                first = next(i for i, (a, b) in enumerate(zip(tokens[req.rid], want))
                             if a != b)
                raise AssertionError(
                    f"engine {run}: request {req.rid} (prompt {len(req.tokens)}) "
                    f"differs from static_generate at token {first}: "
                    f"{tokens[req.rid]} vs {want}")
    return time.perf_counter() - t0


def feature_run(run: str, cells: dict, drafts: dict) -> dict:
    """One run of FEATURE_RUNS on a phase-4 cell's packed weights (the
    draft tiers in ``drafts`` by cell): the engine, its trace, tokens and
    stats, the kernels' launches by tier, and what the run's gates read."""
    cell, features, n_pages = FEATURE_RUNS[run]
    sl = cells[cell]
    model, params = sl["model"], sl["params"]
    vocab = model.cfg.vocab
    victims: list[bool] = []
    extra = {}
    reset_counts()
    with _engine_probe(params) as seen, torch.inference_mode():
        if run == "tiled_csc_spec2":
            summary = serve.main(SPEC_ARGV, prepared=(model, params, sl["tokens"]))
            (eng,) = seen["engines"]
            trace, tokens, stats = summary["trace"], summary["tokens"], dict(eng.stats)
            extra = {k: summary[k] for k in ("draft_density", "draft_bytes")}
        elif run == "tiled_csc_cache":
            cache_dir = tempfile.mkdtemp(prefix="chip_smoke_cache_")
            eng = Engine(model, params, max_slots=4, page_size=16, max_len=80,
                         prefix_cache_budget=CACHE_BUDGET_PAGES * _page_bytes(model),
                         prefix_cache_dir=cache_dir, **features)
            epochs = [repeated_prompt_trace(4, prefix_len=32, suffix_len=16, max_new=8,
                                            vocab=vocab, page_size=16, rid_base=base)
                      for base in (0, 4)]
            fresh1 = eng.run(epochs[0])["stats"]["prompt_pages_fresh"]
            res = eng.run(epochs[1])
            trace, tokens, stats = epochs[0] + epochs[1], res["tokens"], res["stats"]
            eng.flush_prefix_cache()
            shutil.rmtree(cache_dir)
            extra = {"epoch1_fresh_pages": fresh1,
                     "epoch2_fresh_pages": stats["prompt_pages_fresh"] - fresh1}
        else:
            draft = drafts[cell] if features.get("spec_k") else None
            eng = Engine(model, params, max_slots=4, page_size=16, max_len=80,
                         n_pages=n_pages, draft_params=draft, **features)
            _youngest_first(eng, victims)
            trace = (shared_prefix_trace(8, prefix_len=32, max_prompt=64, max_new=16,
                                         vocab=vocab, seed=0, arrival_gap=2)
                     if run == "tiled_csc_stress" else
                     stress_spec_trace(8, prefix_len=32, max_prompt=64, max_new=16,
                                       vocab=vocab, seed=0, burst=2, rate=0.3))
            res = eng.run(trace)
            tokens, stats = res["tokens"], res["stats"]
    return {"eng": eng, "trace": trace, "tokens": tokens, "stats": stats,
            "seen": seen, "victims": victims, "extra": extra,
            "launches": {name: mod.launches for name, mod in COUNTERS.items()}}


def phase_feature(run: str, cells: dict, drafts: dict) -> dict:
    """One run of the engine's other stages (:func:`feature_run`), held
    against ``static_generate`` request by request, with its features'
    gates."""
    cell, features, _ = FEATURE_RUNS[run]
    kernel = CELLS[cell][2]
    other = "block_matmul" if kernel == "sod_matmul" else "sod_matmul"
    model, params = cells[cell]["model"], cells[cell]["params"]
    out = feature_run(run, cells, drafts)
    eng, trace, tokens, stats = out["eng"], out["trace"], out["tokens"], out["stats"]
    seen, victims, extra, launches = (out["seen"], out["victims"], out["extra"],
                                      out["launches"])
    if not (launches[kernel] > 0 and launches[other] == 0
            and launches["decompress"] == 0
            and seen["target"] + seen["draft"] == launches[kernel]):
        raise AssertionError(f"engine {run}: launches {launches}, by tier {seen}")
    if stats["completed"] != len(trace) or set(tokens) != {r.rid for r in trace}:
        raise AssertionError(f"engine {run}: {stats['completed']} of {len(trace)} "
                             "requests completed")
    if not stats["logits_finite"]:
        raise AssertionError(f"engine {run}: non-finite logits")
    pool = eng.page_pool
    if (pool.free_count != pool.n_pages - 1 or pool.allocated
            or (eng.trie is not None and len(eng.trie))):
        raise AssertionError(f"engine {run}: pool not clean: {pool.free_count} of "
                             f"{pool.n_pages - 1} free")
    if run == "tiled_csc_cache":      # the same two epochs with the cache off
        with torch.inference_mode():
            off = Engine(model, params, max_slots=4, page_size=16, max_len=80,
                         **features).run(trace)["tokens"]
        extra["equals_cache_off"] = tokens == off
    gates = {
        "tiled_csc_stress": (stats["preemptions"] >= 1 and stats["swapped_in_pages"] >= 1
                             and stats["shared_prompt_pages"] >= 1 and all(victims)),
        "tiled_csc_spec2": stats["spec_windows"] >= 1 and seen["draft"] > 0,
        "block_csr_stress_spec": (stats["preemptions"] >= 1 and stats["spec_rollbacks"] >= 1
                                  and all(victims) and seen["draft"] > 0),
        "tiled_csc_cache": (extra.get("epoch2_fresh_pages") == 0
                            and stats["prefix_demotions_disk"] >= 1
                            and extra.get("equals_cache_off")),
    }
    static_s = _check_tokens(run, model, params, trace, tokens)
    row = {"phase": "engine", "run": run, "cell": cell, "n_pages": pool.n_pages,
           "features": features, "launches": launches[kernel],
           "launches_by_tier": {"target": seen["target"], "draft": seen["draft"]},
           "bit_equal_to_static_generate": True, "static_generate_s": static_s,
           "youngest_decoding_evicted_first": victims, **extra,
           **{k: stats[k] for k in (
               "completed", "steps", "generated_tokens", "tokens_per_step",
               "acceptance_rate", "warmup_s", "steady_s", "steady_tok_per_s",
               "p50_latency_s", "p99_latency_s", "step_ms_p50", "step_ms_p99",
               "logits_finite")},
           "counters": {k: v for k, v in stats.items() if isinstance(v, int)
                        and not isinstance(v, bool) and k not in ("steps", "completed",
                                                                  "generated_tokens")}}
    if run in ("tiled_csc_stress", "block_csr_stress_spec"):
        row["preempt_log"] = eng.preempt_log
    log(row)
    if not gates[run]:
        raise AssertionError(f"engine {run}: a feature gate failed: {row}")
    return row


def _device_ms(fn) -> float:
    """Device ms of one call of ``fn`` under ``torch.profiler`` (after one
    call unprofiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA) / 1e3


def _wall_ms(fn, reps: int = 5) -> float:
    """Median wall ms of ``fn`` with the card synchronized around each call
    (host enqueue and device time together)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_spec_profile(cells: dict, draft) -> None:
    """Device time of one spec window (k = 2: the k + 1 draft decode steps
    the engine runs, then the verify pass) beside k + 1 plain decode steps,
    tiled_csc, 4 slots decoding at the same positions; and one whole engine
    step that runs a window: its device time against the unprofiled wall
    time of the step before it (the idle share)."""
    sl = cells["tiled_csc"]
    model, params = sl["model"], sl["params"]
    k = 2
    eng = Engine(model, params, max_slots=4, page_size=16, max_len=80, spec_k=k,
                 draft_params=draft)
    for r in poisson_trace(4, 0.5, max_prompt=64, max_new=16,
                           vocab=model.cfg.vocab, seed=0):
        eng.submit(dataclasses.replace(r, arrival=0, max_new=16))
    with torch.inference_mode():
        eng.warmup()
        eng.step()                   # admits 4 (fused prefills) and a window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_wall = (time.perf_counter() - t0) * 1e3
        step_dev = _device_ms(eng.step)
        if len(eng.sched.active) != 4:
            raise AssertionError("spec profile: not every slot is still decoding")
        bt, tok, pos, valid = eng._decode_inputs(eng._valid_lens())

        def draft_steps():
            d = tok
            for j in range(k + 1):
                d = eng._decode(eng.draft_params, eng.draft_pool, bt, d, pos + j,
                                valid)[0].reshape(4, 1)

        window = torch.cat([tok, tok.expand(4, k)], 1)

        def verify():
            eng._verify(params, eng.pool, bt, window, pos, valid)

        def plain_steps():
            for j in range(k + 1):
                eng._decode(params, eng.pool, bt, tok, pos + j, valid)

        draft_ms, verify_ms, plain_ms = map(_device_ms, (draft_steps, verify, plain_steps))
        wall = {name: _wall_ms(fn) for name, fn in (
            ("draft_steps", draft_steps), ("verify", verify), ("plain_decode_steps",
                                                                plain_steps))}
    log({"phase": "spec_profile", "cell": "tiled_csc", "k": k,
         "what": "4 slots decoding, full width; device ms from torch.profiler, "
                 "wall ms synchronized (median of 5)",
         "draft_steps_ms": draft_ms, "verify_ms": verify_ms,
         "window_ms": draft_ms + verify_ms, "plain_decode_steps_ms": plain_ms,
         "wall_ms": wall,
         "engine_step_device_ms": step_dev, "engine_step_wall_ms": step_wall,
         "engine_step_idle_share": (1 - step_dev / step_wall) if step_dev else
         "not measured"})


def _entry(name: str, qmode: str, kern: dict, launches: int) -> dict:
    """One kernel's line in one qmode: the seven projections of one layer
    (M = 4 at decode for the matmuls, and M = 128 at prefill beside it),
    bf16 activations, summed from the per-shape medians."""
    def layer(tag: str) -> tuple[list, dict]:
        rows = [(row, PATH_SHAPES[(k, n)][1])
                for (kn, q, k, n, t), row in kern["timed"].items()
                if kn == name and q == qmode and t == tag]
        keys = ("kernel_ms", "plain_ms", "bound_ms") + (
            () if name == "decompress" and qmode != "none" else ("library_ms",))
        return rows, {key: sum(r[key] * c for r, c in rows) for key in keys}

    rows, total = layer("path" if name == "decompress" else "decode")
    lib = total.get("library_ms")
    prefill = {} if name == "decompress" else layer("prefill")[1]
    source, replaces = SOURCES[name]
    out = "float32" if qmode != "none" else "bf16"
    return {
        "name": name if qmode == "none" else f"{name}[{qmode}]",
        "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": kern["max_err"][(name, qmode)],
        "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r, _ in rows)
        else "operations",
        "library_ms": lib,
        "prefill_ms": prefill.get("kernel_ms"),
        "prefill_library_ms": prefill.get("library_ms"),
        "prefill_bound_ms": prefill.get("bound_ms"),
        "work": (f"one layer's 7 projections densified ({out} out), summed"
                 if name == "decompress" else
                 "one layer's 7 projections at decode (M=4, bf16), summed; "
                 "prefill_*: the same at M=128"),
    }


def _launches_of(name: str, qmode: str, cells: dict, kern: dict) -> tuple[int, str]:
    """(launches, where): from the cell that serves the kernel in this qmode
    (or, for decompress, densifies its weights), else from phase 3."""
    for cell, (_, _, kernel, q, _) in CELLS.items():
        if q != qmode:
            continue
        if name == kernel:
            return cells[cell]["launches"], cell
        if name == "decompress" and kernel == "sod_matmul":
            return cells[cell]["decompress_launches"], cell
    return kern["launches"][(name, qmode)], "phase 3"


def main() -> None:
    t_start = time.perf_counter()
    seconds = {}

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0
        log({"phase_seconds": {phase: seconds[phase]}})
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    kern = timed("kernels", phase_kernels)
    cells = {cell: timed(f"slice:{cell}", phase_slice, cell) for cell in CELLS}
    check_quantized_bytes(cells)
    for cell in PROFILED:
        sl = cells[cell]
        timed("profile", phase_profile, cell, sl["model"], sl["params"], sl["tokens"])
    timed("profile", phase_head, cells["tiled_csc"]["params"], 4)
    engine = {run: timed(f"engine:{run}", phase_engine, run, cells)
              for run in ENGINE_RUNS}
    timed("engine_profile", phase_engine_profile, cells)
    spec_args = serve.parse_args(SPEC_ARGV)
    drafts = {cell: serve.prepare_draft(spec_args, cells[cell]["model"])
              for cell in ("tiled_csc", "block_csr")}
    engine.update({run: timed(f"engine:{run}", phase_feature, run, cells, drafts)
                   for run in FEATURE_RUNS})
    timed("spec_profile", phase_spec_profile, cells, drafts["tiled_csc"])
    del drafts

    entries = []
    for qmode in ("none", *QMODES):
        for name in ("sod_matmul", "block_matmul", "decompress"):
            launches, where = _launches_of(name, qmode, cells, kern)
            entry = {**_entry(name, qmode, kern, launches), "launches_in": where}
            if qmode == "none":
                entry["engine_launches"] = {run: row["launches"] for run, row in
                                            engine.items()
                                            if CELLS[row["cell"]][2] == name}
            entries.append(entry)
    log({"phase_seconds": seconds, "total_s": time.perf_counter() - t_start})
    log(smi)
    log({"kernels": entries})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
