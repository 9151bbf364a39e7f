#!/usr/bin/env python3
"""Host and device time of a Sparse-on-Dense kernel's wrapper at the
serving path's shapes.

    python3 scripts/sod_matmul_probe.py
        [--kernel sod_matmul|block_matmul|decompress] [--src DIR]

Run from the root of a checkout on an NVIDIA GPU.  ``--kernel`` picks the
kernel: ``sod_matmul`` (TiledCSC, magnitude-pruned weights; qmodes
``none``, ``int8``, ``fp8``, ``codebook``) or ``block_matmul`` (BlockCSR of (8, 128)
sub-blocks, block-pruned weights; qmodes ``none``, ``int8``, ``fp8``,
``codebook``).  ``--src`` names the ``src`` directory whose ``repro_torch``
is measured (default: this checkout's), so that two trees, such as a parent
commit unpacked with ``git archive``, are compared on one card, one process
each.  At each (K, N) of the path (``PATH_SHAPES``, as in ``chip_smoke.py``),
with bf16 activations and weights pruned to density 0.3, it reports:

- ``host_us`` and ``host_us_min``: the wrapper's host time per call at
  decode (M = 4), the median and the least of HOST_BLOCKS blocks of
  HOST_CALLS back-to-back calls, each block timed with ``perf_counter``
  (the card keeps up with the calls; the launch queue is drained after
  each block, outside the timing);
- ``decode_ms``, ``prefill_ms`` and ``train_ms`` (M = 4, 128 and 1024, the
  rows of a training step at batch 8 × seq 128): device time per call,
  CUDA events, median of REPS, each call starting with a clean L2 (a 512 MB
  buffer read, not written) behind a spin kernel that hides the host's
  enqueue: the yardstick of this checkout's
  ``src/repro_torch/kernels/timing.py``, which ``chip_smoke.py`` and the
  autotuner use too (loaded from this checkout whatever ``--src`` says, so
  two trees are timed alike);
- at M = 1024, ``train_bound_ms`` and ``train_bound_by``: the least time
  for the call, max(bytes / HBM rate, operations / bf16 peak) at
  ``H100_SXM``'s rates (this checkout's ``src/repro_torch/core/topology.py``),
  counting each input read once, the bf16 output written once and 2
  operations a stored value and row of x; and ``train_matmul_ms``, one
  ``torch.matmul`` of the same x on the dense bf16 weight (the yardstick);
- at decode, data probes on the same operand.  ``sod_matmul``: every row
  index set to padding (``pad_ms``: the copies, x staging, the walk over
  the slots and the split-K reduction, no gather of x and no multiply-add),
  and slot s of every column at row s (``rows_s_ms``: every slot real, a
  warp gathering one row of x at a time, so no bank conflicts).
  ``block_matmul``: every macro tile empty (``empty_ms``: tile_nnz 0 and
  every id padding, so no value is read: the launch, the tile list, x
  staging and the split-K reduction).

Every operand is first held against the plain version, with f32 output (a
probe's sums cancel far more than real data's).  Prints one JSON line per
case, one per qmode with the seven projections of a layer summed, the
``nvidia-smi`` name and power limit, and last ``{"ok": true}``.

``--kernel decompress`` times the standalone decompression kernel on
magnitude-pruned TiledCSC operands in every qmode (bf16 values, bf16 out;
quantized codes, f32 out, each call's default), each first held bit for bit
against the plain version.  Per (K, N) and qmode it prints ``ms`` (device
time a call, the yardstick above), ``bound_ms`` (the bytes of vals, rows,
the side band and the dense output at 3.35 TB/s), ``share`` (bound / ms),
``pad_ms`` (every row index padding: the copies and the write-out, no slot
placed), ``copy_ms`` (one ``copy_`` between two byte buffers of half the
bound's bytes each: the same traffic as a plain device copy, the practical
ceiling of a kernel that reads and writes) and ``host_us``; then the same
summed over a layer's seven
projections, and ``launch_floor_ms``, the yardstick's time of a
one-element ``zero_`` (the least a launch costs on it).  Where the measured
tree's wrapper plans its launches from the constants ``CTAS_PER_SM`` and
``THREADS``, it also times each setting of DECOMPRESS_PLANS (``ms_<name>``
and the layer sums), set on the module for the timing and then restored.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (K, N) of a layer's projections and how many of each (chip_smoke.py's)
PATH_SHAPES = {(2048, 2048): 2, (2048, 512): 2, (2048, 8192): 2, (8192, 2048): 1}
QMODES = {"sod_matmul": ("none", "int8", "fp8", "codebook"),
          "block_matmul": ("none", "int8", "fp8", "codebook"),
          "decompress": ("none", "int8", "fp8", "codebook")}
# decompress's plan constants beside the module's own (decompress.plan_launch)
DECOMPRESS_PLANS = {"cta1": {"CTAS_PER_SM": 1},
                    "cta1_threads1024": {"CTAS_PER_SM": 1, "THREADS": 1024},
                    "threads256": {"THREADS": 256},
                    "threads1024": {"THREADS": 1024}}
DENSITY = 0.3
REPS = 25
TRAIN_M = 1024            # a training step's rows at batch 8 × seq 128
HOST_BLOCKS = 40
HOST_CALLS = 25
TOL = 1e-4                # f32 output, relative to the largest |y| (chip_smoke's)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def _timing():
    """This checkout's yardstick module, loaded from its file (it imports
    only torch), so the package under ``--src`` is not shadowed."""
    spec = importlib.util.spec_from_file_location(
        "_probe_timing", ROOT / "src" / "repro_torch" / "kernels" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _topology():
    """This checkout's chip spec module (it imports only the standard
    library), loaded from its file, so a tree under ``--src`` that has none
    is bounded by the same rates."""
    spec = importlib.util.spec_from_file_location(
        "_probe_topology", ROOT / "src" / "repro_torch" / "core" / "topology.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


H100_SXM = _topology().H100_SXM
HBM_BYTES_PER_S = H100_SXM.hbm_bandwidth
PEAK_BF16_OPS_PER_S = H100_SXM.peak_bf16_flops


def host_us(torch, fn) -> tuple[float, float]:
    """Median and least host time of one call, in µs, over blocks of calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    blocks = []
    for _ in range(HOST_BLOCKS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        blocks.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(blocks), min(blocks)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(QMODES), default="sod_matmul")
    ap.add_argument("--src", type=pathlib.Path, default=ROOT / "src",
                    help="directory holding the repro_torch package to measure")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    from repro_torch.core.formats import (pack_block_csr, pack_tiled_csc,
                                          quantize_packed)
    from repro_torch.core.pruning import block_prune, magnitude_prune
    from repro_torch.kernels import block_matmul as bmm
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import sod_matmul as sm

    if not torch.cuda.is_available():
        raise SystemExit("sod_matmul_probe: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.kernel == "decompress":
        probe_decompress(torch, args.src, smi)
        return
    block = args.kernel == "block_matmul"
    kernel = bmm.block_matmul if block else sm.sod_matmul
    plain = ref.block_matmul_ref if block else ref.sod_matmul_ref
    qmodes = QMODES[args.kernel]
    build.load(args.kernel)
    timing = _timing()
    flush = timing.flush_buffer()

    def device_ms(fn) -> float:
        return timing.device_ms(fn, flush, REPS)

    src = str(args.src)

    def probes(p) -> dict:
        if block:
            return {"empty": dataclasses.replace(
                p, tile_nnz=torch.zeros_like(p.tile_nnz),
                block_ids=torch.full_like(p.block_ids, -1))}
        slot = torch.arange(p.cap, dtype=p.rows.dtype, device="cuda")
        return {"pad": dataclasses.replace(p, rows=torch.full_like(p.rows, -1)),
                "rows_s": dataclasses.replace(
                    p, rows=slot[:, None].expand(p.rows.shape).contiguous())}

    def work(x, p) -> tuple[int, int]:
        """(bytes, operations) of one call with bf16 out, as chip_smoke.py
        counts them."""
        nb = lambda t: 0 if t is None else t.numel() * t.element_size()  # noqa: E731
        m, n = x.shape[0], p.shape[1]
        io = nb(x) + nb(p.scale) + nb(p.codebook) + m * n * x.element_size()
        if block:
            tiles = int(p.tile_nnz.sum())
            stored = tiles * p.br * p.tile[1]
            return (io + stored * p.block_vals.element_size() + tiles * 4
                    + nb(p.tile_nnz), 2 * m * stored)
        return io + nb(p.vals) + nb(p.rows), 2 * m * int((p.rows >= 0).sum())

    # the operands, all made before any timing (codebooks fit in numpy, in threads)
    bases, xs, dense = {}, {}, {}
    for i, (k, n) in enumerate(PATH_SHAPES):
        g = torch.Generator(device="cuda")
        g.manual_seed(2000 + i)
        w = torch.randn(k, n, generator=g, device="cuda").to(torch.bfloat16)
        xs[(k, n)] = {m: torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
                      for m in (4, 128, TRAIN_M)}
        dense[(k, n)] = block_prune(w, DENSITY) if block else magnitude_prune(w, DENSITY)
        bases[(k, n)] = (pack_block_csr(dense[(k, n)]) if block
                         else pack_tiled_csc(dense[(k, n)]))
    jobs = [(kn, q) for kn in PATH_SHAPES for q in qmodes]
    with ThreadPoolExecutor(max_workers=8) as pool:
        ops = dict(zip(jobs, pool.map(
            lambda job: bases[job[0]] if job[1] == "none"
            else quantize_packed(bases[job[0]], job[1]), jobs)))

    layer = {q: {"host_us": 0.0, "host_us_min": 0.0, "decode_ms": 0.0,
                 "prefill_ms": 0.0, "train_ms": 0.0, "train_bound_ms": 0.0,
                 "train_matmul_ms": 0.0} for q in qmodes}
    for (k, n), count in PATH_SHAPES.items():
        for qmode in qmodes:
            p = ops[((k, n), qmode)]
            extra = probes(p)
            for name, q in [("real", p)] + list(extra.items()):
                for x in xs[(k, n)].values():
                    y = kernel(x, q, torch.float32)
                    yr = plain(x, q, torch.float32)
                    err = (y - yr).abs().max().item()
                    if not err <= TOL * max(yr.abs().max().item(), 1e-30):
                        raise AssertionError(f"{name} {(k, n, x.shape[0], qmode)}: "
                                             f"max |err| {err}")
            x4, x128, x1024 = (xs[(k, n)][m] for m in (4, 128, TRAIN_M))
            host, host_min = host_us(torch, lambda: kernel(x4, p))
            nbytes, n_ops = work(x1024, p)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / PEAK_BF16_OPS_PER_S
            w = dense[(k, n)]
            row = {"src": src, "kernel": args.kernel, "K": k, "N": n, "qmode": qmode,
                   ("bcap" if block else "cap"): p.bcap if block else p.cap,
                   "host_us": host, "host_us_min": host_min,
                   "decode_ms": device_ms(lambda: kernel(x4, p)),
                   "prefill_ms": device_ms(lambda: kernel(x128, p)),
                   "train_ms": device_ms(lambda: kernel(x1024, p)),
                   "train_bound_ms": max(t_bytes, t_ops) * 1e3,
                   "train_bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "train_matmul_ms": device_ms(lambda: torch.matmul(x1024, w))}
            for name, q in extra.items():
                row[f"{name}_ms"] = device_ms(lambda: kernel(x4, q))
            log(row)
            for key in layer[qmode]:
                layer[qmode][key] += count * row[key]
    for qmode, sums in layer.items():
        log({"src": src, "kernel": args.kernel, "layer": qmode, **sums})
    log({"rates": {"chip": H100_SXM.name, "hbm_bytes_per_s": HBM_BYTES_PER_S,
                   "peak_bf16_ops_per_s": PEAK_BF16_OPS_PER_S}})
    log(smi)
    log({"ok": True})


def probe_decompress(torch, src: pathlib.Path, smi: str) -> None:
    """``--kernel decompress``: see the module's docstring."""
    from repro_torch.core.formats import pack_tiled_csc, quantize_packed
    from repro_torch.core.pruning import magnitude_prune
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decompress as dk

    build.load("decompress")
    timing = _timing()
    flush = timing.flush_buffer()
    plans = DECOMPRESS_PLANS if hasattr(dk, "CTAS_PER_SM") else {}

    def device_ms(fn) -> float:
        return timing.device_ms(fn, flush, REPS)

    @contextlib.contextmanager
    def planned(consts: dict):
        if not consts:                  # the tree's own plan (a parent has no constants)
            yield
            return
        saved = {name: getattr(dk, name) for name in consts}
        vars(dk).update(consts)
        dk.plan_launch.cache_clear()
        try:
            yield
        finally:
            vars(dk).update(saved)
            dk.plan_launch.cache_clear()

    def nbytes(t) -> int:
        return 0 if t is None else t.numel() * t.element_size()

    bases = {}
    for i, (k, n) in enumerate(PATH_SHAPES):
        g = torch.Generator(device="cuda")
        g.manual_seed(2000 + i)
        w = torch.randn(k, n, generator=g, device="cuda").to(torch.bfloat16)
        bases[(k, n)] = pack_tiled_csc(magnitude_prune(w, DENSITY))
    jobs = [(kn, q) for kn in PATH_SHAPES for q in QMODES["decompress"]]
    with ThreadPoolExecutor(max_workers=8) as pool:
        ops = dict(zip(jobs, pool.map(
            lambda job: bases[job[0]] if job[1] == "none"
            else quantize_packed(bases[job[0]], job[1]), jobs)))

    keys = ["ms", "bound_ms", "pad_ms", "copy_ms", "host_us"] + [f"ms_{name}" for name in plans]
    layer = {q: dict.fromkeys(keys, 0.0) for q in QMODES["decompress"]}
    for (k, n), count in PATH_SHAPES.items():
        for qmode in QMODES["decompress"]:
            p = ops[((k, n), qmode)]
            pad = dataclasses.replace(p, rows=torch.full_like(p.rows, -1))
            for name, plan in [("default", {})] + list(plans.items()):
                for q in (p, pad):
                    with planned(plan):
                        y = dk.decompress(q)
                    yr = ref.decompress_tiled_ref(q)
                    if not (y.dtype == yr.dtype and torch.equal(y, yr)):
                        raise AssertionError(f"decompress {(k, n, qmode, name)} is not "
                                             "bit-equal to its plain version")
            y = dk.decompress(p)
            moved = (nbytes(p.vals) + nbytes(p.rows) + nbytes(p.scale)
                     + nbytes(p.codebook) + nbytes(y))
            bound = moved / HBM_BYTES_PER_S * 1e3
            src_buf, dst_buf = (torch.empty(moved // 2, dtype=torch.uint8, device="cuda")
                                for _ in range(2))
            row = {"src": str(src), "kernel": "decompress", "K": k, "N": n,
                   "qmode": qmode, "cap": p.cap, "out_dtype": str(y.dtype).split(".")[-1],
                   "ms": device_ms(lambda: dk.decompress(p)), "bound_ms": bound,
                   "pad_ms": device_ms(lambda: dk.decompress(pad)),
                   "copy_ms": device_ms(lambda: dst_buf.copy_(src_buf)),
                   "host_us": host_us(torch, lambda: dk.decompress(p))[0]}
            if plans:
                row["plan"] = dataclasses.asdict(dk.plan_of(p, y.dtype))
            for name, plan in plans.items():
                with planned(plan):
                    row[f"ms_{name}"] = device_ms(lambda: dk.decompress(p))
            row["share"] = bound / row["ms"]
            log(row)
            for key in keys:
                layer[qmode][key] += count * row[key]
    one = torch.empty(1, device="cuda")
    log({"src": str(src), "launch_floor_ms": device_ms(one.zero_)})
    for qmode, sums in layer.items():
        log({"src": str(src), "kernel": "decompress", "layer": qmode, **sums,
             "share": sums["bound_ms"] / sums["ms"],
             "copy_share": sums["bound_ms"] / sums["copy_ms"],
             **{f"share_{name}": sums["bound_ms"] / sums[f"ms_{name}"] for name in plans}})
    log(smi)
    log({"ok": True})


if __name__ == "__main__":
    main()
