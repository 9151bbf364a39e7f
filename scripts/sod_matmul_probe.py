#!/usr/bin/env python3
"""Host and device time of a Sparse-on-Dense matmul kernel's wrapper at the
serving path's shapes.

    python3 scripts/sod_matmul_probe.py [--kernel sod_matmul|block_matmul]
                                        [--src DIR]

Run from the root of a checkout on an NVIDIA GPU.  ``--kernel`` picks the
kernel: ``sod_matmul`` (TiledCSC, magnitude-pruned weights; qmodes
``none``, ``int8``, ``fp8``) or ``block_matmul`` (BlockCSR of (8, 128)
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
- ``decode_ms`` and ``prefill_ms`` (M = 4 and 128): device time per call,
  CUDA events, median of REPS, each call starting with a clean L2 (a 512 MB
  buffer read, not written) behind a spin kernel that hides the host's
  enqueue, as ``chip_smoke.py`` times;
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
"""
from __future__ import annotations

import argparse
import dataclasses
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
QMODES = {"sod_matmul": ("none", "int8", "fp8"),
          "block_matmul": ("none", "int8", "fp8", "codebook")}
DENSITY = 0.3
REPS = 25
HOST_BLOCKS = 40
HOST_CALLS = 25
FLUSH_BYTES = 512 << 20   # > 50 MB L2: every timed launch reads from HBM
SPIN_HZ = 2e9             # spin cycles a second: at least the H100's top SM clock
TOL = 1e-4                # f32 output, relative to the largest |y| (chip_smoke's)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def device_ms(torch, fn, flush) -> float:
    """Median device time of one call, CUDA events, as ``chip_smoke.py``
    times: L2 left clean before each (the flush buffer read, not written),
    then a spin kernel that keeps the card busy while the host enqueues the
    call (at least 1 ms and 4x the host time of one call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    cycles = int(SPIN_HZ * max(1e-3, 4 * (time.perf_counter() - t0)))
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
    block = args.kernel == "block_matmul"
    kernel = bmm.block_matmul if block else sm.sod_matmul
    plain = ref.block_matmul_ref if block else ref.sod_matmul_ref
    qmodes = QMODES[args.kernel]
    build.load(args.kernel)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
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

    # the operands, all made before any timing (codebooks fit in numpy, in threads)
    bases, xs = {}, {}
    for i, (k, n) in enumerate(PATH_SHAPES):
        g = torch.Generator(device="cuda")
        g.manual_seed(2000 + i)
        w = torch.randn(k, n, generator=g, device="cuda").to(torch.bfloat16)
        xs[(k, n)] = {m: torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
                      for m in (4, 128)}
        bases[(k, n)] = (pack_block_csr(block_prune(w, DENSITY)) if block
                         else pack_tiled_csc(magnitude_prune(w, DENSITY)))
    jobs = [(kn, q) for kn in PATH_SHAPES for q in qmodes]
    with ThreadPoolExecutor(max_workers=8) as pool:
        ops = dict(zip(jobs, pool.map(
            lambda job: bases[job[0]] if job[1] == "none"
            else quantize_packed(bases[job[0]], job[1]), jobs)))

    layer = {q: {"host_us": 0.0, "host_us_min": 0.0, "decode_ms": 0.0,
                 "prefill_ms": 0.0} for q in qmodes}
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
            x4, x128 = xs[(k, n)][4], xs[(k, n)][128]
            host, host_min = host_us(torch, lambda: kernel(x4, p))
            row = {"src": src, "kernel": args.kernel, "K": k, "N": n, "qmode": qmode,
                   ("bcap" if block else "cap"): p.bcap if block else p.cap,
                   "host_us": host, "host_us_min": host_min,
                   "decode_ms": device_ms(torch, lambda: kernel(x4, p), flush),
                   "prefill_ms": device_ms(torch, lambda: kernel(x128, p), flush)}
            for name, q in extra.items():
                row[f"{name}_ms"] = device_ms(torch, lambda: kernel(x4, q), flush)
            log(row)
            for key in layer[qmode]:
                layer[qmode][key] += count * row[key]
    for qmode, sums in layer.items():
        log({"src": src, "kernel": args.kernel, "layer": qmode, **sums})
    log(smi)
    log({"ok": True})


if __name__ == "__main__":
    main()
