#!/usr/bin/env python3
"""Static serving end to end at full width on an NVIDIA GPU, and the row
invariance that the engine's equality with static serving rests on.

    python3 scripts/serve_probe.py prefill [--src DIR] [--prompt-lens 512 2048]
                                           [--batch 4]
    python3 scripts/serve_probe.py decode [--src DIR] [--repeats 5]
    python3 scripts/serve_probe.py invariance
    python3 scripts/serve_probe.py dispatch [--src DIR]

Run from the root of a checkout.  ``--src`` names the ``src`` directory
whose ``repro_torch`` is measured (default: this checkout's), so that two
trees, such as a parent commit unpacked with ``git archive``, are compared
on one card, one process each.  The model is llama3.2-1b at full width in
bf16 with seeded random weights, as in ``chip_smoke.py``.

- ``prefill``: tiled_csc weights (magnitude-pruned to 0.3).  For each prompt
  length, ``model.prefill`` of a (batch, length) prompt: wall seconds (the
  median of 3 calls after one warm call, each ended by a synchronize) and
  the peak device memory it allocates above what was live before it
  (``torch.cuda.max_memory_allocated``).  A call that runs out of memory is
  reported as such.
- ``decode``: the static cells of ``chip_smoke.py``'s phase 4 (tiled_csc,
  tiled_csc_int8, block_csr, block_csr_fp8; batch 4, prompt 32, 16 tokens)
  through ``serve.main``, ``--repeats`` times on weights packed once:
  steady tokens/s and host ms a decode step (batch / tok/s), then one decode
  step under ``torch.profiler``: the kernels it launches and their device
  time.
- ``invariance``: (1) at the shapes the engine compares with static
  serving, how many rows change bits with the rows beside them or the
  cache's length (RMSNorm of a row alone against inside 4 rows; decode
  attention at batch 1 over ``plen + 16`` positions against batch 4 over
  80; prefill attention over the prompt against its page bucket and
  against 16-row chunks over 80 pool positions; the verify pass of k + 1
  positions against k + 1 sequential decode steps, k in {2, 4}, 4 slots,
  full width's attention layer with packed weights, with the reference's
  batched core and with the kept one, and RMSNorm at 4·(k + 1) rows at once
  against 4), and (2) ``chip_smoke.py``'s engine runs
  (``ENGINE_RUNS`` and ``FEATURE_RUNS``) against ``static_generate``: the
  requests whose tokens differ.
- ``dispatch``: the host's cost of dispatching one packed matmul through
  the kernel registry, as every projection of a served step does: its
  problem key (``registry.problem_key``) and its resolution
  (``ops.resolve``, a memo hit once warm), at decode (M = 4) on each
  full-width layout of tiled_csc weights at density 0.3, keyed on
  ``cuda``.  Three cases: nothing recording, under the dispatch record
  that ``serve.main`` keeps for its summary, and that with a plan's hint
  (``fallback_params``).  Each is the median of DISPATCH_BLOCKS blocks of
  DISPATCH_CALLS calls, in µs a call, and times 112 (the packed matmuls of
  a decode step) in ms a step.  It runs on the host alone: with no GPU it
  measures this host's CPU.

Prints one JSON line per measurement, the ``nvidia-smi`` name and power
limit (where there is a GPU), and last ``{"ok": true}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "32", "--gen",
        "16", "--seed", "0", "--device", "cuda"]
TILED = BASE + ["--sod", "tiled_csc", "--density", "0.3"]
# full-width llama3.2-1b projections (K, N), and the packed matmuls of a step
LAYOUTS = {"wq": (2048, 2048), "wk": (2048, 512), "w_gate": (2048, 8192),
           "w_down": (8192, 2048)}
STEP_CALLS = 112
DISPATCH_BLOCKS = 30
DISPATCH_CALLS = 2000


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def _block_sod(qmode: str):
    from repro_torch.core.sod import SoDConfig
    return SoDConfig(mode="block_csr", density=0.3, prune_method="block",
                     min_dim=64, qmode=qmode)


def prefill(torch, args) -> None:
    from repro_torch.launch import serve

    model, params, *_ = serve.prepare(serve.parse_args(TILED))
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for plen in args.prompt_lens:
        tokens = torch.randint(0, model.cfg.vocab, (args.batch, plen),
                               generator=g, device="cuda")
        row = {"src": str(args.src), "what": "static prefill", "batch": args.batch,
               "prompt_len": plen}
        try:
            with torch.inference_mode():
                secs, peaks = [], []
                for _ in range(4):
                    torch.cuda.synchronize()
                    live = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    logits, cache = model.prefill(params, tokens)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    peaks.append(torch.cuda.max_memory_allocated() - live)
                    del logits, cache
            row.update(seconds=statistics.median(secs[1:]), seconds_all=secs,
                       peak_gib=max(peaks) / 2**30)
        except torch.cuda.OutOfMemoryError as err:
            row.update(out_of_memory=str(err).split("\n")[0])
        log(row)
        torch.cuda.empty_cache()


def decode(torch, args) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    cells = {"tiled_csc": (TILED, None),
             "tiled_csc_int8": (TILED + ["--quantize", "int8"], None),
             "block_csr": (BASE, _block_sod("none")),
             "block_csr_fp8": (BASE, _block_sod("fp8"))}
    for cell, (argv, sod) in cells.items():
        prepared = serve.prepare(serve.parse_args(argv), sod)
        model, params, tokens = prepared[:3]
        toks = [serve.main(argv, sod=sod, prepared=prepared)["steady_tok_per_s"]
                for _ in range(args.repeats)]
        with torch.inference_mode():
            _, cache, pos = serve.prefill_cache(model, params, tokens, 48)
            tok = torch.zeros((tokens.shape[0], 1), dtype=torch.long, device="cuda")
            model.decode_step(params, cache, tok, pos)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model.decode_step(params, cache, tok, pos + 1)
                torch.cuda.synchronize()
        kernels = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        log({"src": str(args.src), "what": "static decode", "cell": cell,
             "steady_tok_per_s": toks,
             "host_ms_per_step": [1e3 * tokens.shape[0] / t for t in toks],
             "host_ms_per_step_median": statistics.median(
                 1e3 * tokens.shape[0] / t for t in toks),
             "kernels_per_step": len(kernels),
             "device_ms_per_step": sum(ev.time_range.elapsed_us()
                                       for ev in kernels) / 1e3})
        del prepared, model, params, cache
        torch.cuda.empty_cache()


def _rows_that_differ(torch, a, b) -> int:
    return int((a != b).flatten(1).any(dim=1).sum())


def invariance_unit(torch) -> None:
    """Rows whose bits change with their neighbours or the cache's length,
    at the engine's shapes."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    spec = attn.AttnSpec(n_heads=32, n_kv_heads=8, head_dim=64)
    x = torch.randn(256, 4, 2048, generator=g, device="cuda").bfloat16()
    gain = torch.randn(2048, generator=g, device="cuda") * 0.1
    alone = torch.cat([layers.rms_norm(x[i, :1], gain) for i in range(256)])
    four = torch.stack([layers.rms_norm(x[i], gain)[0] for i in range(256)])
    log({"what": "rms_norm, row alone vs inside 4 rows", "rows": 256,
         "rows_that_differ": _rows_that_differ(torch, alone, four)})
    n, d_bucket, d_chunk = 0, 0, 0
    for plen in range(33, 65, 3):
        bucket = -(-plen // 16) * 16
        x = torch.randn(64, 2048, generator=g, device="cuda").bfloat16()
        bare = layers.rms_norm(x[:plen], gain)
        chunks = torch.cat([layers.rms_norm(x[s:s + 16], gain)
                            for s in range(0, plen, 16)])[:plen]
        n += plen
        d_bucket += _rows_that_differ(torch, bare, layers.rms_norm(x[:bucket], gain)[:plen])
        d_chunk += _rows_that_differ(torch, bare, chunks)
    log({"what": "rms_norm, prompt rows vs page bucket and vs 16-row chunks",
         "rows": n, "rows_that_differ_bucket": d_bucket,
         "rows_that_differ_chunks": d_chunk})

    n, differ = 0, 0
    for trial in range(64):
        q = torch.randn(4, 1, 32, 64, generator=g, device="cuda").bfloat16()
        k = torch.randn(4, 80, 8, 64, generator=g, device="cuda").bfloat16()
        v = torch.randn(4, 80, 8, 64, generator=g, device="cuda").bfloat16()
        pos = torch.randint(32, 79, (4,), generator=g, device="cuda")
        batch = attn._attend_cached(q, k, v, pos, spec, None)
        for row in range(4):
            p = int(pos[row])
            plen = int(torch.randint(32, p + 1, (1,), generator=g, device="cuda"))
            s = plen + 16 if plen + 16 > p else p + 1
            one = attn._attend_cached(q[row:row + 1], k[row:row + 1, :s],
                                      v[row:row + 1, :s], p, spec, None)
            n += 1
            differ += _rows_that_differ(torch, batch[row:row + 1], one)
    log({"what": "decode attention, batch 4 over 80 positions vs batch 1 "
                 "over plen + 16", "rows": n, "rows_that_differ": differ})

    n, d_bucket, d_chunk = 0, 0, 0
    for plen in range(33, 65, 3):
        bucket = -(-plen // 16) * 16
        q = torch.randn(1, 80, 32, 64, generator=g, device="cuda").bfloat16()
        k = torch.randn(1, 80, 8, 64, generator=g, device="cuda").bfloat16()
        v = torch.randn(1, 80, 8, 64, generator=g, device="cuda").bfloat16()
        bare = attn.chunked_attention(q[:, :plen], k[:, :plen], v[:, :plen], spec)
        padded = attn.chunked_attention(q[:, :bucket], k[:, :bucket],
                                        v[:, :bucket], spec)[:, :plen]
        # a 16-row chunk against the 80 gathered positions, as the pool's
        qh = q.reshape(1, 80, 8, 4, 64)
        pos = torch.arange(80, device="cuda")
        outs = []
        for start in range(0, plen, 16):
            idx = start + torch.arange(16, device="cuda")
            mask = (pos[None, :] <= idx[:, None])[None, None, None]
            init = (torch.full((1, 8, 4, 16), attn.NEG_INF, device="cuda"),
                    torch.zeros((1, 8, 4, 16), device="cuda"),
                    torch.zeros((1, 8, 4, 16, 64), device="cuda"))
            _, l, acc = attn._online_block(
                init, attn._block_scores(qh[:, start:start + 16], k, spec), v, mask)
            out = acc / torch.clamp(l, min=1e-30)[..., None]
            outs.append(out.permute(0, 3, 1, 2, 4).reshape(1, 16, 32, 64))
        chunked = torch.cat(outs, dim=1)[:, :plen].to(q.dtype)
        n += plen
        d_bucket += _rows_that_differ(torch, bare[0], padded[0])
        d_chunk += _rows_that_differ(torch, bare[0], chunked[0])
    log({"what": "prefill attention, prompt vs page bucket and vs 16-row "
                 "chunks over 80 positions", "rows": n,
         "rows_that_differ_bucket": d_bucket, "rows_that_differ_chunks": d_chunk})
    invariance_verify(torch, g, spec)


def _verify_batched(torch, tp, x, pool, tables, start, spec):
    """The verify pass with the reference's core: one softmax and value
    einsum over all C query rows (the form the port tried first)."""
    from repro_torch.core import sod
    from repro_torch.models import attention as attn

    b, c, _ = x.shape
    idx = start[:, None] + torch.arange(c, device=x.device)[None, :]
    q, k_new, v_new = attn._project_qkv(tp, x, spec, idx)
    page, off = tables.gather(1, idx // 16), idx % 16
    pool["k"][page.reshape(-1), off.reshape(-1)] = k_new.reshape(b * c, 8, 64)
    pool["v"][page.reshape(-1), off.reshape(-1)] = v_new.reshape(b * c, 8, 64)
    k_cache, v_cache = attn._gather_pages(pool, tables, spec)
    scores = attn._block_scores(q.reshape(b, c, 8, 4, 64), k_cache, spec)
    mask = torch.arange(k_cache.shape[1], device=x.device)[None, None] <= idx[..., None]
    p = torch.softmax(torch.where(mask[:, None, None], scores, attn.NEG_INF), dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p.to(v_cache.dtype).float(), v_cache.float())
    return sod.apply(out.reshape(b, c, -1).to(x.dtype), tp["wo"])


def invariance_verify(torch, g, spec) -> None:
    """Rows of a verify pass (k + 1 positions a slot) that differ from k + 1
    sequential ``paged_decode_attention`` steps, at full width's attention
    layer with tiled_csc-packed bf16 weights (the matmul kernels are
    row-invariant, so a differing row is the attention core's): the
    reference's batched core and the kept ``paged_verify_attention`` (the
    decode core once a position); and RMSNorm rows at the verify pass's
    4·(k + 1) rows at once against 4 at a time."""
    from repro_torch.core.sod import SoDConfig, pack_param
    from repro_torch.models import attention as attn
    from repro_torch.models import layers

    cfg = SoDConfig(mode="tiled_csc", density=0.3, min_dim=64)
    tp = {name: pack_param((torch.randn(*kn, generator=g, device="cuda")
                            * 2048 ** -0.5).bfloat16(), cfg)
          for name, kn in (("wq", (2048, 2048)), ("wk", (2048, 512)),
                           ("wv", (2048, 512)), ("wo", (2048, 2048)))}
    gain = torch.randn(2048, generator=g, device="cuda") * 0.1
    for k in (2, 4):
        c, n = k + 1, 0
        differ = {"batched": 0, "kept": 0, "norm_at_once": 0}
        pools_differ = 0
        for _ in range(16):
            pool = {name: torch.randn(25, 16, 8, 64, generator=g,
                                      device="cuda").bfloat16() for name in ("k", "v")}
            tables = torch.randperm(24, generator=g, device="cuda").reshape(4, 6) + 1
            start = torch.randint(32, 80 - c, (4,), generator=g, device="cuda")
            x = torch.randn(4, c, 2048, generator=g, device="cuda").bfloat16()
            seq = {name: t.clone() for name, t in pool.items()}
            rows = []
            for i in range(c):
                out, seq = attn.paged_decode_attention(tp, x[:, i:i + 1], seq, tables,
                                                       start + i, spec)
                rows.append(out[:, 0])
            kept, ver = attn.paged_verify_attention(
                tp, x, {name: t.clone() for name, t in pool.items()}, tables, start,
                torch.full((4,), 80, device="cuda"), spec)
            batched = _verify_batched(torch, tp, x, {name: t.clone() for name, t in
                                                     pool.items()}, tables, start, spec)
            at_once = layers.rms_norm(x, gain)
            for i in range(c):
                n += 4
                differ["kept"] += _rows_that_differ(torch, kept[:, i], rows[i])
                differ["batched"] += _rows_that_differ(torch, batched[:, i], rows[i])
                differ["norm_at_once"] += _rows_that_differ(
                    torch, at_once[:, i],
                    layers.rms_norm(x[:, i:i + 1].contiguous(), gain)[:, 0])
            pools_differ += sum(int(not torch.equal(ver[name], seq[name]))
                                for name in ("k", "v"))
        log({"what": f"verify attention, k = {k}: against {c} sequential decode "
                     "steps, 4 slots, tiled_csc bf16", "rows": n,
             "rows_that_differ_batched_core": differ["batched"],
             "rows_that_differ_kept": differ["kept"], "pools_that_differ": pools_differ,
             "rms_norm_rows_that_differ_at_once": differ["norm_at_once"]})


def _differing(torch, trace, tokens, model, params) -> list[dict]:
    from repro_torch.serving import static_generate

    differ = []
    with torch.inference_mode():
        for req in trace:
            want = static_generate(model, params, req)
            got = tokens[req.rid]
            if got != want:
                differ.append({"rid": req.rid, "prompt": len(req.tokens),
                               "first_token": next(i for i, (a, b) in
                                                   enumerate(zip(got, want)) if a != b)})
    return differ


def invariance_engine(torch) -> None:
    """chip_smoke.py's engine runs against static_generate."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from repro_torch.launch import serve

    cells = {}
    for cell in ("tiled_csc", "block_csr"):
        argv, sod = cs.CELLS[cell][:2]
        model, params, tokens, *_ = serve.prepare(serve.parse_args(argv), sod)
        cells[cell] = {"model": model, "params": params, "tokens": tokens}
    for run, (cell, chunk) in cs.ENGINE_RUNS.items():
        argv = cs.ENGINE_ARGV + (["--prefill-chunk", str(chunk)] if chunk else [])
        sl = cells[cell]
        summary = serve.main(argv, prepared=(sl["model"], sl["params"], sl["tokens"]))
        log({"what": "engine vs static_generate", "run": run,
             "requests": len(summary["trace"]),
             "requests_that_differ": _differing(torch, summary["trace"],
                                                summary["tokens"], sl["model"],
                                                sl["params"])})
    spec_args = serve.parse_args(cs.SPEC_ARGV)
    drafts = {cell: serve.prepare_draft(spec_args, cells[cell]["model"])[0]
              for cell in cells}
    for run, (cell, _, _) in cs.FEATURE_RUNS.items():
        out = cs.feature_run(run, cells, drafts)
        log({"what": "engine vs static_generate", "run": run,
             "requests": len(out["trace"]),
             "requests_that_differ": _differing(torch, out["trace"], out["tokens"],
                                                cells[cell]["model"],
                                                cells[cell]["params"])})


def dispatch(torch, args) -> None:
    """Host µs of one dispatch of a packed matmul at decode."""
    from repro_torch.core.formats import pack_tiled_csc
    from repro_torch.core.pruning import magnitude_prune
    from repro_torch.kernels import ops, registry

    # the record serve.main keeps: a count per impl, or in a tree without
    # one, the full record that tree's serve.main kept
    record = getattr(registry, "count_dispatches", registry.record_dispatches)
    g = torch.Generator().manual_seed(0)
    for name, (k, n) in LAYOUTS.items():
        w = pack_tiled_csc(magnitude_prune(torch.randn(k, n, generator=g), 0.3))
        row = {"src": str(args.src), "what": "dispatch, host us a call",
               "layout": name, "k": k, "n": n, "m": 4}
        for case, hint, rec in (("no_record", None, False),
                                ("serve_record", None, True),
                                ("serve_record_plan_hint", {"bm": 8}, True)):
            def call():
                key = registry.problem_key(w, m=4, backend="cuda")
                ops.resolve(key, "auto", fallback_params=hint)

            blocks = []
            for _ in range(DISPATCH_BLOCKS):
                with record() if rec else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    for _ in range(DISPATCH_CALLS):
                        call()
                    blocks.append((time.perf_counter() - t0) / DISPATCH_CALLS * 1e6)
            us = statistics.median(blocks)
            row[f"{case}_us"] = us
            row[f"{case}_ms_a_step"] = us * STEP_CALLS / 1e3
        log(row)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("prefill", "decode", "invariance", "dispatch"))
    ap.add_argument("--src", type=pathlib.Path, default=ROOT / "src",
                    help="directory holding the repro_torch package to measure")
    ap.add_argument("--prompt-lens", type=int, nargs="+", default=[512, 2048])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    if args.what == "dispatch":
        dispatch(torch, args)
        if torch.cuda.is_available():
            log(_smi())
        log({"ok": True})
        return
    if not torch.cuda.is_available():
        raise SystemExit("serve_probe: torch.cuda.is_available() is false")
    if args.what == "invariance" and args.src.resolve() != (ROOT / "src").resolve():
        raise SystemExit("serve_probe: invariance measures this checkout only")
    smi = _smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.what == "prefill":
        prefill(torch, args)
    elif args.what == "decode":
        decode(torch, args)
    else:
        invariance_unit(torch)
        invariance_engine(torch)
    log(smi)
    log({"ok": True})


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    main()
