#!/usr/bin/env python3
"""Static serving end to end at full width on an NVIDIA GPU, and the row
invariance that the engine's equality with static serving rests on.

    python3 scripts/serve_probe.py prefill [--src DIR] [--prompt-lens 512 2048]
                                           [--batch 4]
    python3 scripts/serve_probe.py decode [--src DIR] [--repeats 5]
    python3 scripts/serve_probe.py invariance [--skip-engine]
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
  cache's length (RMSNorm of a row alone against inside 4 rows, and every
  row of 4 at d_model 1024 and 2048, its float32 mean of squares apart;
  decode
  attention at batch 1 over ``plen + 16`` positions against batch 4 over
  80; prefill attention over the prompt against its page bucket and
  against 16-row chunks over 80 pool positions; the verify pass of k + 1
  positions against k + 1 sequential decode steps, k in {2, 4}, 4 slots,
  full width's attention layer with packed weights, with the reference's
  batched core and with the kept one, and RMSNorm at 4·(k + 1) rows at once
  against 4; the MoE block's router logits and shared gate, the two dense
  GEMMs that pick a token's experts and weight its shared expert, and its
  whole output, at
  granite-moe-1b-a400m's and qwen2-moe-a2.7b's widths: a row alone against
  inside 4 rows and inside 128, and a prompt's rows against its page bucket
  and 16-row chunks; and decode and prefill attention at their heads,
  qwen's one query head a KV head also with the query heads not doubled;
  the recurrent decode operations at zamba2-2.7b's and xlstm-125m's full
  widths, a row alone against inside 4, as the port computes them and
  with the reference's float32 sums: the Mamba2 state readout, the chunk-1
  mLSTM step, sLSTM's recurrent product and step, the dense GEMMs at
  M = batch, RMSNorm at the blocks' widths, zamba2's decode attention,
  and whole packed Mamba2 and mLSTM decode blocks),
  and (2) ``chip_smoke.py``'s engine runs
  (``ENGINE_RUNS`` and ``FEATURE_RUNS``) against ``static_generate``: the
  requests whose tokens differ (``--skip-engine`` leaves (2) out).
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
    invariance_norm_rows(torch, g)
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

    log({"what": "decode attention, batch 4 over 80 positions vs batch 1 "
                 "over plen + 16", **_decode_attention_rows(torch, g, spec)})
    log({"what": "prefill attention, prompt vs page bucket and vs 16-row "
                 "chunks over 80 positions", **_prefill_attention_rows(torch, g, spec)})
    invariance_verify(torch, g, spec)
    invariance_moe(torch, g)
    invariance_recurrent(torch, g)


def invariance_norm_rows(torch, g) -> None:
    """Every row of RMSNorm at the engine's decode shape (4, 1, d) against
    the row alone (1, 1, d), residual-stream magnitudes (N(0, 30²)), at
    d_model 1024 and 2048: the rows whose float32 mean of squares (torch's
    reduction, which ``layers.rms_norm`` no longer uses on the card) and
    whose ``layers.rms_norm`` output differ."""
    from repro_torch.models import layers

    for d in (1024, 2048):
        gain = torch.randn(d, generator=g, device="cuda") * 0.1
        x = (torch.randn(256, 4, 1, d, generator=g, device="cuda") * 30).bfloat16()
        mean_differ = norm_differ = 0
        for i in range(256):
            xf = x[i].float()
            four_mean = torch.mean(xf * xf, dim=-1)
            four = layers.rms_norm(x[i], gain)
            for r in range(4):
                one = xf[r:r + 1]
                mean_differ += int(not torch.equal(four_mean[r],
                                                   torch.mean(one * one, dim=-1)[0]))
                norm_differ += int(not torch.equal(four[r],
                                                   layers.rms_norm(x[i, r:r + 1], gain)[0]))
        log({"what": f"rms_norm d {d}, every row of (4, 1, d) vs alone", "rows": 1024,
             "float32_mean_rows_that_differ": mean_differ,
             "rms_norm_rows_that_differ": norm_differ})


def _decode_attention_rows(torch, g, spec) -> dict:
    """Decode attention rows at batch 4 over 80 cached positions against
    the same row at batch 1 over ``plen + 16`` (static serving's cache);
    with one query head a KV head, also with the query heads not doubled
    (``attention._groups`` bypassed: cuBLAS's own behaviour there)."""
    from repro_torch.models import attention as attn

    out = _decode_attention_count(torch, g, spec)
    if spec.n_heads == spec.n_kv_heads:
        groups = attn._groups
        attn._groups = lambda q: q
        try:
            out["rows_that_differ_undoubled"] = _decode_attention_count(
                torch, g, spec)["rows_that_differ"]
        finally:
            attn._groups = groups
    return out


def _decode_attention_count(torch, g, spec) -> dict:
    from repro_torch.models import attention as attn

    h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    n, differ = 0, 0
    for trial in range(64):
        q = torch.randn(4, 1, h, hd, generator=g, device="cuda").bfloat16()
        k = torch.randn(4, 80, kv, hd, generator=g, device="cuda").bfloat16()
        v = torch.randn(4, 80, kv, hd, generator=g, device="cuda").bfloat16()
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
    return {"heads": [h, kv, hd], "rows": n, "rows_that_differ": differ}


def _prefill_attention_rows(torch, g, spec) -> dict:
    """Prefill attention rows of a prompt against its page bucket and
    against 16-row chunks over the 80 positions of the pool's pages."""
    from repro_torch.models import attention as attn

    h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    n, d_bucket, d_chunk = 0, 0, 0
    for plen in range(33, 65, 3):
        bucket = -(-plen // 16) * 16
        q = torch.randn(1, 80, h, hd, generator=g, device="cuda").bfloat16()
        k = torch.randn(1, 80, kv, hd, generator=g, device="cuda").bfloat16()
        v = torch.randn(1, 80, kv, hd, generator=g, device="cuda").bfloat16()
        bare = attn.chunked_attention(q[:, :plen], k[:, :plen], v[:, :plen], spec)
        padded = attn.chunked_attention(q[:, :bucket], k[:, :bucket],
                                        v[:, :bucket], spec)[:, :plen]
        # a 16-row chunk against the 80 gathered positions, as the pool's
        # (paged_prefill_attention's core)
        grp = h // kv
        qh = attn._groups(q.reshape(1, 80, kv, grp, hd))
        gp = qh.shape[3]
        pos = torch.arange(80, device="cuda")
        outs = []
        for start in range(0, plen, 16):
            idx = start + torch.arange(16, device="cuda")
            mask = (pos[None, :] <= idx[:, None])[None, None, None]
            init = (torch.full((1, kv, gp, 16), attn.NEG_INF, device="cuda"),
                    torch.zeros((1, kv, gp, 16), device="cuda"),
                    torch.zeros((1, kv, gp, 16, hd), device="cuda"))
            _, l, acc = attn._online_block(
                init, attn._block_scores(qh[:, start:start + 16], k, spec), v, mask)
            out = (acc / torch.clamp(l, min=1e-30)[..., None])[:, :, :grp]
            outs.append(out.permute(0, 3, 1, 2, 4).reshape(1, 16, h, hd))
        chunked = torch.cat(outs, dim=1)[:, :plen].to(q.dtype)
        n += plen
        d_bucket += _rows_that_differ(torch, bare[0], padded[0])
        d_chunk += _rows_that_differ(torch, bare[0], chunked[0])
    return {"heads": [h, kv, hd], "rows": n, "rows_that_differ_bucket": d_bucket,
            "rows_that_differ_chunks": d_chunk}


# MoE widths: (d_model, real experts, padded experts, top-k, expert d_ff,
# shared d_ff, attention heads / KV heads / head dim)
MOE_WIDTHS = {"granite-moe-1b-a400m": (1024, 32, 32, 8, 512, 0, (16, 8, 64)),
              "qwen2-moe-a2.7b": (2048, 60, 64, 4, 1408, 5632, (16, 16, 128))}


def invariance_moe(torch, g) -> None:
    """At granite-moe-1b-a400m's and qwen2-moe-a2.7b's widths: rows whose
    bits change with the rows beside them, at the shapes the engine
    compares with static serving, of the router logits and the shared gate
    (bf16 activations, float32 weights as ``init_moe`` makes them), of the
    whole MoE block (seeded weights, the shared expert packed tiled_csc at
    0.3 as the serving cells pack it; a token alone against inside 4, 64
    and 128 tokens), and of decode and prefill attention at the configs'
    heads."""
    from repro_torch.core.sod import SoDConfig, pack_param
    from repro_torch.models import attention as attn
    from repro_torch.models import moe

    for arch, (d, e, e_pad, top_k, d_ff, d_shared, heads) in MOE_WIDTHS.items():
        spec = moe.MoESpec(n_experts=e, n_experts_padded=e_pad, top_k=top_k, d_model=d,
                           d_ff=d_ff, n_shared=int(d_shared > 0), d_shared_ff=d_shared)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        params = moe.init_moe(gen, spec, torch.bfloat16, torch.device("cuda"))
        if d_shared:
            sod = SoDConfig(mode="tiled_csc", density=0.3, min_dim=64)
            params["shared"] = {k: pack_param(w, sod) for k, w in params["shared"].items()}
        fns = {"router": lambda xt: moe.router_logits(params, xt, spec),
               "block": lambda xt: moe.moe_mlp(params, xt[None], spec)[0][0]}
        if d_shared:
            fns["shared_gate"] = lambda xt: moe.shared_gate(params, xt)
        x = torch.randn(256, 4, d, generator=g, device="cuda").bfloat16()
        prompts = torch.randn(64, d, generator=g, device="cuda").bfloat16()
        for name, fn in fns.items():
            alone = torch.cat([fn(x[i, :1]) for i in range(256)])
            four = torch.stack([fn(x[i])[0] for i in range(256)])
            wide = torch.stack([fn(x.reshape(-1, d)[4 * i:4 * i + 128])[0]
                                for i in range(0, 224)])
            n = d_bucket = d_chunk = 0
            for plen in range(33, 65, 3):
                bucket = -(-plen // 16) * 16
                bare = fn(prompts[:plen])
                chunks = torch.cat([fn(prompts[s:s + 16]) for s in range(0, plen, 16)])
                n += plen
                d_bucket += _rows_that_differ(torch, bare, fn(prompts[:bucket])[:plen])
                d_chunk += _rows_that_differ(torch, bare, chunks[:plen])
            log({"what": f"moe {name}, {arch}: row alone vs inside 4 and 128 rows; "
                         "prompt rows vs page bucket and 16-row chunks",
                 "d": d, "rows": 256,
                 "rows_that_differ_4": _rows_that_differ(torch, alone, four),
                 "rows_that_differ_128": _rows_that_differ(torch, alone[:224], wide),
                 "prompt_rows": n, "rows_that_differ_bucket": d_bucket,
                 "rows_that_differ_chunks": d_chunk})
        aspec = attn.AttnSpec(n_heads=heads[0], n_kv_heads=heads[1], head_dim=heads[2])
        log({"what": f"decode attention, {arch}: batch 4 over 80 positions vs batch 1 "
                     "over plen + 16", **_decode_attention_rows(torch, g, aspec)})
        log({"what": f"prefill attention, {arch}: prompt vs page bucket and vs 16-row "
                     "chunks over 80 positions", **_prefill_attention_rows(torch, g, aspec)})


@contextlib.contextmanager
def _plain_sums(torch):
    """While open, ``layers.einsum_f32`` sums in float32 on the card too:
    the reference's formulation, before the float64 repair."""
    from repro_torch.models import layers

    kept = layers.einsum_f32
    layers.einsum_f32 = lambda eq, *ops: torch.einsum(eq, *(o.float() for o in ops))
    try:
        yield
    finally:
        layers.einsum_f32 = kept


def _batch_vs_alone(torch, fn, inputs, trials: int = 64) -> int:
    """Rows of ``fn`` at batch 4 (of 4 · ``trials``) whose bits differ from
    the same row run alone; ``inputs()`` draws one batch of 4 (a tuple of
    tensors or tuples of tensors, batch first), ``fn`` returns a tensor or
    a tuple of them, batch first."""
    def rows(out, r):
        outs = out if isinstance(out, tuple) else (out,)
        return [o[r:r + 1] for o in outs]

    def take(a, r):
        return tuple(take(t, r) for t in a) if isinstance(a, tuple) else a[r:r + 1]

    differ = 0
    for _ in range(trials):
        args = inputs()
        four = fn(*args)
        for r in range(4):
            one = fn(*(take(a, r) for a in args))
            differ += int(any(not torch.equal(a, b)
                              for a, b in zip(rows(four, r), rows(one, 0))))
    return differ


# the recurrent families' full widths: zamba2-2.7b's Mamba2 block (d_model,
# d_inner, d_state, heads of 64) and shared attention heads; xlstm-125m's
# mLSTM (d_model, d_inner, heads of 384) and sLSTM (heads of 192)
ZAMBA2 = {"d": 2560, "di": 5120, "ds": 64, "nh": 80, "hd": 64, "attn": (32, 32, 80)}
XLSTM = {"d": 768, "di": 1536, "nh": 4, "hd": 384, "s_hd": 192}


def invariance_recurrent(torch, g) -> None:
    """At zamba2-2.7b's and xlstm-125m's full widths, every row of the
    recurrent decode operations at the engine's batch of 4 against the row
    alone (static serving's batch 1), each as the port computes it and
    with ``layers.einsum_f32`` summing in float32 (``plain``: the
    reference's sums where the port repairs them, in sLSTM's recurrence,
    fault C8): the Mamba2 state readout (a sum over
    d_state), the chunk-1 mLSTM step (sums over its 384-wide heads),
    sLSTM's recurrent product (a GEMM with M = batch), the dense GEMMs at
    M = batch (sLSTM's ``x @ w_gates``, mLSTM's ``w_if``, Mamba2's ``w_b``,
    ``w_c``, ``w_dt``), RMSNorm at the blocks' widths, zamba2's decode
    attention (32 / 32 heads of 80: one query head a KV head, also with the
    query heads not doubled), and the whole Mamba2 and mLSTM decode blocks
    on seeded weights packed tiled_csc at 0.3."""
    from repro_torch.core.sod import SoDConfig, pack_param
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import layers, ssm, xlstm

    dev = "cuda"

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    z, xl = ZAMBA2, XLSTM
    mamba = ssm.MambaSpec(d_model=z["d"], d_state=z["ds"], headdim=z["hd"])
    xspec = xlstm.XLSTMSpec(d_model=xl["d"], n_heads=xl["nh"])
    sod = SoDConfig(mode="tiled_csc", density=0.3, min_dim=64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    mp = ssm.init_mamba(gen, mamba, torch.bfloat16, torch.device(dev))
    mp = {k: pack_param(w, sod) if k in ("w_z", "w_x", "out_proj") else w
          for k, w in mp.items()}
    xp = xlstm.init_mlstm(gen, xspec, torch.bfloat16, torch.device(dev))
    xp = {k: pack_param(w, sod) if k in ("w_up", "wq", "wk", "wv", "w_down") else w
          for k, w in xp.items()}
    sp = xlstm.init_slstm(gen, xspec, torch.bfloat16, torch.device(dev))

    def mamba_state():
        return {"ssm": randn(4, z["nh"], z["ds"], z["hd"]),
                "conv": {"x": randn(4, 3, z["di"], dtype=torch.bfloat16),
                         "b": randn(4, 3, z["ds"], dtype=torch.bfloat16),
                         "c": randn(4, 3, z["ds"], dtype=torch.bfloat16)}}

    def mlstm_state():
        return (randn(4, xl["nh"], xl["hd"], xl["hd"], scale=0.1),
                randn(4, xl["nh"], xl["hd"]), randn(4, xl["nh"]))

    def slstm_state():
        return tuple(randn(4, xl["nh"], xl["s_hd"]) for _ in range(3)) + (
            randn(4, xl["nh"], xl["s_hd"]),)

    def mamba_block(x, st):
        out, new = ssm.mamba_decode_step(
            mp, x, {"ssm": st[0], "conv": dict(zip("xbc", st[1:]))}, mamba)
        return out, new["ssm"]

    def mamba_inputs():
        st = mamba_state()
        return (randn(4, 1, z["d"], dtype=torch.bfloat16),
                (st["ssm"], *st["conv"].values()))

    def mlstm_block(x, st):
        c, n, m, conv = st
        out, new = xlstm.mlstm_block(xp, x, xspec, cache={"c": c, "n": n, "m": m,
                                                         "conv": conv}, decode=True)
        return out, new["c"], new["n"]

    ops_ = {
        "mamba state readout, einsum bs,bhsp->bhp": (
            lambda c, st: torch.einsum("bs,bhsp->bhp", c, st),
            lambda: (randn(4, z["ds"]), randn(4, z["nh"], z["ds"], z["hd"]))),
        "mlstm chunk-1 step (sums over head dim 384)": (
            lambda q, k, v, li, lf, st: xlstm.mlstm_chunked(q, k, v, li, lf, 1, st)[0],
            lambda: (randn(4, 1, xl["nh"], xl["hd"], dtype=torch.bfloat16),
                     randn(4, 1, xl["nh"], xl["hd"], dtype=torch.bfloat16),
                     randn(4, 1, xl["nh"], xl["hd"], dtype=torch.bfloat16),
                     randn(4, 1, xl["nh"]), randn(4, 1, xl["nh"]) - 3, mlstm_state())),
        "slstm recurrent einsum bhd,hde->bhe": (
            lambda h: layers.einsum_f32("bhd,hde->bhe", h, sp["r_gates"]),
            lambda: (randn(4, xl["nh"], xl["s_hd"]),)),
        "slstm step": (
            lambda x, st: xlstm.slstm_scan(sp, x, xspec, st)[1],
            lambda: (randn(4, 1, xl["d"], dtype=torch.bfloat16), slstm_state())),
        "dense x @ w_gates (M = batch, 768 x 3072)": (
            lambda x: ops.dense_matmul(x, sp["w_gates"].to(x.dtype), torch.float32),
            lambda: (randn(4, xl["d"], dtype=torch.bfloat16),)),
        "dense w_if (M = batch, 1536 x 8)": (
            lambda x: ops.dense_matmul(x, xp["w_if"].to(x.dtype), torch.float32),
            lambda: (randn(4, xl["di"], dtype=torch.bfloat16),)),
        **{f"dense {w} (M = batch, 2560 x {mp[w].shape[1]})": (
            lambda x, w=w: ops.dense_matmul(x, mp[w], x.dtype),
            lambda: (randn(4, z["d"], dtype=torch.bfloat16),)) for w in ("w_b", "w_c", "w_dt")},
        **{f"rms_norm d {d}": (
            lambda x, gain=randn(d, scale=0.1): layers.rms_norm(x, gain),
            lambda d=d: (randn(4, 1, d, scale=30, dtype=torch.bfloat16),))
           for d in (z["d"], z["di"], xl["d"], xl["di"])},
        "mamba decode block (packed)": (mamba_block, mamba_inputs),
        "mlstm decode block (packed)": (
            mlstm_block,
            lambda: (randn(4, 1, xl["d"], dtype=torch.bfloat16),
                     (*mlstm_state(), randn(4, 3, xl["di"], dtype=torch.bfloat16)))),
    }
    with torch.inference_mode():
        for what, (fn, inputs) in ops_.items():
            row = {"what": f"recurrent {what}: every row of batch 4 vs alone",
                   "rows": 4 * 64, "rows_that_differ": _batch_vs_alone(torch, fn, inputs)}
            with _plain_sums(torch):
                row["rows_that_differ_plain"] = _batch_vs_alone(torch, fn, inputs)
            log(row)
    aspec = attn.AttnSpec(n_heads=z["attn"][0], n_kv_heads=z["attn"][1],
                          head_dim=z["attn"][2])
    log({"what": "decode attention, zamba2-2.7b: batch 4 over 80 positions vs batch 1 "
                 "over plen + 16", **_decode_attention_rows(torch, g, aspec)})


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
    ap.add_argument("--skip-engine", action="store_true",
                    help="invariance: the unit measurements only, not the engine runs")
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
        if not args.skip_engine:
            invariance_engine(torch)
    log(smi)
    log({"ok": True})


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    main()
