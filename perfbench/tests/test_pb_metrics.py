"""The metric arithmetic: percentiles over every sample, rates over the
whole window, and FLOPs, bytes and rooflines counted from the configuration
and the reference's pruning, never from the program's tensors."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.harness import devtrace, spec, stats, yardstick
from perfbench.harness.serve import Track
from perfbench.harness.traffic import Req
from perfbench.reference import prune


def _track(idx, times, plen=10, max_new=None):
    req = Req(idx, plen, len(times) if max_new is None else max_new)
    return Track(req, np.zeros(plen, np.int64), 0.0, list(times), [1] * len(times))


def _view(tracks, t0=10.0, t1=20.0, steps=()):
    return {"t_start": t0, "t_end": t1, "window_s": t1 - t0, "tracks": tracks,
            "steps": list(steps)}


def _rec(view, **kw):
    return {"view": view, **kw}


def test_percentile_over_every_sample():
    vals = list(np.random.default_rng(0).lognormal(size=1001))
    assert stats.percentile(vals, 95) == pytest.approx(float(np.percentile(vals, 95)))
    assert stats.percentile([], 95) is None


def test_rate_counts_every_token_of_the_window():
    """Tokens of requests still in flight at the end count; tokens before
    the window do not."""
    view = _view([_track(0, [9.0, 11.0, 12.0], max_new=3),        # done in the window
                  _track(1, [15.0, 19.0], max_new=10),             # in flight at the end
                  _track(2, [1.0, 2.0], max_new=2)])               # before the window
    assert stats.tokens_in(view) == 4
    assert spec.metric_reader("serve_tok_s")(_rec(view)) == pytest.approx(4 / 10.0)


def test_gaps_are_every_gap_of_one_request_in_the_window():
    view = _view([_track(0, [9.0, 11.0, 12.5, 13.0]), _track(1, [15.0, 19.0])])
    assert sorted(stats.token_gaps(view)) == pytest.approx([0.5, 1.5, 4.0])
    want = 1e3 * float(np.percentile([1.5, 0.5, 4.0], 95))
    assert spec.metric_reader("itl_p95_ms")(_rec(view)) == pytest.approx(want)


def test_step_wall_is_the_mean_of_unprofiled_steps():
    steps = [{"t0": 10.0 + i, "t1": 10.0 + i + d, "profiled": p, "prompts": []}
             for i, (d, p) in enumerate([(0.1, False), (0.4, False), (0.1, False), (9.0, True)])]
    rec = _rec(_view([], steps=steps))
    assert spec.metric_reader("step_wall_ms.closed")(rec) == pytest.approx(200.0)
    assert spec.metric_reader("step_wall_ms.closed")(_rec(_view([]))) is None


MODEL = yardstick.Model(layer_stored=1000, head_stored=500, n_layers=2, n_heads=4, head_dim=8)


def test_flops_of_tokens():
    assert MODEL.decode_flops(9) == 2.0 * 1500 + 4.0 * 2 * 4 * 8 * 10
    assert MODEL.prompt_flops(3) == 2.0 * 1000 * 3 + 4.0 * 2 * 4 * 8 * 6 + 2.0 * 500
    view = _view([_track(0, [9.0, 11.0, 12.0], plen=5), _track(1, [14.0], plen=7)])
    got = spec.metric_reader("serve_mfu")(_rec(view, model=MODEL))
    flops = MODEL.decode_flops(5) + MODEL.decode_flops(6) + MODEL.prompt_flops(7)
    assert got == pytest.approx(100.0 * flops / (10.0 * yardstick.PEAK_BF16_FLOPS))


TILED = {"mode": "tiled_csc", "tile": [128, 128], "br": 8}
BLOCK = {"mode": "block_csr", "tile": [128, 128], "br": 8}


def test_bytes_and_bound_of_a_call():
    m = yardstick.Matrix("w", 2048, 8192, stored=5_000_000)
    nbytes, ops = yardstick.call_work(128, m, TILED)
    assert ops == 2 * 128 * 5_000_000
    assert nbytes == 128 * 2048 * 2 + 5_000_000 * 3 + 128 * 8192 * 2
    blocks = 5_000_000 // (8 * 128)
    mb = yardstick.Matrix("w", 2048, 8192, stored=blocks * 8 * 128)
    nb, _ = yardstick.call_work(4, mb, BLOCK)
    assert nb == 4 * 2048 * 2 + mb.stored * 2 + 4 * blocks + 4 * 16 * 64 + 4 * 8192 * 2
    # decode is bound by bytes, a long prefill by operations
    assert yardstick.bound_s(nbytes, ops) == pytest.approx(nbytes / yardstick.HBM_BYTES_PER_S)
    nb2, ops2 = yardstick.call_work(8192, m, TILED)
    assert yardstick.bound_s(nb2, ops2) == pytest.approx(ops2 / yardstick.PEAK_BF16_FLOPS)


def test_stored_counts_come_from_the_reference_pruning():
    """What the yardstick counts is the seed's pruned matrix in the named
    format: the same for any tile padding the program may choose."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(256, 384, generator=g).to(torch.bfloat16)
    mag = {"prune_method": "magnitude", "density": 0.3, "br": 8, "tile": [128, 128]}
    kept = prune.prune(w, mag)
    # the k-th largest |w| and every tie with it stay (bf16 has many ties)
    assert prune.stored(kept, mag) == int(torch.count_nonzero(kept)) >= round(256 * 384 * 0.3)
    assert int(torch.count_nonzero(kept)) < round(256 * 384 * 0.31)
    blk = {"prune_method": "block", "density": 0.3, "br": 8, "tile": [128, 128]}
    kept = round((256 // 8) * (384 // 128) * 0.3)
    assert prune.stored(prune.prune(w, blk), blk) == kept * 8 * 128


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    """A sub-window of 1000 us: one decode phase of 5 rows with two matmul
    calls and a gap, one prefill of 40 tokens."""
    return [
        _event("pb:window", "user_annotation", 0, 1000),
        _event("pb:decode:5", "user_annotation", 10, 300),
        _event("void sod_matmul_kernel<128>(int)", "kernel", 20, 50),
        _event("elementwise_kernel", "kernel", 60, 20),
        _event("void sod_matmul_kernel<128>(int)", "kernel", 200, 50),
        _event("pb:prefill:40", "user_annotation", 400, 560),
        _event("void sod_matmul_kernel<64>(int)", "kernel", 410, 400),
        _event("aten::mm", "cpu_op", 850, 100),
    ]


def test_trace_busy_idle_and_breakdown():
    tr = devtrace.summarize(_trace())
    assert tr["window_s"] == pytest.approx(1000e-6)
    assert tr["busy_s"] == pytest.approx((60 + 50 + 400) * 1e-6)
    ops = dict(tr["breakdown"]["device_ops"])
    assert ops["sod_matmul_kernel"] == pytest.approx(500e-6)
    gaps = dict(tr["breakdown"]["idle_gaps"])
    assert gaps["pb:prefill / aten::mm"] == pytest.approx(190e-6)
    rec = {"trace": tr}
    assert spec.metric_reader("idle_share.closed")(rec) == pytest.approx(100.0 * (1 - 0.51))
    assert spec.metric_reader("idle_share.closed")({"trace": None}) is None
    # nothing ran on the device: nothing to read
    assert devtrace.summarize([e for e in _trace() if e["cat"] != "kernel"]) is None


def test_roofline_counts_real_rows_not_padding():
    mats = [yardstick.Matrix("a", 256, 512, 40_000), yardstick.Matrix("b", 512, 256, 40_000)]
    rec = {"trace": devtrace.summarize(_trace()), "matrices": mats, "sod": TILED}
    dec = spec.metric_reader("sod_matmul_roofline.decode")(rec)
    assert dec == pytest.approx(100.0 * yardstick.pass_bound_s(5, mats, TILED) / 100e-6)
    pre = devtrace.roofline(rec, "sod_matmul_kernel", "prefill")
    assert pre == pytest.approx(100.0 * yardstick.pass_bound_s(40, mats, TILED) / 400e-6)
    assert spec.metric_reader("block_matmul_roofline.decode")(rec) is None
    # a program that pads a decode to 128 rows moves no bound: rows are the
    # phase's real ones
    assert yardstick.pass_bound_s(5, mats, TILED) < yardstick.pass_bound_s(128, mats, TILED)
