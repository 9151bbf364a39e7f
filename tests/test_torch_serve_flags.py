"""The port's serve driver's ``--trace`` and ``--metrics-json`` against the
JAX package's ``repro.launch.serve`` on the same reduced arguments, on the
CPU, statically and with ``--engine``: the same metric keys (the port's
engine adds three of its own), the
reference's spans and tracks (``prefill`` and ``decode_step`` on track
``serve``; the engine's) and the kernel dispatch instants, the trace named
in the summary, and no tracer left installed after a run."""
import json

import pytest

from repro import obs as jobs
from repro.launch import serve as jserve
from repro_torch import obs
from repro_torch.kernels import autotune
from repro_torch.launch import serve

BASE = ["--arch", "llama3.2-1b", "--reduced", "--sod", "tiled_csc", "--density", "0.4",
        "--batch", "2", "--prompt-len", "6", "--gen", "3"]
# the port's engine keeps its summary's three extra stats (the engine's
# step times and the logits' finiteness) among its registry's counters
PORT_EXTRAS = {"static": {}, "engine": {"counters": {"logits_finite", "step_ms_p50",
                                                      "step_ms_p99"}}}
MODES = {"static": [],
         "engine": ["--engine", "--requests", "2", "--max-slots", "2", "--page-size", "4"]}


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "tc_torch.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tc_jax.json"))
    autotune.set_cache(None)
    yield
    autotune.set_cache(None)


def _run(main, argv, tmp_path, tag):
    trace, metrics = tmp_path / f"{tag}.trace.json", tmp_path / f"{tag}.metrics.json"
    summary = main(argv + ["--trace", str(trace), "--metrics-json", str(metrics)])
    events = json.loads(trace.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    return summary, trace, events, json.loads(metrics.read_text())


def _spans(events) -> set:
    return {(str(e["tid"]), e["name"]) for e in events if e.get("ph") == "B"}


def _dispatches(events) -> list:
    return [e for e in events if e.get("ph") in ("i", "I") and e.get("cat") == "dispatch"
            and str(e["tid"]) == "kernels"]


@pytest.mark.parametrize("mode", list(MODES))
def test_trace_and_metrics_match_reference(mode, tmp_path):
    assert obs.get_tracer() is obs.NULL_TRACER
    got, trace, events, snap = _run(serve.main, BASE + MODES[mode] + ["--device", "cpu"],
                                    tmp_path, "port")
    assert got["trace"] == str(trace)
    assert obs.get_tracer() is obs.NULL_TRACER
    want, _, ref_events, ref_snap = _run(jserve.main, BASE + MODES[mode], tmp_path, "ref")
    assert jobs.get_tracer() is jobs.NULL_TRACER
    for part in ("counters", "gauges", "histograms"):
        assert set(snap[part]) == set(ref_snap[part]) | PORT_EXTRAS[mode].get(part, set()), part
    assert _spans(events) == _spans(ref_events)
    if mode == "static":
        assert {("serve", "prefill"), ("serve", "decode_step")} <= _spans(events)
        assert snap["counters"]["generated_tokens"] == 2 * 3
        assert snap["histograms"]["decode_step_s"]["count"] == 3
        decode = [e for e in events if e["name"] == "decode_step" and e["ph"] == "B"]
        assert [e["args"]["t"] for e in decode] == [0, 1, 2]
    else:
        assert len(got["request_trace"]) == 2
        assert snap["counters"]["completed"] == ref_snap["counters"]["completed"] == 2
    assert _dispatches(events) and _dispatches(ref_events)
    assert sum(got["kernel_dispatch"].values()) == len(_dispatches(events))


def test_a_second_run_starts_without_a_tracer(tmp_path, capsys):
    """After a traced run, the next run in the process records nothing:
    its summary has no ``trace`` path and no tracer is installed."""
    _run(serve.main, BASE + ["--device", "cpu"], tmp_path, "first")
    summary = serve.main(BASE + ["--device", "cpu"])
    assert "trace" not in summary and obs.get_tracer() is obs.NULL_TRACER
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "trace" not in printed and printed["generated"] == 3
