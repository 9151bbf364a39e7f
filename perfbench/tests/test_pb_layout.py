"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names found by name: a configuration, a mix or a metric reader is added as
a file, with no edit to one already there."""
from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from perfbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTH = re.compile(r"^(hidden_size|intermediate_size|head_size|num_experts_per_tok|"
                   r".*latent.*|.*state_size|.*projection.*|.*expansion.*|.*_dim|.*_rank)$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert bench["paths"] == ["perfbench"]
    assert bench["command"][:2] == ["python3", "perfbench/run.py"]
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/configs/") and c["name"] in used
        cfg = spec.config(bench, c["name"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)
            assert key in cfg and key in cfg["reduced"]      # the published value beside it
        assert set(cfg["reduced"]) == set(c["reduced"])
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        spec.config(bench, w["config"])
        mix = spec.traffic(w["traffic"])
        assert mix["kind"] in spec.listing("traffic", suffix=".py")
        assert mix["source"] and mix["deployment"]
        lim = spec.limits(w["name"])
        assert lim["max_logit_gap"]["lower"] < lim["max_logit_gap"]["limit"] \
            < lim["max_logit_gap"]["upper"]


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    per = {m["name"]: m for m in bench["per_layer"]}
    assert len(e2e) == len(bench["end_to_end"]) and len(per) == len(bench["per_layer"])
    assert not set(e2e) & set(per)
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for c in cells:
        reported = {m["name"] for m in spec.metrics_for(bench, c, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.metrics_for(bench, c, "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in reported
    # every kernel's roofline has a whole step's share of the peak beside it,
    # moving the same metric in the same cells
    for m in bench["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(o["workloads"])
                       for o in bench["per_layer"])


def _digest(path):
    return {p.relative_to(path).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


WAVES = '''"""waves: ``batch`` requests at once; the next batch when all are done."""
from perfbench.harness.traffic import Req, prompt_tokens, quantile_lengths


class Plan:
    def __init__(self, mix, seed, seconds, vocab):
        self.seed, self.vocab, self.sent = seed, vocab, 0
        self.lengths = quantile_lengths(mix["prompt_len"], mix["batch"]).tolist()
        self.new = mix["output_len"]

    def wave(self):
        out = [Req(self.sent + i, p, self.new) for i, p in enumerate(self.lengths)]
        self.sent += len(out)
        return out

    def prompt_lengths(self):
        return set(self.lengths)

    def tokens(self, req):
        return prompt_tokens(self.seed, req, self.vocab)


def drive(served):
    served.open_window()
    while served.in_window():
        wave = served.plan.wave()
        for r in wave:
            served.send(r)
        while served.in_window() and not all(served.tracks[r.idx].done for r in wave):
            served.step()
'''


def test_a_new_kind_of_mix_and_a_metric_are_files(tmp_path, tiny_cfg):
    """A later change adds a new kind of traffic (its generator and window
    loop), a mix of that kind and a reader as files; the harness finds
    them by name and runs the mix end to end, and no file that was there
    changes."""
    import time

    import torch

    from perfbench.harness import runner

    base = tmp_path / "perfbench"
    shutil.copytree(spec.BENCH_DIR, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(base)
    mix = {"kind": "waves", "source": "test", "batch": 3, "output_len": 6,
           "prompt_len": {"median": 20, "sigma": 0.5, "min": 8, "max": 40},
           "engine": {"max_slots": 4, "page_size": 16, "max_len": 64, "prefill_chunk": 16},
           "check": {"requests": 100}, "profile": {"start": 0.3, "seconds": 0.3}}
    (base / "traffic" / "dummy_waves.json").write_text(json.dumps(mix))
    (base / "traffic" / "waves.py").write_text(WAVES)
    (base / "metrics" / "dummy.metric.py").write_text(
        "def read(rec):\n    return rec['x'] * 2\n")
    assert "dummy_waves" in spec.listing("traffic", base)
    assert "waves" in spec.listing("traffic", base, suffix=".py")
    assert "dummy.metric" in spec.listing("metrics", base)
    assert spec.metric_reader("dummy.metric", base)({"x": 21}) == 42
    loaded = spec.traffic("dummy_waves", base)
    rec = runner.measure(spec.benchmark(), "internlm2_decode128", 2**31 + 9, 3.0, False,
                         torch.device("cpu"), time.perf_counter(), cfg=tiny_cfg, mix=loaded,
                         base=base)
    done = [tr for tr in rec["view"]["tracks"] if tr.done]
    assert len(done) >= 3 and {tr.req.max_new for tr in done} == {6}
    assert rec["judged"]["requests"] == len(done)
    # the mix's engine arguments reach the engine whole (chunked prefill)
    assert all(len(s["prompts"]) == 0 for s in rec["view"]["steps"])
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"traffic/dummy_waves.json", "traffic/waves.py",
                                        "metrics/dummy.metric.py"}


def test_every_named_file_is_found(bench):
    for kind, names in (("configs", [c["file"].rsplit("/", 1)[1][:-5] for c in bench["configs"]]),
                        ("traffic", [w["traffic"] for w in bench["workloads"]]),
                        ("limits", [w["name"] for w in bench["workloads"]]),
                        ("metrics", [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])):
        assert set(names) <= set(spec.listing(kind)), kind
