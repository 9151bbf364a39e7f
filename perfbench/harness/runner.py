"""One run of one cell: set-up, window, trace, import check, the
comparison, and the result line."""
from __future__ import annotations

import json
import sys
import time

import torch

from perfbench.harness import check, devtrace, serve, spec, stats

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` (or ``modules``) that are JAX or
    the JAX package, compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def device_info(device: torch.device, mem: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": mem}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": mem}


def measure(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
            device: torch.device, t_proc0: float, *, cfg: dict | None = None,
            mix: dict | None = None, faults: tuple = (), control: bool = False,
            base=spec.BENCH_DIR) -> dict:
    """Set up, serve the window, check: the run's record (everything the
    readers, the result line and the control need).  ``cfg`` and ``mix``
    replace the cell's (the tests' small sizes); the architecture and kind
    modules are found under ``base``."""
    c = spec.cell(bench, cell_name)
    cfg = cfg or spec.config(bench, c["config"])
    mix = mix or spec.traffic(c["traffic"], base)
    arch = spec.architecture(cfg, base)
    served = serve.Served(cfg, mix, seed, seconds, device, t_proc0, faults=faults,
                          arch=arch, kind=spec.traffic_kind(mix, base))
    win = served.run(trace)
    view = serve.window_view(served, win)
    tr = None
    if served.prof is not None:
        tr = devtrace.summarize(devtrace.export_events(served.prof))
        served.prof = None
    served.free()
    picked = check.sample(view["tracks"], win["t_end"], mix["check"]["requests"], seed)
    t = time.perf_counter()
    judged = check.judge(arch, cfg, seed, picked, device, control=control)
    return {"cell": cell_name, "config": cfg, "traffic": mix, "sod": cfg["sod"],
            "seed": seed, "view": view, "split": served.split,
            "setup_s": served.split["setup_s"], "trace": tr, "window": win,
            "model": judged["model"], "matrices": judged["matrices"],
            "judged": judged, "check_s": time.perf_counter() - t,
            "device": device_info(device, win["memory_peak_bytes"])}


def result(bench: dict, rec: dict, trace: bool, limits: dict,
           judged: dict | None = None) -> dict:
    """The result line of a run: its metrics by the readers, and the
    numbers compared beside their limits.  ``judged`` replaces the
    program's reading (the control's, ``control.py``)."""
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, rec["cell"], kind):
        v = spec.metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    j = judged or rec["judged"]
    lim = limits["max_logit_gap"]["limit"]
    gap = j["max_logit_gap"]
    checks = {"max_logit_gap": {"value": gap, "limit": lim},
              "sampled_tokens": {"value": j["tokens"], "limit": limits["min_tokens"]}}
    correct = (gap is not None and gap <= lim and j["tokens"] >= limits["min_tokens"])
    view = rec["view"]
    attempted = sum(1 for tr in view["tracks"] if tr.sent <= view["t_end"]
                    and (not tr.times or tr.times[-1] >= view["t_start"]))
    out = {"correct": bool(correct), "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": dict(rec["device"])}
    if trace and rec["trace"]:
        out["device"]["busy_s"] = rec["trace"]["busy_s"]
        out["device"]["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = checks
    return out


def side_lines(rec: dict) -> list[dict]:
    """The earlier lines of a run: the set-up split, the window's counts,
    the comparison's details."""
    view = rec["view"]
    steps = view["steps"]
    plain = [1e3 * (s["t1"] - s["t0"]) for s in steps if not s["prompts"] and not s["profiled"]]
    with_prefill = [1e3 * (s["t1"] - s["t0"]) for s in steps if s["prompts"] and not s["profiled"]]
    lines = [{"setup_split": rec["split"]},
             {"window": {"seconds": view["window_s"], "steps": len(steps),
                         "step_ms_p50_decode_only": stats.percentile(plain, 50),
                         "step_ms_p50_with_prefill": stats.percentile(with_prefill, 50),
                         "prefills": sum(len(s["prompts"]) for s in steps),
                         "requests_done": sum(1 for tr in view["tracks"] if tr.done
                                              and view["t_start"] <= tr.times[-1] <= view["t_end"]),
                         "profiled_steps": sum(1 for s in steps if s["profiled"])}}]
    j = rec["judged"]
    lines.append({"check": {k: j[k] for k in ("requests", "tokens", "max_logit_gap",
                                              "argmax_agree")} | {"seconds": rec["check_s"]}})
    return lines


def emit(bench: dict, rec: dict, trace: bool, limits: dict) -> dict:
    """Print the side lines and the result line (last on standard output),
    and each compared number beside its limit (last on standard error)."""
    out, err = sys.stdout, sys.stderr
    res = result(bench, rec, trace, limits)
    for line in side_lines(rec):
        print(json.dumps(line), file=out)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    print(json.dumps(res), file=out, flush=True)
    return res
