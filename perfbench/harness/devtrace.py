"""Read the profiler's trace of the traced sub-window.

The harness marks the timeline with ``record_function`` ranges:
``pb:window`` (the whole profiled sub-window), ``pb:step``,
``pb:admission``, ``pb:prefill:<prompt tokens>``, ``pb:capacity``,
``pb:decode:<decoding rows>``, ``pb:pool`` and ``pb:harness`` (the
harness's own loop).  The engine reads each phase's result back on the
host before the next phase starts (a prefill's first token, a decode
step's tokens), so every kernel of a ``pb:prefill`` or ``pb:decode`` phase
runs after that phase starts and before the next one does: a kernel
belongs to the last phase that started before it.

From the trace this gives the device's busy time (the union of kernels,
copies and sets) against the sub-window, each phase's kernels with their
device time, the operations that took most time, and the device's idle
gaps by what the host was doing meanwhile (the innermost harness range and
the innermost host operation over the gap's middle).
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
_PHASE = re.compile(r"^pb:(prefill|decode):(\d+)$")


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        name = name.split(cut, 1)[0]
    return name.strip()[:80]


def export_events(prof) -> list[dict]:
    """The profile's Chrome trace events (written to a temporary file and
    read back, then deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _innermost(starts, spans, t, limit=400):
    """Name of the latest-starting span of ``spans`` (sorted by start) that
    covers ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - limit, -1), -1):
        s, e, name = spans[j]
        if e >= t:
            return name
    return None


def summarize(events: list[dict], top: int = 10) -> dict | None:
    """The sub-window's ``window_s``, ``busy_s``, ``phases`` (kind, rows,
    device seconds by kernel) and ``breakdown``; None without a window or
    without a device operation in it."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    # record_function ranges on the host (a copy on the device's timeline,
    # gpu_user_annotation, is left out)
    ann = [e for e in xs if str(e.get("cat", "")).lower() == "user_annotation"
           and str(e.get("name", "")).startswith("pb:")]
    win = [e for e in ann if e["name"] == "pb:window"]
    if not win:
        return None
    w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in xs if str(e.get("cat", "")).lower() in DEVICE_CATS
                 and w0 <= float(e["ts"]) < w1)
    if not dev:             # nothing ran on a device: no device reading
        return None
    marks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in ann if e["name"] != "pb:window" and w0 <= float(e["ts"]) < w1)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in xs if str(e.get("cat", "")).lower() in HOST_CATS
                  and not str(e.get("name", "")).startswith("pb:"))

    busy, gaps, cur = 0.0, [], None
    for s, e, _ in dev:
        e = min(e, w1)
        if cur is None:
            gaps.append((w0, s))
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
        gaps.append((cur[1], w1))

    phases, starts = [], []
    for s, e, name in marks:
        m = _PHASE.match(name)
        if m:
            phases.append({"kind": m.group(1), "rows": int(m.group(2)), "kernels": {}})
            starts.append(s)
    ops = collections.Counter()
    for s, e, name in dev:
        ops[short_name(name)] += (e - s) / 1e6
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0:
            k = phases[i]["kernels"]
            k[name] = k.get(name, 0.0) + (e - s) / 1e6

    m_starts = [s for s, _, _ in marks]
    h_starts = [s for s, _, _ in host]
    idle = collections.Counter()
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        mark = _innermost(m_starts, marks, mid) or "-"
        mark = _PHASE.sub(r"pb:\1", mark)
        op = _innermost(h_starts, host, mid) or "-"
        idle[f"{mark} / {op}"] += (b - a) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6, "phases": phases,
            "breakdown": {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                          "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}}


def roofline(rec: dict, kernel: str, kind: str) -> float | None:
    """Share (%) of the named kernel's device time in ``kind`` phases
    (``decode`` or ``prefill``) that the yardstick's bound accounts for:
    the summed least time of every matrix's call at the phase's real rows,
    over the kernel's summed device time.  None when the trace holds no
    such call."""
    from perfbench.harness import yardstick

    tr = rec.get("trace")
    if not tr:
        return None
    bound = busy = 0.0
    for ph in tr["phases"]:
        t = sum(v for n, v in ph["kernels"].items() if kernel in n)
        if ph["kind"] != kind or t == 0.0:
            continue
        busy += t
        bound += yardstick.pass_bound_s(ph["rows"], rec["matrices"], rec["sod"])
    return 100.0 * bound / busy if busy else None
