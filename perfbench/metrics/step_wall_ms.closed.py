"""step_wall_ms.closed: mean host-clock ms of ``Engine.step()`` over the
window's steps outside the profiled sub-window (their summed wall time over
their count; the closed-loop cells).  Not the median: a step with an admission's
prefill takes about twice a decode-only one, nearly half the steps carry
one, and the median jumps between the two."""


def read(rec):
    steps = [s["t1"] - s["t0"] for s in rec["view"]["steps"] if not s["profiled"]]
    return 1e3 * sum(steps) / len(steps) if steps else None
