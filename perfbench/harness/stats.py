"""Exact statistics over every sample of a window (no buckets, no pieces)."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile of all ``values`` (linear between the two
    nearest ranks, numpy's default); None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def tokens_in(view: dict) -> int:
    """Output tokens stamped inside the window, of every request."""
    t0, t1 = view["t_start"], view["t_end"]
    return sum(1 for tr in view["tracks"] for t in tr.times if t0 < t <= t1)


def token_gaps(view: dict) -> list[float]:
    """Every gap between two consecutive output tokens of one request, both
    stamped inside the window (seconds)."""
    t0, t1 = view["t_start"], view["t_end"]
    gaps = []
    for tr in view["tracks"]:
        ts = [t for t in tr.times if t0 <= t <= t1]
        gaps += [b - a for a, b in zip(ts, ts[1:])]
    return gaps
