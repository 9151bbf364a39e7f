"""Counters, gauges, and log-bucket histograms for run-level metrics.

Copy of :mod:`repro.obs.metrics` (stdlib and numpy only), so the port imports
nothing of the reference package.

The :class:`Metrics` registry is deliberately tiny: counters are a plain
insertion-ordered dict (so an existing ``stats`` dict can migrate onto
it via :meth:`Metrics.stats_view` without changing any key, value type,
or arithmetic), gauges are last-write-wins, and histograms use fixed
log-spaced buckets so percentile queries are O(buckets) with bounded
relative error.

Nothing here imports outside the stdlib; see ``docs/observability.md``
for the metric glossary.
"""

from __future__ import annotations

import bisect
import math
from collections.abc import MutableMapping
from typing import Any

# Bucket edges grow by 2**(1/8) ≈ 1.09 per bucket, bounding the relative
# error of an interpolated percentile to roughly half a bucket (~5%).
_GROWTH = 2.0 ** 0.125


class Histogram:
    """Fixed log-bucket histogram of non-negative samples.

    Buckets span ``[0, lo)`` then log-spaced edges from ``lo`` to at
    least ``hi`` (growth factor ``growth``); samples beyond either end
    clamp into the boundary bucket.  Percentiles interpolate linearly
    within the selected bucket and are clamped to the observed min/max,
    which keeps them within ~half a bucket width of the exact
    (numpy-style) quantile.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 growth: float = _GROWTH):
        if not (lo > 0.0 and hi > lo and growth > 1.0):
            raise ValueError("need 0 < lo < hi and growth > 1")
        edges = [0.0, lo]
        while edges[-1] < hi:
            edges.append(edges[-1] * growth)
        self._edges = edges
        self._counts = [0] * (len(edges) - 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        """Record one sample (negative values clamp into the first bucket)."""
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        idx = bisect.bisect_right(self._edges, v) - 1
        self._counts[min(max(idx, 0), len(self._counts) - 1)] += 1

    def percentile(self, q: float) -> float:
        """Approximate the ``q``-th percentile (0..100) of the samples."""
        if self.count == 0:
            return 0.0
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self._counts):
            if c and cum + c >= target:
                frac = (target - cum) / c
                lo_e, hi_e = self._edges[i], self._edges[i + 1]
                val = lo_e + frac * (hi_e - lo_e)
                return min(max(val, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def summary(self) -> dict[str, float]:
        """Count/mean/min/max plus p50/p90/p99 as a JSON-ready dict."""
        if self.count == 0:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {"count": self.count,
                "mean": self.total / self.count,
                "min": self.vmin,
                "max": self.vmax,
                "p50": self.percentile(50),
                "p90": self.percentile(90),
                "p99": self.percentile(99)}


class _StatsView(MutableMapping):
    """Mutable-mapping facade over a Metrics counter table.

    Behaves exactly like the dict it wraps — same keys, same value
    objects, same iteration order — so an engine can assign it to its
    ``stats`` attribute and keep every existing ``stats[...]`` read,
    write, ``update``, and ``dict(...)`` call bit-identical.
    """

    __slots__ = ("_table",)

    def __init__(self, table: dict[str, Any]):
        self._table = table

    def __getitem__(self, key):
        return self._table[key]

    def __setitem__(self, key, value):
        self._table[key] = value

    def __delitem__(self, key):
        del self._table[key]

    def __iter__(self):
        return iter(self._table)

    def __len__(self):
        return len(self._table)

    def __repr__(self):
        return repr(self._table)


class Metrics:
    """Registry of named counters, gauges, and histograms."""

    def __init__(self):
        self._counters: dict[str, Any] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str, inc: float = 1) -> None:
        """Add ``inc`` to counter ``name`` (created at 0)."""
        self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        """Set gauge ``name`` to ``value`` (last write wins)."""
        self._gauges[name] = value

    def histogram(self, name: str, **kwargs) -> Histogram:
        """Return (creating on first use) the histogram named ``name``."""
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(**kwargs)
        return h

    def observe(self, name: str, value: float) -> None:
        """Record ``value`` into histogram ``name``."""
        self.histogram(name).observe(value)

    def stats_view(self) -> _StatsView:
        """Dict-compatible live view of the counter table.

        The engine assigns this to ``self.stats`` so its pre-existing
        counter keys live in the registry while every access pattern
        stays unchanged.
        """
        return _StatsView(self._counters)

    def snapshot(self) -> dict[str, Any]:
        """JSON-ready snapshot: counters, gauges, histogram summaries."""
        return {"counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary()
                               for k, h in self._hists.items()}}
