"""Zero-dependency observability: tracing spans + a metrics registry.

Copy of :mod:`repro.obs` (stdlib and numpy only), so the port imports
nothing of the reference package.

The package has two halves:

* :mod:`repro_torch.obs.tracer` — a ``Tracer`` that records context-manager
  spans, instant events, and counter samples into a bounded ring buffer
  and exports Chrome trace-event JSON (loadable in Perfetto or
  ``chrome://tracing``).  A process-global tracer is installed with
  :func:`install_tracer`; the default is a no-op ``NullTracer`` so that
  instrumented code paths cost one attribute lookup when tracing is off.
* :mod:`repro_torch.obs.metrics` — a ``Metrics`` registry of counters, gauges,
  and fixed log-bucket ``Histogram`` objects with p50/p90/p99 summaries.
  ``Metrics.stats_view()`` exposes the counter table as a plain mutable
  mapping so existing ``stats`` dicts can migrate onto it unchanged.

Everything here is stdlib-only; see ``docs/observability.md`` for the
span/track taxonomy and the metric glossary.
"""

from repro_torch.obs.metrics import Histogram, Metrics
from repro_torch.obs.tracer import (
    NULL_TRACER,
    NullTracer,
    Tracer,
    get_tracer,
    install_tracer,
)

__all__ = [
    "Histogram",
    "Metrics",
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "get_tracer",
    "install_tracer",
]
