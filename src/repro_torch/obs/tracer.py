"""Monotonic-clock tracing with Chrome trace-event JSON export.

Copy of :mod:`repro.obs.tracer` (stdlib and numpy only), so the port imports
nothing of the reference package.

A :class:`Tracer` records three kinds of events into a bounded ring
buffer, each tagged with a *track* (rendered as one timeline row):

* **spans** — ``with tracer.span("decode", track="engine"): ...`` emits a
  ``B``/``E`` pair; spans nest LIFO per track.
* **instants** — ``tracer.instant(...)`` emits a zero-duration ``i``
  event (e.g. a SeqPhase transition or a kernel dispatch).
* **counters** — ``tracer.counter("pool_pages", {"free": 3, ...})``
  emits a ``C`` sample rendered as a stacked area chart.

Timestamps come from :func:`time.perf_counter_ns` (monotonic, immune to
NTP wall-clock jumps) and are stored as microseconds relative to tracer
construction, which is what the trace-event format expects in ``ts``.

:func:`Tracer.export` writes ``{"traceEvents": [...]}`` JSON loadable in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.  Any span
still open at export time is closed at the export timestamp so every
``B`` has a matching ``E``.

The module keeps a process-global tracer (default: the shared no-op
:data:`NULL_TRACER`) behind :func:`get_tracer` / :func:`install_tracer`;
instrumentation sites fetch it once and pay only a no-op method call
when tracing is disabled.
"""

from __future__ import annotations

import json
import pathlib
import threading
import time
from collections import deque
from typing import Any

_PID = "repro"


def _clean(args: dict[str, Any]) -> dict[str, Any]:
    """Coerce span args to JSON-serializable scalars (repr for the rest)."""
    out: dict[str, Any] = {}
    for k, v in args.items():
        if v is None or isinstance(v, (bool, int, float, str)):
            out[k] = v
        else:
            out[k] = repr(v)
    return out


class _NullSpan:
    """Context manager that does nothing; shared by all NullTracer spans."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: every method returns immediately.

    Installed by default so instrumented code paths cost one attribute
    lookup plus an empty call when tracing is off.  ``enabled`` is
    ``False`` so hot paths can skip building event arguments entirely.
    """

    enabled = False

    def span(self, name, track="engine", cat=None, **args):
        """Return the shared no-op context manager."""
        return _NULL_SPAN

    def begin(self, name, track="engine", cat=None, **args):
        """No-op."""

    def end(self, name=None, track="engine", cat=None):
        """No-op."""

    def instant(self, name, track="engine", cat=None, **args):
        """No-op."""

    def counter(self, name, values, track=None):
        """No-op."""

    def export(self, path):
        """No-op; returns ``None`` (there is nothing to export)."""
        return None


NULL_TRACER = NullTracer()


class _Span:
    """Context manager emitting a ``B`` on enter and ``E`` on exit."""

    __slots__ = ("_tracer", "_name", "_track", "_cat", "_args")

    def __init__(self, tracer, name, track, cat, args):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._tracer.begin(self._name, self._track, self._cat, **self._args)
        return self

    def __exit__(self, *exc):
        self._tracer.end(self._name, self._track, self._cat)
        return False


class Tracer:
    """Ring-buffer span/event recorder with Chrome trace-event export.

    ``capacity`` bounds the number of retained events (oldest dropped
    first), so long runs cannot grow memory without bound.  All methods
    are thread-safe; timestamps are monotonic microseconds relative to
    construction.
    """

    enabled = True

    def __init__(self, capacity: int = 200_000):
        self._events: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._open: dict[str, list[str]] = {}  # track -> stack of span names
        self._lock = threading.Lock()
        self._t0 = time.perf_counter_ns()

    def _ts(self) -> float:
        """Microseconds since tracer construction (monotonic clock)."""
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _emit(self, ev: dict[str, Any]) -> None:
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, track: str = "engine", cat: str | None = None,
             **args) -> _Span:
        """Return a context manager timing ``name`` on ``track``."""
        return _Span(self, name, track, cat, args)

    def begin(self, name: str, track: str = "engine", cat: str | None = None,
              **args) -> None:
        """Open a span (``B`` event) on ``track``; pair with :meth:`end`."""
        ev: dict[str, Any] = {"name": name, "ph": "B", "ts": self._ts(),
                              "pid": _PID, "tid": track}
        if cat is not None:
            ev["cat"] = cat
        if args:
            ev["args"] = _clean(args)
        with self._lock:
            self._events.append(ev)
            self._open.setdefault(track, []).append(name)

    def end(self, name: str | None = None, track: str = "engine",
            cat: str | None = None) -> None:
        """Close the innermost open span on ``track`` (``E`` event)."""
        with self._lock:
            stack = self._open.get(track)
            top = stack.pop() if stack else None
            ev: dict[str, Any] = {"name": name if name is not None else top,
                                  "ph": "E", "ts": self._ts(),
                                  "pid": _PID, "tid": track}
            if cat is not None:
                ev["cat"] = cat
            self._events.append(ev)

    def instant(self, name: str, track: str = "engine",
                cat: str | None = None, **args) -> None:
        """Emit a zero-duration instant event (``i``, thread scope)."""
        ev: dict[str, Any] = {"name": name, "ph": "i", "s": "t",
                              "ts": self._ts(), "pid": _PID, "tid": track}
        if cat is not None:
            ev["cat"] = cat
        if args:
            ev["args"] = _clean(args)
        self._emit(ev)

    def counter(self, name: str, values: dict[str, float],
                track: str | None = None) -> None:
        """Emit a counter sample (``C``); ``values`` maps series to number."""
        self._emit({"name": name, "ph": "C", "ts": self._ts(), "pid": _PID,
                    "tid": track if track is not None else name,
                    "args": {k: float(v) for k, v in values.items()}})

    def export(self, path: str | pathlib.Path) -> pathlib.Path:
        """Write Chrome trace-event JSON to ``path`` and return it.

        Spans still open at export time are closed at the current
        timestamp so the emitted file always has balanced ``B``/``E``
        pairs per track.
        """
        with self._lock:
            events = list(self._events)
            ts = self._ts()
            for track, stack in self._open.items():
                for name in reversed(stack):
                    events.append({"name": name, "ph": "E", "ts": ts,
                                   "pid": _PID, "tid": track})
        out = pathlib.Path(path)
        out.write_text(json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms"}))
        return out


_TRACER: Tracer | NullTracer = NULL_TRACER


def get_tracer() -> Tracer | NullTracer:
    """Return the process-global tracer (the no-op tracer by default)."""
    return _TRACER


def install_tracer(tracer: Tracer | None) -> Tracer | NullTracer:
    """Install ``tracer`` as the process-global tracer; ``None`` resets.

    Returns the tracer now in effect.  Call sites that construct their
    own ``Tracer`` for a run (``--trace`` flags) install it before any
    instrumented object is built and reset with ``install_tracer(None)``
    after export.
    """
    global _TRACER
    _TRACER = tracer if tracer is not None else NULL_TRACER
    return _TRACER
