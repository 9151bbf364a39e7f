"""Fault tolerance: restart from a checkpoint, straggler policy — twin of
:mod:`repro.runtime.fault`.

* **Checkpoint/restart** — the runner saves asynchronously every
  ``ckpt_every`` steps (:class:`repro_torch.checkpoint.Checkpointer`); an
  exception in a step rolls the state back to the last COMMITTED step and
  runs the failing step again.  Data is a pure function of the step
  (:mod:`repro_torch.data.pipeline`), so the replay sees the same batch.
* **Straggler mitigation** — a wall-clock watchdog flags steps slower than
  ``straggler_factor`` × the trailing median; after ``max_strays``
  consecutive flags the runner forces a checkpoint, so that a re-schedule
  of the slow host loses nothing.

The semantics are the reference's, its faults included (``ROADMAP.md``
§C): a checkpoint labelled N holds the state *after* step N, and a restart
replays only the failing step, so the steps between that checkpoint and
the failure are not run again.  The elastic re-mesh (``surviving_mesh``)
waits for the distributed runtime's last slice (``ROADMAP.md`` §A).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

Params = Any

__all__ = ["FaultConfig", "StragglerWatchdog", "StepResult", "ResilientRunner"]


@dataclasses.dataclass
class FaultConfig:
    """Checkpoint cadence, restart budget and straggler thresholds."""

    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0
    max_strays: int = 3


class StragglerWatchdog:
    """Flags steps whose wall time exceeds factor × trailing median."""

    def __init__(self, factor: float = 3.0, window: int = 20, warmup: int = 3):
        self.factor = factor
        self.window = window
        self.warmup = warmup
        self.times: list[float] = []
        self.strays = 0

    def observe(self, seconds: float) -> bool:
        """Record one step's seconds; True when it straggled."""
        is_straggler = False
        if len(self.times) >= self.warmup:
            med = float(np.median(self.times[-self.window:]))
            is_straggler = seconds > self.factor * med
        self.times.append(seconds)
        self.strays = self.strays + 1 if is_straggler else 0
        return is_straggler


@dataclasses.dataclass
class StepResult:
    """One step's metrics and wall seconds; ``restarted`` after a replay."""

    step: int
    metrics: dict
    seconds: float
    restarted: bool = False


class ResilientRunner:
    """Wraps a step function with checkpoint-restart and straggler policy."""

    def __init__(self, step_fn: Callable, checkpointer, fault: FaultConfig,
                 state_of: Callable[[], Params],
                 load_state: Callable[[Params], None]):
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.fault = fault
        self.state_of = state_of
        self.load_state = load_state
        self.watchdog = StragglerWatchdog(fault.straggler_factor)
        self.restarts = 0

    def run_step(self, step: int, *args) -> StepResult:
        """Run ``step_fn(step, *args)``; on an exception restore the last
        checkpoint and run it once more (up to ``max_restarts`` in all)."""
        t0 = time.perf_counter()
        try:
            metrics = self.step_fn(step, *args)
        except Exception:
            if self.restarts >= self.fault.max_restarts:
                raise
            self.restarts += 1
            last = self.ckpt.latest_step()
            if last is None:
                raise
            self.load_state(self.ckpt.restore(last, self.state_of()))
            metrics = self.step_fn(step, *args)   # deterministic replay
            return StepResult(step, metrics, time.perf_counter() - t0, True)
        dt = time.perf_counter() - t0
        straggling = self.watchdog.observe(dt)
        if straggling and self.watchdog.strays >= self.fault.max_strays:
            # a persistent straggler: checkpoint now, so that a re-schedule
            # loses nothing (the re-schedule itself is the scheduler's job)
            self.ckpt.save(step, self.state_of(), blocking=False)
            self.watchdog.strays = 0
        if step % self.fault.ckpt_every == 0:
            self.ckpt.save(step, self.state_of(), blocking=False)
        return StepResult(step, metrics, dt)
