"""Fault tolerance: restart from a checkpoint, straggler policy — twin of
:mod:`repro.runtime.fault`.

* **Checkpoint/restart** — the runner saves asynchronously every
  ``ckpt_every`` steps (:class:`repro_torch.checkpoint.Checkpointer`); an
  exception in a step rolls the state back to the last COMMITTED step and
  runs the failing step again.  Data is a pure function of the step
  (:mod:`repro_torch.data.pipeline`), so the replay sees the same batch.
* **Elastic re-mesh** — on the permanent loss of ranks the survivors form
  the largest (data', model) mesh with the same model axis
  (:func:`surviving_mesh`): tensor parallelism is a property of the saved
  layout, the data axis is elastic.  A restore re-places the state on it
  (``Checkpointer.restore(shardings=...)``).
* **Straggler mitigation** — a wall-clock watchdog flags steps slower than
  ``straggler_factor`` × the trailing median; after ``max_strays``
  consecutive flags the runner forces a checkpoint, so that a re-schedule
  of the slow host loses nothing.

The semantics are the reference's, its faults included (``ROADMAP.md``
§C): a checkpoint labelled N holds the state *after* step N, and a restart
replays only the failing step, so the steps between that checkpoint and
the failure are not run again.

Where the port's mesh differs from the reference's device list: a mesh is
a process group (:class:`repro_torch.launch.mesh.Mesh`), and a group with
dead members cannot be split, since creating a subgroup is collective over
the old group.  So :func:`surviving_mesh` ends the old default group on
every survivor and starts a fresh one of the survivors only, on a
``PrefixStore`` of the old group's store, each survivor's new rank its
position in the survivor list; survivors past ``data' × model`` leave.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable

import numpy as np

Params = Any

__all__ = ["FaultConfig", "surviving_ranks", "surviving_mesh", "StragglerWatchdog",
           "StepResult", "ResilientRunner"]

_REMESHES = itertools.count()


@dataclasses.dataclass
class FaultConfig:
    """Checkpoint cadence, restart budget and straggler thresholds."""

    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0
    max_strays: int = 3


def surviving_ranks(all_ranks, failed_ids, model_axis: int) -> tuple[list[int], tuple[int, int]]:
    """The survivors that form the new mesh, in order, and its (data',
    model) shape: the largest data axis ``len(alive) // model_axis``; the
    reference's choice of devices.  Raises ``RuntimeError`` when too few
    survive for one model axis."""
    alive = [int(r) for r in all_ranks if int(r) not in set(failed_ids)]
    data_axis = len(alive) // model_axis
    if data_axis < 1:
        raise RuntimeError(f"{len(alive)} survivors cannot host model axis {model_axis}")
    return alive[:data_axis * model_axis], (data_axis, model_axis)


def surviving_mesh(all_ranks, failed_ids, model_axis: int, axes=("data", "model"), *,
                   device=None):
    """Largest (data', model) mesh of the survivors, over a fresh default
    group (module docstring): called on every surviving rank, none of the
    failed ones.  Returns the new :class:`~repro_torch.launch.mesh.Mesh`, or
    None on a survivor past ``data' × model``, which is left without a
    group.  ``all_ranks`` are the old group's ranks; ``device`` defaults to
    the card."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod  # deferred: runtime over launch

    ranks, shape = surviving_ranks(all_ranks, failed_ids, model_axis)
    me = dist.get_rank()
    if me in set(int(r) for r in failed_ids):
        raise RuntimeError(f"rank {me} is among the failed ranks {sorted(failed_ids)}")
    store = dist.distributed_c10d._get_default_store()
    backend = dist.get_backend()
    dist.destroy_process_group()
    if me not in ranks:
        return None
    prefix = f"surviving_mesh/{next(_REMESHES)}/{','.join(map(str, sorted(failed_ids)))}"
    dist.init_process_group(backend, store=dist.PrefixStore(prefix, store),
                            rank=ranks.index(me), world_size=len(ranks),
                            timeout=mesh_mod.GROUP_TIMEOUT)
    return mesh_mod.Mesh(shape, axes, device or "cuda")


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
