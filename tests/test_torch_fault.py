"""The port's fault-tolerance runner, mirroring ``tests/test_fault.py``
(the elastic mesh waits for the distributed runtime): the straggler
watchdog, restart from a checkpoint with a replay of the failing step, the
restart budget, the checkpoint schedule — and the reference's semantics
where they are faults (``ROADMAP.md`` §C): the replay runs only the failing
step on the restored state."""
import numpy as np
import pytest
import torch

from repro.runtime import fault as jfault
from repro_torch.checkpoint import Checkpointer
from repro_torch.runtime import fault


def test_straggler_watchdog():
    wd = fault.StragglerWatchdog(factor=3.0, warmup=3)
    for _ in range(5):
        assert not wd.observe(1.0)
    assert wd.observe(10.0)
    assert wd.strays == 1
    assert not wd.observe(1.0)
    assert wd.strays == 0


def test_watchdog_flags_as_the_reference():
    rng = np.random.default_rng(0)
    times = list(rng.gamma(2.0, 0.5, size=60)) + [9.0, 0.5, 12.0, 11.0, 10.0]
    ours, ref = fault.StragglerWatchdog(window=8), jfault.StragglerWatchdog(window=8)
    assert [ours.observe(t) for t in times] == [ref.observe(t) for t in times]
    assert ours.strays == ref.strays


def test_resilient_runner_restarts_from_checkpoint(tmp_path):
    state = {"x": torch.zeros(())}
    ck = Checkpointer(tmp_path)
    ck.save(0, state)
    calls = {"n": 0}

    def step_fn(step):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated device failure")
        return {"loss": 1.0}

    loaded = {}
    runner = fault.ResilientRunner(
        step_fn, ck, fault.FaultConfig(ckpt_every=100, max_restarts=1),
        state_of=lambda: state, load_state=lambda s: loaded.update(s))
    res = runner.run_step(1)
    assert res.restarted and res.metrics["loss"] == 1.0
    assert "x" in loaded
    assert calls["n"] == 2


def test_resilient_runner_gives_up_after_max_restarts(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(0, {"x": torch.zeros(())})

    def bad_step(step):
        raise RuntimeError("persistent failure")

    runner = fault.ResilientRunner(
        bad_step, ck, fault.FaultConfig(max_restarts=0),
        state_of=lambda: {"x": torch.zeros(())}, load_state=lambda s: None)
    with pytest.raises(RuntimeError):
        runner.run_step(1)


def test_runner_checkpoints_on_schedule(tmp_path):
    ck = Checkpointer(tmp_path)
    state = {"x": torch.zeros(())}
    runner = fault.ResilientRunner(
        lambda step: {"loss": 0.0}, ck, fault.FaultConfig(ckpt_every=2),
        state_of=lambda: state, load_state=lambda s: None)
    for s in range(5):
        runner.run_step(s)
    ck.wait()
    assert ck.all_steps() == [0, 2, 4]


def test_persistent_straggler_forces_a_checkpoint(tmp_path, monkeypatch):
    """Three slow steps in a row force an async save at the third."""
    clock = iter([0.0, 1.0] * 4 + [0.0, 10.0] * 3)
    monkeypatch.setattr(fault, "time", type("Clock", (), {
        "perf_counter": staticmethod(lambda: next(clock))}))
    ck = Checkpointer(tmp_path)
    runner = fault.ResilientRunner(
        lambda step: {}, ck, fault.FaultConfig(ckpt_every=1000, max_strays=3),
        state_of=lambda: {"x": torch.zeros(())}, load_state=lambda s: None)
    for s in range(1, 8):
        runner.run_step(s)
    ck.wait()
    assert ck.all_steps() == [7] and runner.watchdog.strays == 0


def test_replay_runs_only_the_failing_step_on_the_restored_state(tmp_path):
    """The reference's restart: state rolls back to the checkpoint (after
    step 0) and only step 3 runs again, so steps 1-2's updates are lost."""
    state = {"x": torch.zeros(())}
    ck = Checkpointer(tmp_path)

    def step_fn(step):
        if step == 3 and not getattr(step_fn, "failed", False):
            step_fn.failed = True
            ck.wait()          # step 0's async save has committed
            raise RuntimeError("simulated device failure")
        state["x"] = state["x"] + 1
        return {"x": float(state["x"])}

    runner = fault.ResilientRunner(
        step_fn, ck, fault.FaultConfig(ckpt_every=100),
        state_of=lambda: state, load_state=state.update)
    results = [runner.run_step(s) for s in range(4)]
    assert [r.metrics["x"] for r in results] == [1.0, 2.0, 3.0, 2.0]
    assert results[-1].restarted
