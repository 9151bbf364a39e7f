"""The port's fault-tolerance runner, mirroring ``tests/test_fault.py``: the
straggler watchdog, restart from a checkpoint with a replay of the failing
step, the restart budget, the checkpoint schedule — and the reference's
semantics where they are faults (``ROADMAP.md`` §C): the replay runs only
the failing step on the restored state.  The elastic re-mesh: the
survivors the reference's ``surviving_mesh`` picks, and six CPU ranks that
lose two, re-mesh, restore onto the new mesh and train on (a 240 s group)."""
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


# ---------------------------------------------------------------------------
# the elastic re-mesh
# ---------------------------------------------------------------------------
class _Dev:
    def __init__(self, i):
        self.id = i


FAILED_SETS = [(32, {3, 17}, 4), (32, set(), 4), (8, {2, 5}, 2), (8, {0, 7}, 4),
               (6, {2, 3}, 2), (16, {1, 2, 3, 4, 5}, 2), (4, {0, 1}, 4), (4, {3}, 1)]


@pytest.mark.parametrize("n,failed,model_axis", FAILED_SETS)
def test_surviving_ranks_match_reference(n, failed, model_axis):
    """The same survivors, in the same order, and the same (data', model)
    shape as the reference's mesh over devices with those ids; the same
    ``RuntimeError`` when too few survive."""
    try:
        ref = jfault.surviving_mesh([_Dev(i) for i in range(n)], failed, model_axis)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            fault.surviving_ranks(range(n), failed, model_axis)
        return
    ranks, shape = fault.surviving_ranks(range(n), failed, model_axis)
    assert ranks == [d.id for d in ref.devices.reshape(-1)]
    assert shape == tuple(ref.devices.shape) == (ref.shape["data"], ref.shape["model"])


def test_elastic_remesh_restore_and_step(tmp_path):
    """Six CPU ranks, (3, 2), two mesh train steps, the whole state saved;
    two ranks fail; the four survivors re-mesh to (2, 2), restore onto it
    (``restore(shardings=)``) and take a step whose loss, and whole state
    after it (parameters, moments, masters, each leaf's largest difference
    against its largest magnitude), equal one process's on the same
    checkpoint within 1e-5 (fp32), its step counter exactly."""
    import pathlib

    from repro_torch import configs
    from repro_torch.core import sod
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW, AdamWConfig

    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        dtype="float32", sod=sod.SoDConfig(mode="tiled_csc", density=0.5, min_dim=64))
    gen = torch.Generator().manual_seed(3)
    params = sod.sodify_params(LM(cfg).init(gen, "cpu"), cfg.sod)
    data = SyntheticLMData(cfg, 4, 32, seed=2)
    batches = [{k: torch.as_tensor(np.asarray(v)).long() for k, v in data.batch(i).items()}
               for i in range(3)]
    torch.save({"cfg": cfg, "params": params, "batches": batches, "failed": (2, 3)},
               tmp_path / "elastic.pt")
    cases = pathlib.Path(__file__).resolve().parent / "torch_mesh_cases.py"
    ranks = mesh_mod.run_ranks(6, f"{cases}:elastic_case", tmp_path, args=(tmp_path,),
                               timeout=240)
    survivors = [r for r in ranks if not r["failed"]]
    assert [r["rank"] for r in survivors] == [0, 1, 4, 5]
    assert [r["new_rank"] for r in survivors] == [0, 1, 2, 3]
    assert all(r["shape"] == [2, 2] for r in survivors)
    assert all(r["keys"] and all(k.startswith("data=2,model=2|") for k in r["keys"])
               for r in survivors)

    model, opt = LM(cfg), AdamW(AdamWConfig(lr=1e-3))
    template = {"params": params, "opt": opt.init(params)}
    state = Checkpointer(tmp_path / "elastic_ckpt").restore(2, template)
    _, _, metrics = steps.make_train_step(model, opt)(state["params"], state["opt"], batches[2])
    for r in survivors:
        np.testing.assert_allclose(r["loss"], float(metrics["loss"]), atol=1e-5, rtol=1e-5)
    err = survivors[0]["state_err"]
    assert err.pop("step_equal") and max(err.values()) <= 1e-5, err
