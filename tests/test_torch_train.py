"""The port's training path against the JAX package's, and its entry point.

The reduced llama3.2-1b in float32 is initialised by the JAX model and
carried across with ``params_from_numpy``; the port prunes and packs it and
its packs are carried back into the reference's stacked tree (packing is
bit-equal, ``tests/test_torch_model.py``, ``tests/test_torch_plan.py``),
both are fed the reference's batches, and
three steps of ``make_train_step`` (AdamW, cosine schedule) run in each:
dense, ``tiled_csc`` and ``block_csr`` (density 0.3).  Tolerance: the
first step's gradients atol 1e-6 / rtol 1e-4 (float32 sums in another
order); losses rtol 1e-5; parameters after the third step atol 1e-4 /
rtol 1e-4, a tenth of one AdamW step at the learning rate of 1e-3 (AdamW
normalises each update, so where a gradient is near 0 its last bits move
the update by a part of a step).  Then the entry
point, ``launch/train.py``, as ``tests/test_system.py`` runs the
reference's, and two resumes from one checkpoint, bit-equal on the CPU.
"""
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import formats as jformats
from repro.core import sod as jsod
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch import steps as jsteps
from repro.models.model import LM as JLM
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_schedule as jcosine
from repro_torch import configs
from repro_torch.core import sod
from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.tree import PACKED_FIELDS, leaves_with_path
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import registry
from repro_torch.launch import steps, train
from repro_torch.models.model import LM
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule

B, S, STEPS = 2, 32, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced model's CPU ops gain nothing from intra-op threads (33 s
    for this file with one, 31 s with eight), and under the suite's
    parallel workers the threads of every worker contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-4


def _configs(mode):
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(dtype="float32")
    tcfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(dtype="float32")
    if mode != "dense":
        jcfg = jcfg.with_(sod=jsod.SoDConfig(mode=mode, density=0.3, min_dim=64))
        tcfg = tcfg.with_(sod=sod.SoDConfig(mode=mode, density=0.3, min_dim=64))
    return jcfg, tcfg


def _torch_batch(b):
    return {k: to_torch(np.asarray(v), "cpu").long() for k, v in b.items()}


def _train_torch(tcfg, tparams, batches):
    model = LM(tcfg)
    opt = AdamW(AdamWConfig(lr=1e-3), schedule=cosine_schedule(1e-3, 1, STEPS))
    step = steps.make_train_step(model, opt)
    state = opt.init(tparams)
    losses, params = [], tparams
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return losses, params


@functools.lru_cache(maxsize=None)
def _reference_init():
    """The JAX model's fp32 weights (as numpy) and the reference's batches,
    shared by every mode (the storage mode does not change the init)."""
    jcfg, _ = _configs("dense")
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    batches = [JData(jcfg, B, S, seed=0).batch(s) for s in range(STEPS)]
    return jax.tree_util.tree_map(np.asarray, jparams), batches


def _to_reference(tparams, np_params):
    """The reference's parameter tree with the port's packed leaves: each
    projection's per-layer packs stacked to the reference's (G, P, ...)."""
    blocks = jax.tree_util.tree_map(jnp.asarray, np_params["blocks"])
    lead = np_params["blocks"]["norm1"].shape[:2]
    layers = tparams["layers"]
    for group in ("attn", "mlp"):
        for name, w0 in layers[0][group].items():
            if not isinstance(w0, (TiledCSC, BlockCSR)):
                continue
            stacked = {}
            for f in PACKED_FIELDS[type(w0)]:
                ts = [getattr(layer[group][name], f) for layer in layers]
                stacked[f] = None if ts[0] is None else jnp.asarray(
                    np.stack([t.numpy() for t in ts]).reshape(lead + tuple(ts[0].shape)))
            if isinstance(w0, TiledCSC):
                blocks[group][name] = jformats.TiledCSC(
                    **stacked, shape=w0.shape, tile=w0.tile, qmode=w0.qmode)
            else:
                blocks[group][name] = jformats.BlockCSR(
                    **stacked, shape=w0.shape, tile=w0.tile, br=w0.br, qmode=w0.qmode)
    return {**{k: jnp.asarray(v) for k, v in np_params.items() if k != "blocks"},
            "blocks": blocks}


@pytest.fixture(scope="module", params=["dense", "tiled_csc", "block_csr"])
def runs(request):
    jcfg, tcfg = _configs(request.param)
    np_params, jbatches = _reference_init()
    tparams = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"),
                                tcfg.sod)

    # the reference's make_train_step: its jitted loss and gradients, then
    # its jitted optimizer update, on the same packs
    jmodel = JLM(jcfg)
    jp = _to_reference(tparams, np_params)
    jloss_and_grads = jax.jit(jsteps.make_loss_and_grads(jmodel))
    jopt = JAdamW(JAdamWConfig(lr=1e-3), schedule=jcosine(1e-3, 1, STEPS))
    jupdate = jax.jit(jopt.update)
    jstate, jlosses, jgrads = jopt.init(jp), [], None
    for b in jbatches:
        loss, _, grads = jloss_and_grads(jp, b)
        jgrads = grads if jgrads is None else jgrads
        jp, jstate, _ = jupdate(jp, grads, jstate)
        jlosses.append(float(loss))

    tbatches = [_torch_batch(b) for b in jbatches]
    _, _, tgrads = steps.make_loss_and_grads(LM(tcfg))(tparams, tbatches[0])
    tlosses, tp = _train_torch(tcfg, tparams, tbatches)
    return {"mode": request.param, "tcfg": tcfg, "init": tparams, "batches": tbatches,
            "jax": (jlosses, jax.tree_util.tree_map(np.asarray, jp)),
            "torch": (tlosses, tp),
            "grads": (tgrads, jax.tree_util.tree_map(
                lambda g: None if g.dtype == jax.dtypes.float0 else np.asarray(g),
                jgrads))}


def _reference_leaf(jp, layer: int, path: str):
    """The reference's array at the port's per-layer path, e.g.
    ``['attn']['wq'].vals`` of layer 3 (its blocks stacked (G, P, ...))."""
    node = jp["blocks"]
    parts = path.replace("]", "").replace("[", ".").split(".")
    for part in [p.strip("'") for p in parts if p]:
        node = getattr(node, part) if hasattr(node, part) else node[part]
    return np.asarray(node).reshape((-1,) + np.asarray(node).shape[2:])[layer]


def _assert_tree_matches(tp, jp, atol, rtol):
    """The port's per-layer tree against the reference's stacked one."""
    for name in ("embed", "final_norm"):
        np.testing.assert_allclose(tp[name].float().numpy(), jp[name], atol=atol,
                                   rtol=rtol, err_msg=name)
    for i, layer in enumerate(tp["layers"]):
        for path, leaf in leaves_with_path(layer):
            want = _reference_leaf(jp, i, path)
            if leaf.is_floating_point():
                np.testing.assert_allclose(leaf.float().numpy(), want, atol=atol,
                                           rtol=rtol, err_msg=f"layer {i} {path}")
            else:
                np.testing.assert_array_equal(leaf.numpy(), want,
                                              err_msg=f"layer {i} {path}")


def test_first_step_gradients_match_reference(runs):
    """``make_loss_and_grads`` of both packages at the initial weights; the
    port's integer leaves get None where the reference's get float0."""
    _assert_tree_matches(*runs["grads"], GRAD_ATOL, GRAD_RTOL)


def test_losses_match_reference(runs):
    np.testing.assert_allclose(runs["torch"][0], runs["jax"][0], rtol=LOSS_RTOL)


def test_params_after_three_steps_match_reference(runs):
    _assert_tree_matches(runs["torch"][1], runs["jax"][1], PARAM_ATOL, PARAM_RTOL)


PACKED = pytest.mark.parametrize("runs", ["tiled_csc", "block_csr"], indirect=True)


@PACKED
def test_training_stays_on_the_mask(runs):
    """Integer leaves are the initial pack's; padding slots stay exactly 0."""
    for before, after in zip(runs["init"]["layers"], runs["torch"][1]["layers"]):
        for group in ("attn", "mlp"):
            for name, w0 in before[group].items():
                w1 = after[group][name]
                assert isinstance(w1, (TiledCSC, BlockCSR))
                for f in PACKED_FIELDS[type(w0)]:
                    a = getattr(w0, f)
                    if a is not None and not a.is_floating_point():
                        assert torch.equal(a, getattr(w1, f)), f"{name}.{f}"
                if isinstance(w1, TiledCSC):
                    assert (w1.vals[w0.rows < 0] == 0).all()
                else:
                    assert (w1.block_vals[w0.block_ids < 0] == 0).all()


@PACKED
def test_kernel_function_step_matches_plain_step(runs):
    """One step dispatched as on the card (``registry.set_backend_override
    ("cuda")``: the format's CUDA impl, its ``autograd.Function`` with the
    wrapper's plain forward on the CPU and the analytical backward) against
    the ``torch_oracle`` step (autograd over the plain version)."""
    registry.set_backend_override("cuda")
    try:
        with registry.count_dispatches() as counts:
            lc, pc = _train_torch(runs["tcfg"], runs["init"], runs["batches"][:1])
    finally:
        registry.set_backend_override(None)
    impl = "cuda_fused" if runs["mode"] == "tiled_csc" else "cuda_block"
    assert set(counts) == {f"{impl}[prior]"}
    with registry.count_dispatches() as counts:
        lo, po = _train_torch(runs["tcfg"], runs["init"], runs["batches"][:1])
    assert set(counts) == {"torch_oracle[prior]"}
    assert lc == pytest.approx(lo, rel=1e-6)
    for (name, a), (_, b) in zip(leaves_with_path(pc), leaves_with_path(po)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


# --- launch/train.py, as tests/test_system.py runs the reference's ----------
_BASE = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu"]


def test_training_loss_decreases(tmp_path):
    summary = train.main(_BASE + [
        "--steps", "60", "--batch", "8", "--seq", "64", "--lr", "3e-3",
        "--ckpt-dir", str(tmp_path), "--log-every", "50"])
    assert summary["last_loss"] < summary["first_loss"] - 0.2
    assert summary["device"] == "cpu" and summary["kernel_launches"] == {
        "sod_matmul": 0, "block_matmul": 0, "decompress": 0}


@pytest.mark.parametrize("mode", ["tiled_csc", "block_csr"])
def test_training_with_sod_packed_params(tmp_path, mode, capsys):
    summary = train.main(_BASE + [
        "--steps", "25", "--batch", "4", "--seq", "64", "--lr", "3e-3",
        "--sod", mode, "--density", "0.3", "--ckpt-dir", str(tmp_path),
        "--log-every", "20"])
    assert all(np.isfinite(summary["losses"])) and all(np.isfinite(summary["grad_norms"]))
    assert summary["mean_last10"] < summary["first_loss"] + 0.1
    assert set(summary["kernel_dispatch"]) == {"torch_oracle[prior]"}
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["mean_last10"] == summary["mean_last10"] and "state" not in printed
    # step 0 by the schedule, 24 at the end (a straggling step may force
    # one between them: the watchdog's policy)
    saved = [c["step"] for c in summary["checkpoints"]]
    assert saved[0] == 0 and saved[-1] == 24 and saved == sorted(saved)


def test_resume_from_checkpoint(tmp_path):
    train.main(_BASE + ["--steps", "12", "--batch", "2", "--seq", "32",
                        "--ckpt-every", "5", "--ckpt-dir", str(tmp_path),
                        "--log-every", "50"])
    summary = train.main(_BASE + ["--steps", "16", "--batch", "2", "--seq", "32",
                                  "--ckpt-every", "5", "--ckpt-dir", str(tmp_path),
                                  "--resume", "--log-every", "50"])
    assert summary["steps"] == 16
    # the reference's resume: the latest checkpoint (step 11) already holds
    # step 11's update, and step 11 runs again
    assert summary["start_step"] == 11 and len(summary["losses"]) == 5


def test_two_resumes_are_bit_equal_on_the_cpu(tmp_path):
    argv = _BASE + ["--sod", "tiled_csc", "--batch", "2", "--seq", "32",
                    "--ckpt-every", "5", "--log-every", "50"]
    train.main(argv + ["--steps", "12", "--ckpt-dir", str(tmp_path / "a")])
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    runs = [train.main(argv + ["--steps", "16", "--resume",
                               "--ckpt-dir", str(tmp_path / d)]) for d in "ab"]
    assert runs[0]["losses"] == runs[1]["losses"]
    for (name, a), (_, b) in zip(leaves_with_path(runs[0]["state"]),
                                 leaves_with_path(runs[1]["state"])):
        assert torch.equal(a, b), name


def test_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("mode", ["tiled_csc", "block_csr"])
def test_remat_recomputes_each_block_and_keeps_the_gradients(mode):
    """``cfg.remat`` (on at full width): every block's forward runs again
    in the backward — twice the dispatches — and the gradients are those
    without it, bit for bit on the CPU."""
    _, tcfg = _configs(mode)
    np_params, jbatches = _reference_init()
    params = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"),
                               tcfg.sod)
    batch = _torch_batch(jbatches[0])
    out = {}
    for remat in (False, True):
        with registry.count_dispatches() as counts:
            out[remat] = steps.make_loss_and_grads(LM(tcfg.with_(remat=remat)))(
                params, batch), dict(counts)
    (l0, _, g0), c0 = out[False]
    (l1, _, g1), c1 = out[True]
    assert c1 == {k: 2 * v for k, v in c0.items()} and sum(c0.values()) == 7 * 2
    assert torch.equal(l0, l1)
    for (name, a), (_, b) in zip(leaves_with_path(g0), leaves_with_path(g1)):
        assert torch.equal(a, b), name


def test_host_slice_and_batches_match_reference():
    """``host_slice`` splits a batch's rows as the reference's does, and
    ``batches`` yields ``(step, batch(step))`` from its start step on."""
    from repro_torch.data.pipeline import SyntheticLMData

    jcfg, tcfg = _configs("dense")
    jdata, tdata = JData(jcfg, 4, 8, seed=3), SyntheticLMData(tcfg, 4, 8, seed=3)
    batch = {k: np.asarray(v) for k, v in jdata.batch(5).items()}
    for host in range(2):
        want = jdata.host_slice(batch, host, 2)
        got = tdata.host_slice(batch, host, 2)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    it = tdata.batches(start_step=7)
    for step in (7, 8):
        s, b = next(it)
        assert s == step
        for k, v in tdata.batch(step).items():
            np.testing.assert_array_equal(b[k], v)
