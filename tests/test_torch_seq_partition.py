"""The partitioned decode step over a KV cache whose sequence splits over
``model`` (the reference's ``cache_specs(seq_shard=True)``), on 8 CPU ranks,
held against the reference's own sharded decode step and against one
process.

One ``gloo`` group of 8 ranks (``tests/torch_mesh_cases.py:seq_cases``)
runs every case on a (4, 2), a (2, 4) and a (1, 8) mesh: reduced
llama3.2-1b (tiled_csc, 8 rows, a prompt of 22 and 4 greedy steps into a
48-position cache, so the steps cross the blocks' boundaries); the same
with one position a row (a (B,) ``pos`` whose rows lie in different
ranks' blocks); reduced gemma2-27b (window 64) at a 96-position cache
from a 64-token prompt, so each step's window straddles two ranks'
blocks; reduced zamba2-2.7b, its shared attention over a 16-position
cache through ``make_stepped_prefill``.  All fp32.  Beside the group, the
reference's ``make_decode_step`` runs jitted with ``in_shardings`` of its
``param_specs`` and ``cache_specs(seq_shard=True)`` on its 8-device (4, 2)
mesh in a subprocess, on the same weights and prompt (48 positions: the
cache's only dim of that size, so the reference's size rule finds the
sequence axis).

Tolerance: logits atol 5e-4 / rtol 1e-4 (``tests/test_torch_spmd.py``'s
``Y_TOL``); greedy tokens equal.  The group and the subprocess have 300 s
each.
"""
import concurrent.futures
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import sod as jsod
from repro.models.model import LM as JLM
from repro_torch import configs
from repro_torch.core import sod
from repro_torch.interop import params_from_numpy
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import LM

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
N_RANKS, GROUP_TIMEOUT_S = 8, 300
Y_TOL = dict(atol=5e-4, rtol=1e-4)
MESHES = ("4x2", "2x4", "1x8")
TP = {"4x2": 2, "2x4": 4, "1x8": 8}
SOD = dict(mode="tiled_csc", density=0.5, min_dim=64)
# name -> (arch, SoD fields or None, rows, prompt, steps, cache length, a
# row's offset from the prompt's end or None)
CASES = {
    "llama": ("llama3.2-1b", SOD, 8, 22, 4, 48, None),
    "llama_rows": ("llama3.2-1b", SOD, 8, 22, 4, 48, (0, 6, 12, 18, 18, 12, 6, 0)),
    "gemma2_window": ("gemma2-27b", None, 4, 64, 4, 96, None),
    "zamba2": ("zamba2-2.7b", None, 4, 8, 4, 16, None),
}

_REFERENCE = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core import sod
from repro.launch import steps
from repro.models.model import LM
from repro.runtime import sharding
with open(sys.argv[1], "rb") as f:
    jcfg, treedef, leaves, tokens, max_len, n_steps = pickle.load(f)
mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
model = LM(jcfg)
params = sod.sodify_params(
    jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves]), jcfg.sod)
nxt, cache = jax.jit(steps.make_prefill_step(model))(params, {"tokens": jnp.asarray(tokens)})
cache = model.grow_cache(cache, max_len)
c_specs = sharding.cache_specs(cache, jcfg, mesh, tokens.shape[0], seq_len=max_len,
                               seq_shard=True)
p_sh = sharding.to_shardings(sharding.param_specs(params, jcfg, mesh), mesh)
c_sh = sharding.to_shardings(c_specs, mesh)
params, cache = jax.device_put(params, p_sh), jax.device_put(cache, c_sh)
decode = jax.jit(steps.make_decode_step(model, mesh=mesh), in_shardings=(p_sh, c_sh, None, None),
                 out_shardings=(None, None, c_sh))
toks, logits, tok = [np.asarray(nxt)], [], nxt[:, None]
for t in range(n_steps):
    tok, lg, cache = decode(params, cache, tok, jnp.asarray(tokens.shape[1] + t))
    toks.append(np.asarray(tok[:, 0]))
    logits.append(np.asarray(lg))
np.savez(sys.argv[2], tokens=np.stack(toks), logits=np.stack(logits),
         k_spec=np.asarray([str(a) for a in c_specs["k"]]),
         k_seq_axis=np.asarray(model.cache_spec()["k"].seq))
"""


def _case(name):
    """A CASES entry as the ranks take it: the config (fp32, reduced), the
    weights (the reference's initialisation as numpy, converted), the
    prompt from a seeded numpy generator, and the steps."""
    arch, sod_fields, rows, prompt, n_steps, max_len, offsets = CASES[name]
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).with_(dtype="float32")
    cfg = configs.reduced(configs.get_config(arch)).with_(dtype="float32")
    if sod_fields:
        jcfg = jcfg.with_(sod=jsod.SoDConfig(**sod_fields))
        cfg = cfg.with_(sod=sod.SoDConfig(**sod_fields))
    np_params = jax.tree_util.tree_map(
        np.asarray, JLM(jcfg).init(jax.random.PRNGKey(list(CASES).index(name) + 40)))
    params = params_from_numpy(np_params, cfg, device="cpu")
    if sod_fields:
        params = sod.sodify_params(params, cfg.sod)
    tokens = np.random.default_rng(len(name)).integers(0, cfg.vocab, (rows, prompt))
    case = {"cfg": cfg, "params": params, "tokens": torch.from_numpy(tokens),
            "n_steps": n_steps, "max_len": max_len}
    if offsets is not None:
        case["offsets"] = torch.tensor(offsets)
    return case, (jcfg, np_params, tokens)


def _mesh_cases_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_mesh_cases", ROOT / "tests" / "torch_mesh_cases.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the group and the reference's sharded decode, and serve each
    case in one process while they run."""
    work = tmp_path_factory.mktemp("seq")
    cases, ref_in = {}, {}
    for name in CASES:
        cases[name], ref_in[name] = _case(name)
    torch.save(cases, work / "seq_cases.pt")
    jcfg, np_params, tokens = ref_in["llama"]
    leaves, treedef = jax.tree_util.tree_flatten(np_params)
    with open(work / "ref_in.pkl", "wb") as f:
        pickle.dump((jcfg, treedef, leaves, tokens, CASES["llama"][5], CASES["llama"][4]), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(work / "ref_in.pkl"),
                            str(work / "ref_out.npz")],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    serve = _mesh_cases_module()._serve
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        group = pool.submit(mesh_mod.run_ranks, N_RANKS,
                            f"{ROOT / 'tests' / 'torch_mesh_cases.py'}:seq_cases", work,
                            args=(work,), timeout=GROUP_TIMEOUT_S)
        try:
            one = {name: serve(LM(c["cfg"]), c["params"], c["tokens"], None,
                               n_steps=c["n_steps"], max_len=c["max_len"],
                               offsets=c.get("offsets"))
                   for name, c in cases.items()}
            group.result()
            _, err = ref.communicate(timeout=GROUP_TIMEOUT_S)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(work / f"seq_rank{r}.pt", weights_only=False) for r in range(N_RANKS)]
    return {"ranks": ranks, "one": one, "cases": cases,
            "ref": dict(np.load(work / "ref_out.npz"))}


def test_reference_spec_splits_the_sequence(runs):
    """The reference's ``cache_specs(seq_shard=True)`` puts ``model`` on the
    cache's sequence axis and the data axis on its rows."""
    spec = list(runs["ref"]["k_spec"])
    seq = int(runs["ref"]["k_seq_axis"])
    assert spec[seq] == "model" and spec[seq - 1] == "data"
    assert [a for a in spec if a != "None"] == ["data", "model"]


def test_partitioned_decode_matches_reference_sharded_decode(runs):
    """On (4, 2), every rank's greedy tokens equal the reference's sharded
    decode step's, its logits within Y_TOL."""
    want = runs["ref"]
    for rank in runs["ranks"]:
        got = rank["4x2"]["llama"]
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
        np.testing.assert_allclose(got["logits"].numpy(), want["logits"], **Y_TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_sequence_split_decode_matches_one_process(runs, mesh, case):
    """Every rank's greedy tokens equal one process's and its logits lie
    within Y_TOL of them."""
    one = runs["one"][case]
    for rank in runs["ranks"]:
        got = rank[mesh][case]
        torch.testing.assert_close(got["tokens"], one["tokens"], rtol=0, atol=0)
        np.testing.assert_allclose(got["logits"].numpy(), one["logits"].numpy(), **Y_TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_rank_keeps_its_block_of_positions(runs, mesh, case):
    """After the steps a rank's KV leaf is its block of the cache's
    positions (the length over ``model``), every KV head; the softmax's
    statistics crossed ranks."""
    c = runs["cases"][case]
    max_len, cfg = c["max_len"], c["cfg"]
    for rank in runs["ranks"]:
        got = rank[mesh][case]
        seq = LM(cfg).cache_spec()["k"].seq
        assert got["kv_shape"][seq] == max_len // TP[mesh]
        assert got["kv_shape"][seq + 1] == cfg.n_kv_heads
        assert got["max_len"] == max_len
        assert got["counts"]["counts"]["all-reduce"] > 0
        assert got["counts"]["counts"]["all-gather"] > 0


@pytest.mark.parametrize("length", [40, 12])
def test_decode_step_refuses_a_cache_of_another_length(length):
    """A partitioned decode step given a 48-position cache's length on
    (4, 2) takes a KV leaf of 48 positions or a rank's block of 24, and
    raises on any other (a cache of 40 positions; a block of 12, another
    cache's) rather than read a layout from its size."""
    from repro_torch.launch import steps

    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(dtype="float32")
    model = LM(cfg)
    mesh = mesh_mod.DryMesh((4, 2), ("data", "model"), rank=0)
    decode = steps.make_decode_step(model, mesh=mesh, seq_len=48)
    cache = model.init_cache(2, length, "meta")
    with pytest.raises(ValueError, match=f"{length} positions"):
        decode({}, cache, torch.zeros((8, 1), dtype=torch.long), 22)
