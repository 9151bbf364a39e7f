"""The port's SPMD execution layer on a (4, 2) ``gloo`` group of 8 CPU ranks,
held against the JAX package.

One group runs every case (``tests/torch_mesh_cases.py``: the five
partition plans of ``tests/test_spmd.py`` at their ragged shapes, BlockCSR
gradients, the int8 and codebook qmodes under the column and gather plans,
a tuned local-shard entry, SoD-FSDP, the compressed gradient reduce,
reduced llama3.2-1b's mesh ``loss_and_grads`` and ``train_step``, MoE's
all-to-all dispatch (``tests/test_spmd.py::test_moe_a2a_matches_block_dispatch``'s
setup and its t = 17 fallback), the engine on the mesh against a mesh
static decode, and a checkpoint the reference wrote restored onto the
mesh, the partitioned steps of every family on (4, 2), (2, 4) and, for
audio, the hybrid and the xLSTM, (1, 8) meshes of the same group), each rank
saving what it found.  The reference's unsharded results are computed
here from the same numpy inputs (its jnp oracle), and the reference's own
mesh (``sod_matmul_spmd`` and ``compressed_grad_allreduce`` on 8 forced
host devices) runs in a subprocess beside the group.

Tolerances: ``y`` atol 5e-4 / rtol 1e-4, gradients atol 2e-2 / rtol 1e-3
(``tests/test_spmd.py``'s); the model's loss 1e-4, its gradients 5e-2 /
5e-3 (``tests/test_spmd.py::test_sharded_grad_matches_unsharded_step``);
MoE's y 1e-5, aux 1e-6, gradients 1e-3 (``test_moe_a2a_matches_block_dispatch``'s);
the partitioned families against one process: the loss 1e-4, gradients
1e-5 / 1e-4 (``FAMILY_GRAD_TOL``; the recurrent families 1e-4 / 3e-4,
``RECURRENT_GRAD_TOL``), the state after a step 1e-5 (their moments 5e-5).
Padding slots' value gradients are exactly 0; every rank holds the same
``y``.  The group has 300 s and the reference subprocess 300 s; either
running over fails the tests.
"""
import concurrent.futures
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.core import formats as jformats
from repro.core import sod as jsod
from repro.data.pipeline import SyntheticLMData as JData
from repro.kernels import ops as jops
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models.model import LM as JLM
from repro.runtime import sod_fsdp as jfsdp
from repro_torch import configs
from repro_torch.core import formats, pruning, sod
from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.tree import PACKED_FIELDS, leaves_with_path
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import autotune, ops, registry
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim.adamw import state_dist
from repro_torch.runtime import planner, sod_fsdp, spmd

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_RANKS, GROUP_TIMEOUT_S = 8, 300
Y_TOL = dict(atol=5e-4, rtol=1e-4)
G_TOL = dict(atol=2e-2, rtol=1e-3)
STEP_LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
STEP_GRAD_TOL = dict(atol=5e-2, rtol=5e-3)
MESH = mesh_mod.AbstractMesh((4, 2), ("data", "model"))
MOE_Y_TOL, MOE_AUX_TOL = dict(atol=1e-5, rtol=0), dict(atol=1e-6, rtol=0)
MOE_G_TOL = dict(atol=1e-3, rtol=1e-3)
ROUTED_GRADS = ("w_gate", "w_up", "w_down", "router")
# test_moe_a2a_matches_block_dispatch's spec, and the t = 17 one that falls back
MOE_SPECS = {
    "a2a": dict(n_experts=8, n_experts_padded=8, top_k=2, d_model=64, d_ff=128,
                capacity_factor=8.0, dispatch_blocks=8, a2a_axis="model"),
    "t17": dict(n_experts=6, n_experts_padded=6, top_k=2, d_model=64, d_ff=128,
                a2a_axis="model"),
}

# name -> (shape, density, fmt, qmode, plan, seed), the reference test's
PRODUCTS = {
    "plan_dp": ((300, 512), 0.25, "tiled_csc", "none", "dp", 4),
    "plan_col": ((300, 512), 0.25, "tiled_csc", "none", "col", 4),
    "plan_row": ((512, 300), 0.25, "tiled_csc", "none", "row", 4),
    "plan_gather_model": ((300, 512), 0.25, "tiled_csc", "none", "gather_model", 4),
    "plan_gather_data": ((300, 512), 0.25, "tiled_csc", "none", "gather_data", 4),
    "block_col": ((256, 512), 0.3, "block_csr", "none", "col", 5),
    "int8_col": ((300, 512), 0.3, "tiled_csc", "int8", "col", 6),
    "int8_gather_model": ((300, 512), 0.3, "tiled_csc", "int8", "gather_model", 6),
    "codebook_col": ((300, 512), 0.3, "tiled_csc", "codebook", "col", 7),
    "codebook_gather_model": ((300, 512), 0.3, "tiled_csc", "codebook", "gather_model", 7),
}
PLAN_NAMES = [n for n in PRODUCTS if n.startswith("plan_")]
REF_PLANS = {
    "dp": "dict(batch_axes=('data',))",
    "col": "dict(batch_axes=('data',), col_axis='model')",
    "row": "dict(batch_axes=('data',), row_axis='model')",
    "gather_model": "dict(batch_axes=('data',), gather_axis='model')",
    "gather_data": "dict(gather_axis='data')",
}


def _dense(shape, density, fmt, seed):
    """A seeded numpy weight: Bernoulli(density) support, or block-pruned."""
    rng = np.random.default_rng(1000 + seed)
    w = (rng.standard_normal(shape) * (rng.random(shape) < density)).astype(np.float32)
    if fmt == "block_csr":
        w = pruning.block_prune(torch.from_numpy(w), density).numpy()
    return w


def _pack(w, fmt, qmode):
    """The port's pack of ``w`` (bit-equal to the reference's, as
    ``tests/test_torch_formats.py`` and ``test_torch_quantize.py`` hold)."""
    t = torch.from_numpy(w)
    p = formats.pack_block_csr(t) if fmt == "block_csr" else formats.pack_tiled_csc(t)
    return formats.quantize_packed(p, qmode)


def _to_jax(p):
    """The reference's container of the same arrays."""
    a = lambda t: None if t is None else jnp.asarray(t.numpy())
    side = dict(scale=a(p.scale), codebook=a(p.codebook), qmode=p.qmode)
    if isinstance(p, BlockCSR):
        return jformats.BlockCSR(a(p.block_vals), a(p.block_ids), a(p.tile_nnz), p.shape,
                                 p.tile, p.br, **side)
    return jformats.TiledCSC(a(p.vals), a(p.rows), p.shape, p.tile, **side)


def _jax_product(x, p):
    """The reference's unsharded y and gradients of ``sum(y ** 2)``."""
    def loss(x, p):
        return jnp.sum(jops.sod_matmul(x, p, impl="jnp") ** 2)

    y = jops.sod_matmul(x, p, impl="jnp")
    gx, gp = jax.grad(loss, argnums=(0, 1), allow_int=True)(x, p)
    out = {"y": np.asarray(y), "x": np.asarray(gx)}
    for f in ("vals", "block_vals", "scale", "codebook"):
        g = getattr(gp, f, None)
        if g is not None and g.dtype != jax.dtypes.float0:
            out[f] = np.asarray(g)
    return out


def _model_configs():
    sc = dict(mode="tiled_csc", density=0.5, min_dim=64)
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(
        dtype="float32", sod=jsod.SoDConfig(**sc))
    tcfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        dtype="float32", sod=sod.SoDConfig(**sc))
    return jcfg, tcfg


def _to_reference(tparams, np_params):
    """The reference's tree with the port's per-layer packs stacked (G, P)."""
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
            blocks[group][name] = jformats.TiledCSC(
                **stacked, shape=w0.shape, tile=w0.tile, qmode=w0.qmode)
    return {**{k: jnp.asarray(v) for k, v in np_params.items() if k != "blocks"},
            "blocks": blocks}


def _mesh_cases_module():
    """``tests/torch_mesh_cases.py`` (the ranks' bodies) as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_mesh_cases", ROOT / "tests" / "torch_mesh_cases.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _one_process(cfg, params, batch, serve=None):
    """One process's results of what ``_steps_on_mesh`` runs on the mesh
    (``serve``: its prompt, by default the batch's first 16 positions)."""
    from repro_torch.launch import steps
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import AdamW, AdamWConfig

    model = LM(cfg)
    out = {}
    for name, b in (("batch", batch), ("rows3", {k: v[:3] for k, v in batch.items()})):
        loss, metrics, grads = steps.make_loss_and_grads(model)(params, b)
        out[name] = {"loss": loss, "metrics": metrics, "grads": grads}
    opt = AdamW(AdamWConfig(lr=_mesh_cases_module().PARTITION_LR))
    p, st, metrics = steps.make_train_step(model, opt)(params, opt.init(params), batch)
    out["train"] = {"state": {"params": p, "opt": st}, "metrics": metrics}
    serve = serve or {"tokens": batch["tokens"][:, :16]}
    out["serve"] = _mesh_cases_module()._serve(model, params, serve["tokens"], None,
                                               patch_embeds=serve.get("patch_embeds"))
    return out


# the MoE, VLM, audio and recurrent families' partitioned steps (reduced,
# fp32): name -> (arch, config fields, batch rows, meshes); one arch's cases
# share weights
BOTH = ("4x2", "2x4")
FAMILIES = {
    "granite_nb1": ("granite-moe-1b-a400m", {}, 4, BOTH),
    "granite_nb4": ("granite-moe-1b-a400m", {"moe_dispatch_blocks": 4}, 4, BOTH),
    "granite_a2a": ("granite-moe-1b-a400m",
                    {"moe_dispatch_blocks": 8, "moe_a2a_axis": "model"}, 4, BOTH),
    "qwen_nb1": ("qwen2-moe-a2.7b", {}, 4, BOTH),
    "qwen_nb4": ("qwen2-moe-a2.7b", {"moe_dispatch_blocks": 4}, 4, BOTH),
    "qwen_a2a": ("qwen2-moe-a2.7b", {"moe_dispatch_blocks": 8, "moe_a2a_axis": "model"},
                 4, BOTH),
    "drop": ("granite-moe-1b-a400m", {}, 8, BOTH),
    "pixtral": ("pixtral-12b", {}, 4, BOTH),
    "musicgen": ("musicgen-medium", {}, 4, BOTH + ("1x8",)),
    # the recurrent families: at (1, 8) the Mamba2 heads split (1 a rank),
    # the attention and mLSTM heads do not (every rank runs every head)
    "zamba2": ("zamba2-2.7b", {}, 4, BOTH + ("1x8",)),
    "xlstm": ("xlstm-125m", {}, 4, BOTH + ("1x8",)),
}
RECURRENT_CASES = ("zamba2", "xlstm")
FAMILY_SEQ = 32
FAMILY_CASES = [(m, name) for name, (*_, meshes) in FAMILIES.items() for m in meshes]
MOE_CASES = [(m, name) for m, name in FAMILY_CASES
             if configs.get_config(FAMILIES[name][0]).family == "moe"]


def _drop_router(params):
    """Every layer's router as (v, -v, 0, ...): each token's logits are (a,
    -a, 0, ...), so its top 2 are one of the first two experts and, among
    the tied zeros, expert 2 (equal values in index order): all 256
    assignments of that expert, against a global capacity of 128."""
    for layer in params["layers"]:
        router = layer["moe"]["router"]
        v = router[:, 0].clone()
        router.zero_()
        router[:, 0], router[:, 1] = v, -v
    return params


# the cases whose loss the reference's own sharded program computes too
SHARDED_REFERENCE = ("granite_nb4", "zamba2")


def _family_cases(work):
    """Each FAMILIES case as the ranks take it (config, the reference's
    weights converted, a batch of the reference's pipeline, the prompt to
    serve, the meshes), and the reference's tree and batch of each
    SHARDED_REFERENCE case for its own sharded loss."""
    cases, arch_params, ref = {}, {}, {}
    for name, (arch, fields, rows, meshes) in FAMILIES.items():
        jcfg = jconfigs.reduced(jconfigs.get_config(arch)).with_(dtype="float32", **fields)
        tcfg = configs.reduced(configs.get_config(arch)).with_(dtype="float32", **fields)
        if arch not in arch_params:
            arch_params[arch] = jax.tree_util.tree_map(
                np.asarray, JLM(jcfg).init(jax.random.PRNGKey(len(arch_params) + 20)))
        np_params = arch_params[arch]
        params = params_from_numpy(np_params, tcfg, device="cpu")
        if name == "drop":
            params = _drop_router(params)
        jbatch = JData(jcfg, rows, FAMILY_SEQ, seed=2).batch(0)
        batch = {k: to_torch(np.asarray(v), "cpu") for k, v in jbatch.items()}
        batch = {k: v if v.is_floating_point() else v.long() for k, v in batch.items()}
        serve = {"tokens": batch["tokens"][:, :16]}
        if "patch_embeds" in batch:
            serve = {"tokens": batch["tokens"][:, :8], "patch_embeds": batch["patch_embeds"]}
        cases[name] = (tcfg, params, batch, serve, meshes)
        if name in SHARDED_REFERENCE:
            leaves, treedef = jax.tree_util.tree_flatten(
                jax.tree_util.tree_map(jnp.asarray, np_params))
            ref[name] = (jcfg, treedef, [np.asarray(a) for a in leaves],
                         {k: np.asarray(v) for k, v in jbatch.items()})
    return cases, ref


def _one_process_loss(cfg, params, batch) -> float:
    from repro_torch.launch import steps
    from repro_torch.models.model import LM

    return float(steps.make_loss_and_grads(LM(cfg))(params, batch)[0])


def _vocab_inputs(rng):
    """A tied table of 64 ids, 8 rows of 5 positions: final hidden states,
    targets, a loss mask with every third token out, ids to embed, and
    gemma-2's final soft-cap."""
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    mask = torch.ones(8, 5)
    mask.view(-1)[::3] = 0
    return {"table": f(64, 16), "h": f(8, 5, 16) * 4,
            "targets": torch.from_numpy(rng.integers(0, 64, (8, 5))), "mask": mask,
            "tokens": torch.from_numpy(rng.integers(0, 64, (8, 5))),
            "cap": configs.get_config("gemma2-27b").final_softcap}


def _one_process_vocab(case):
    from repro_torch.models import layers

    table = case["table"].clone().requires_grad_(True)
    logits = layers.lm_head(case["h"], table, True, case["cap"])
    loss = layers.cross_entropy(logits, case["targets"], case["mask"])
    loss.backward()
    return {"loss": loss.detach(), "table_grad": table.grad,
            "embed": layers.embed(case["table"], case["tokens"])}


# the dry-run's counts against a real rank: (sod mode, step kind)
DRY_CELLS = {f"{mode}_{kind}": (mode, kind) for mode in ("dense", "tiled_csc")
             for kind in ("train", "decode")}


def _dry_cell(mode, kind):
    """Reduced llama (fp32) at 8 × 32: its plan (built for rank 0 of the
    (4, 2) counting mesh), and whole concrete parameters and inputs for the
    real ranks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import LM

    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(dtype="float32")
    if mode != "dense":
        cfg = cfg.with_(sod=sod.SoDConfig(mode=mode, density=0.3))
    shape = ShapeConfig(kind, kind, 32, 8)
    dry_mesh = mesh_mod.DryMesh((4, 2), ("data", "model"), rank=0)
    plan = dryrun._plan_for_cell(cfg, shape, dry_mesh, None)
    gen = torch.Generator().manual_seed(7)
    params = LM(cfg).init(gen, "cpu")
    if plan is not None:
        params = sod.sodify_params(params, cfg.sod, plan=plan)
    toks = torch.randint(0, cfg.vocab, (8, 32 if kind == "train" else 1), generator=gen)
    inputs = ({"batch": {"tokens": toks, "targets": toks.roll(1, 1)}} if kind == "train"
              else {"cache": LM(cfg).init_cache(8, 32, "cpu"), "tokens": toks})
    return cfg, shape, plan, params, inputs


def _port_tree_in_jax(tree):
    """The port's tree with its leaves as the reference's arrays and packed
    containers (the layout a reference checkpoint of it has)."""
    if isinstance(tree, (TiledCSC, BlockCSR)):
        return _to_jax(tree)
    if isinstance(tree, dict):
        return {k: _port_tree_in_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_port_tree_in_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


def _reference_leaf(jgrads, layer: int, path: str):
    node = jgrads["blocks"]
    for part in [p.strip("'") for p in path.replace("]", "").replace("[", ".").split(".")
                 if p]:
        node = getattr(node, part) if hasattr(node, part) else node[part]
    a = np.asarray(node)
    return a.reshape((-1,) + a.shape[2:])[layer]


_REFERENCE_MESH = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core import formats
from repro.runtime import spmd, sod_fsdp
d = np.load(sys.argv[1])
mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
out = {}
for name, plan in %s.items():
    x = jnp.asarray(d[name + "_x"]); p = formats.pack_tiled_csc(jnp.asarray(d[name + "_w"]))
    def loss(x, p, plan=plan):
        y = spmd.sod_matmul_spmd(x, p, mesh=mesh, plan=spmd.SpmdPlan(**plan))
        return (y ** 2).sum(), y
    (_, y), (gx, gp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True, allow_int=True))(x, p)
    out[name + "_y"] = np.asarray(y)
    out[name + "_gx"] = np.asarray(gx); out[name + "_gvals"] = np.asarray(gp.vals)
with mesh:
    mean, resid = sod_fsdp.compressed_grad_allreduce(jnp.asarray(d["grad"]), mesh, 0.1)
out["grad_mean"] = np.asarray(mean); out["grad_resid"] = np.asarray(resid)
from repro.models import moe
for name, spec in %s.items():
    spec = moe.MoESpec(**spec)
    mp = {k: jnp.asarray(d[f"moe_{name}_{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(d[f"moe_{name}_x"])
    def mloss(p, x=x, spec=spec):
        with mesh:
            y, aux = moe.moe_mlp(p, x, spec)
        return (y ** 2).sum() + aux, (y, aux)
    (_, (y, aux)), g = jax.jit(jax.value_and_grad(mloss, has_aux=True))(mp)
    out[f"moe_{name}_y"] = np.asarray(y); out[f"moe_{name}_aux"] = np.asarray(aux)
    for k, v in g.items():
        out[f"moe_{name}_g_{k}"] = np.asarray(v)
import pickle
from repro.launch import steps as jsteps
from repro.models.model import LM as JLM
from repro.runtime import sharding as jsharding
with open(sys.argv[3], "rb") as f:
    trees = pickle.load(f)
shard = lambda specs: jsharding.to_shardings(specs, mesh)
for key, (jcfg, treedef, leaves, batch) in trees.items():
    tree = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss = jax.jit(jsteps.make_loss_and_grads(JLM(jcfg), mesh=mesh), in_shardings=(
        shard(jsharding.param_specs(tree, jcfg, mesh)),
        shard(jsharding.batch_specs(batch, mesh))))(tree, batch)[0]
    out[key] = np.asarray(loss)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Build every case, start the group and the reference's mesh, and
    compute the reference's unsharded results while they run."""
    work = tmp_path_factory.mktemp("spmd")
    rng = np.random.default_rng(0)
    products, inputs, ref_inputs = {}, {}, {}
    for name, (shape, density, fmt, qmode, plan, seed) in PRODUCTS.items():
        w = _dense(shape, density, fmt, seed)
        x = rng.standard_normal((32 if fmt == "block_csr" else 44, shape[0])).astype(np.float32)
        products[name] = (torch.from_numpy(x), _pack(w, fmt, qmode), plan)
        if name.startswith("plan_"):
            ref_inputs[f"{plan}_x"], ref_inputs[f"{plan}_w"] = x, w
    w_fsdp = _dense((1024, 1024), 0.25, "tiled_csc", 10)
    x_fsdp = rng.standard_normal((64, 1024)).astype(np.float32)
    grad = rng.standard_normal((8, 65536)).astype(np.float32)
    ref_inputs["grad"] = grad

    jcfg, tcfg = _model_configs()
    np_params = jax.tree_util.tree_map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(1)))
    tparams = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"), tcfg.sod)
    jbatch = JData(jcfg, 4, 32, seed=1).batch(0)
    tbatch = {k: to_torch(np.asarray(v), "cpu").long() for k, v in jbatch.items()}

    wu = _dense((256, 512), 0.3, "tiled_csc", 21)
    wd = _dense((512, 256), 0.3, "tiled_csc", 22)
    raw = {"blocks": {"mlp": {"w_up": torch.from_numpy(wu), "w_down": torch.from_numpy(wd)}}}
    sodc = sod.SoDConfig(mode="tiled_csc", density=0.3)
    plan = planner.build_plan(raw, sodc, cfg=configs.get_config("llama3.2-1b"), mesh=MESH,
                              m_values=(48,))
    x_planned = {n: torch.from_numpy(rng.standard_normal((48, k)).astype(np.float32))
                 for n, k in (("w_up", 256), ("w_down", 512))}
    planned = (x_planned, sod.sodify_params(raw, sodc, plan=plan), plan)
    key = jax.random.PRNGKey(11)
    moe_cases = {}
    for name, spec in MOE_SPECS.items():
        jparams = jmoe.init_moe(key, jmoe.MoESpec(**spec), jnp.float32)
        x = (jax.random.normal(jax.random.fold_in(key, 5), (4, 32, 64)) if name == "a2a"
             else jax.random.normal(key, (1, 17, 64)))
        moe_cases[name] = ({k: torch.from_numpy(np.array(v)) for k, v in jparams.items()},
                           torch.from_numpy(np.array(x)), spec)
        ref_inputs.update({f"moe_{name}_{k}": np.asarray(v) for k, v in jparams.items()})
        ref_inputs[f"moe_{name}_x"] = np.asarray(x)
    prompts = [rng.integers(0, tcfg.vocab, size=n) for n in (5, 11, 8)]
    dcfg = tcfg.with_(sod=sod.SoDConfig())
    partition = {"tiled_csc": (tcfg, tparams),
                 "dense": (dcfg, params_from_numpy(np_params, dcfg, device="cpu"))}
    vocab = _vocab_inputs(rng)
    padded = {name: (torch.from_numpy(rng.standard_normal((8, shape[0])).astype(np.float32)),
                     _pack(_dense(shape, 0.3, "tiled_csc", 30), "tiled_csc", "none"), spec)
              for name, (shape, spec) in PADDED.items()}
    jref = _to_reference(tparams, np_params)
    leaves, treedef = jax.tree_util.tree_flatten(jref)
    families, family_refs = _family_cases(work)
    with open(work / "ref_tree.pkl", "wb") as f:
        pickle.dump({"sharded_loss": (jcfg, treedef, [np.asarray(a) for a in leaves],
                                      {k: np.asarray(v) for k, v in jbatch.items()}),
                     **{f"sharded_loss_{name}": r for name, r in family_refs.items()}}, f)
    dry = {name: _dry_cell(*args) for name, args in DRY_CELLS.items()}
    JCheckpointer(work / "ref_ckpt").save(0, _port_tree_in_jax(tparams))
    torch.save({"products": products, "planned": planned, "moe": moe_cases,
                "prompts": prompts, "dry": dry,
                "tuned": _pack(_dense((256, 512), 0.3, "tiled_csc", 9), "tiled_csc", "none"),
                "fsdp": (torch.from_numpy(x_fsdp), _pack(w_fsdp, "tiled_csc", "none")),
                "grad": (torch.from_numpy(grad), 0.1),
                "cfg": tcfg, "params": tparams, "batch": tbatch,
                "partition": partition, "vocab": vocab, "padded": padded,
                "families": families}, work / "cases.pt")
    np.savez(work / "ref_in.npz", **ref_inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_MESH % ("{%s}" % ", ".join(
            f"{p!r}: {d}" for p, d in REF_PLANS.items()), repr(MOE_SPECS)),
         str(work / "ref_in.npz"), str(work / "ref_out.npz"), str(work / "ref_tree.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        group = pool.submit(mesh_mod.run_ranks, N_RANKS,
                            f"{ROOT / 'tests' / 'torch_mesh_cases.py'}:spmd_cases", work,
                            args=(work,), timeout=GROUP_TIMEOUT_S)
        try:
            want = {name: _jax_product(jnp.asarray(x.numpy()), _to_jax(w))
                    for name, (x, w, _) in products.items()}
            jloss, _, jgrads = jax.jit(jsteps.make_loss_and_grads(JLM(jcfg)))(
                _to_reference(tparams, np_params), jbatch)
            dry_mesh = mesh_mod.DryMesh((4, 2), ("data", "model"), rank=0)
            dry_found = {n: dryrun.measure(cfg, shape, dry_mesh, plan)
                         for n, (cfg, shape, plan, _, _) in dry.items()}
            one = {mode: _one_process(cfg, params, tbatch)
                   for mode, (cfg, params) in partition.items()}
            one["vocab"] = _one_process_vocab(vocab)
            one["families"] = {name: _one_process(cfg, params, batch, serve)
                               for name, (cfg, params, batch, serve, _) in families.items()}
            cfg, params, batch = families["drop"][:3]
            one["drop_nb4_loss"] = _one_process_loss(cfg.with_(moe_dispatch_blocks=4),
                                                     params, batch)
            one["padded"] = {name: _jax_product(jnp.asarray(x.numpy()), _to_jax(w))
                             for name, (x, w, _) in padded.items()}
            summary = group.result()
            _, err = ref.communicate(timeout=GROUP_TIMEOUT_S)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(N_RANKS)]
    return {"ranks": ranks, "summary": summary, "want": want, "products": products,
            "ref_mesh": dict(np.load(work / "ref_out.npz")), "w_fsdp": w_fsdp,
            "x_fsdp": x_fsdp, "grad": grad, "tparams": tparams, "planned": planned,
            "jloss": float(jloss), "jgrads": jgrads, "dry": dry_found, "one": one,
            "padded": padded}


def _np(t):
    return t.detach().float().numpy()


def _signature(plan):
    return spmd.SpmdPlan(**{
        "dp": dict(batch_axes=("data",)),
        "col": dict(batch_axes=("data",), col_axis="model"),
        "row": dict(batch_axes=("data",), row_axis="model"),
        "gather_model": dict(batch_axes=("data",), gather_axis="model"),
        "gather_data": dict(gather_axis="data")}[plan]).signature()


def _check_product(runs, name, fields):
    _, w, plan = runs["products"][name]
    want = runs["want"][name]
    got = runs["ranks"][0][name]
    np.testing.assert_allclose(_np(got["y"]), want["y"], **Y_TOL)
    for f in ("x",) + fields:
        np.testing.assert_allclose(_np(got[f]), want[f], err_msg=f"{name}: d{f}", **G_TOL)
    for r in runs["ranks"]:        # every rank holds the same y, bit for bit
        assert torch.equal(r[name]["y"], got["y"])
    assert set(got["keys"]) == {f"data=4,model=2|{_signature(plan)}"}
    assert set(got["impls"]) == {"torch_oracle"}
    return got, w


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_plans_match_unsharded_reference(runs, name):
    """Forward and gradients under every plan equal the reference's
    unsharded oracle on the same inputs; padding slots' gradients are 0."""
    got, w = _check_product(runs, name, ("vals",))
    assert torch.all(got["vals"][w.rows < 0] == 0)


def test_block_csr_grads(runs):
    got, w = _check_product(runs, "block_col", ("block_vals",))
    assert torch.all(got["block_vals"][w.block_ids < 0] == 0)


@pytest.mark.parametrize("name", [n for n in PRODUCTS if n.split("_")[0] in ("int8", "codebook")])
def test_quantized_plans(runs, name):
    side = "scale" if name.startswith("int8") else "codebook"
    _check_product(runs, name, (side,))


@pytest.mark.parametrize("name", [n for n in PRODUCTS if "gather" in n])
def test_gather_moves_the_compressed_payload(runs, name):
    """A gather plan's received bytes are the compressed payload (values,
    row indices, per-tile scale; the codebook stays) less the rank's own
    slice; the products' gathers of y are counted apart."""
    _, w, plan = runs["products"][name]
    payload = sum(t.numel() * t.element_size() for f in ("vals", "rows", "scale")
                  if (t := getattr(w, f)) is not None)
    g = MESH.shape[plan.split("_")[1]]
    for r in runs["ranks"]:
        assert r[name]["counts"]["gather_bytes"] == payload - payload // g


@pytest.mark.parametrize("plan", list(REF_PLANS))
def test_reference_mesh_agrees(runs, plan):
    """The reference's own ``sod_matmul_spmd`` on 8 forced host devices and
    the port's group give the same y and gradients."""
    ref, got = runs["ref_mesh"], runs["ranks"][3][f"plan_{plan}"]
    np.testing.assert_allclose(_np(got["y"]), ref[f"{plan}_y"], **Y_TOL)
    np.testing.assert_allclose(_np(got["x"]), ref[f"{plan}_gx"], **G_TOL)
    np.testing.assert_allclose(_np(got["vals"]), ref[f"{plan}_gvals"], **G_TOL)


def test_tuned_local_entry_feeds_mesh_dispatch(runs):
    for r in runs["ranks"]:
        t = r["tuned"]
        assert t["lookup"] == t["entry"] and t["entry"]["impl"] == "torch_oracle"
        assert t["sources"] == ["tuned"]
        assert t["keys"] == ["data=4,model=2|dp=data;col=model"]


@pytest.mark.parametrize("name,kind", [("w_up", "col=model"), ("w_down", "row=model")])
def test_planned_apply_routes_under_the_entry_plan(runs, name, kind):
    """``build_plan(mesh=)``'s entries route a bare ``sod.apply`` under the
    mesh through exactly their plan (the reference's column / row plans)."""
    x, packed, _ = runs["planned"]
    w = packed["blocks"]["mlp"][name]
    for r in runs["ranks"]:
        got = r["planned"][name]
        assert got["keys"] == [f"data=4,model=2|dp=data;{kind}"]
        np.testing.assert_allclose(_np(got["y"]), _np(x[name] @ w.to_dense()), **Y_TOL)


def _block(t, spec, coords, sizes):
    for dim, ax in enumerate(tuple(spec)[:2]):
        if ax is not None:
            size = t.shape[dim] // sizes[ax]
            t = t.narrow(dim, coords[ax] * size, size)
    return t


def test_mesh_loss_and_grads_match_unsharded_reference(runs):
    """The mesh step on each rank's resident blocks equals the reference's
    unsharded step: the loss, and each block's gradient is its slice of the
    reference's (the embedding's its vocabulary block); padding slots'
    gradients are exactly 0."""
    from repro_torch.runtime import sharding

    specs = sharding.param_specs(runs["tparams"], _model_configs()[1], MESH)
    n = 0
    for r, rank in enumerate(runs["ranks"]):
        model, coords = rank["model"], runs["summary"][r]["coords"]
        np.testing.assert_allclose(float(model["placed_loss"]), runs["jloss"],
                                   **STEP_LOSS_TOL)
        assert float(model["placed_loss"]) == float(runs["ranks"][0]["model"]["placed_loss"])
        grads = model["placed_grads"]
        for name in ("embed", "final_norm"):
            want = _block(torch.from_numpy(np.array(runs["jgrads"][name])), specs[name],
                          coords, MESH.shape)
            np.testing.assert_allclose(_np(grads[name]), want.numpy(),
                                       err_msg=name, **STEP_GRAD_TOL)
        for i, layer in enumerate(grads["layers"]):
            for path, g in leaves_with_path(layer):
                want = torch.from_numpy(_reference_leaf(runs["jgrads"], i, path)
                                        .astype(np.float32))
                node, field = path.rsplit(".", 1) if "." in path else (path, None)
                spec = specs["layers"][i]
                for part in node.replace("]", "").replace("[", " ").split():
                    spec = spec[part.strip("'")]
                want = _block(want, getattr(spec, field) if field is not None else spec,
                              coords, MESH.shape)
                np.testing.assert_allclose(_np(g), want.numpy(),
                                           err_msg=f"rank {r} layer {i} {path}",
                                           **STEP_GRAD_TOL)
                n += 1
        wq = model["placed"]["layers"][0]["attn"]["wq"]
        assert torch.all(grads["layers"][0]["attn"]["wq"].vals[wq.rows < 0] == 0)
    assert n > 0


def test_resident_blocks_are_the_specs_blocks(runs):
    """Each rank holds only the tile-grid block of each packed leaf that its
    spec names (``shard`` records where); reduced llama's ``w_gate`` and
    ``w_up`` are Nt-resident and ``w_down`` Kt-resident, and the
    partitioned step reads every block where it lies (its products' plans
    are the resident blocks'), so no rank reshards a weight."""
    from repro_torch.runtime import sharding

    specs = sharding.param_specs(runs["tparams"], _model_configs()[1], MESH)
    sharded = set()
    for r, rank in enumerate(runs["ranks"]):
        model, coords = rank["model"], runs["summary"][r]["coords"]
        for i, (layer, spec) in enumerate(zip(model["placed"]["layers"], specs["layers"])):
            for group in ("attn", "mlp"):
                for name, w in layer[group].items():
                    if not isinstance(w, TiledCSC):
                        continue
                    s = spec[group][name]
                    whole = runs["tparams"]["layers"][i][group][name]
                    if any(tuple(s.vals)[:2]):
                        sharded.add((name, tuple(s.vals)[:2]))
                        assert w.shard.shape == whole.shape and w.shard.grid == whole.grid
                    else:
                        assert w.shard is None
                    assert torch.equal(w.vals, _block(whole.vals, s.vals, coords, MESH.shape))
        assert model["placed_counts"].get("reshard_bytes", 0) == 0
    assert ("w_down", ("model", None)) in sharded and ("w_up", (None, "model")) in sharded


def test_mesh_step_under_remat(runs):
    """Checkpointed blocks (``cfg.remat``) replay the mesh products in the
    backward: the same loss and gradients as without."""
    for rank in runs["ranks"]:
        model = rank["model"]
        assert float(model["remat_loss"]) == float(model["placed_loss"])
        for (path, g), (_, g_r) in zip(leaves_with_path(model["placed_grads"]),
                                       leaves_with_path(model["remat_grads"])):
            np.testing.assert_allclose(_np(g_r), _np(g), atol=1e-6, rtol=1e-5,
                                       err_msg=path)


def test_mesh_train_step(runs):
    for r in runs["ranks"]:
        model = r["model"]
        assert np.isfinite(float(model["train_loss"]))
        packed = [(impl, key) for impl, key in model["dispatch"] if impl != "dense_ref"]
        assert packed and all(impl == "torch_oracle" and key.startswith("data=4,model=2|")
                              for impl, key in packed)


def test_sod_fsdp_matmul(runs):
    """The compressed all-gather product equals x @ W, and each rank
    receives exactly the compressed payload less its own Nt slice."""
    x, w = runs["x_fsdp"], runs["w_fsdp"]
    whole = _pack(w, "tiled_csc", "none")
    payload = whole.vals.numel() * whole.vals.element_size() + whole.rows.numel()
    for r in runs["ranks"]:
        f = r["fsdp"]
        np.testing.assert_allclose(_np(f["y"]), x @ w, **Y_TOL)
        assert f["counts"]["gather_bytes"] == payload - payload // 4
        assert f["resident_vals"].shape[1] == whole.vals.shape[1] // 4


def test_compressed_grad_allreduce_matches_reference(runs):
    ref = runs["ref_mesh"]
    for r, rank in enumerate(runs["ranks"]):
        d = runs["summary"][r]["coords"]["data"]
        np.testing.assert_allclose(_np(rank["grad"]["mean"]), ref["grad_mean"][2 * d:2 * d + 2],
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(_np(rank["grad"]["resid"]), ref["grad_resid"][2 * d:2 * d + 2],
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("qmode", ["none", "int8", "fp8", "codebook"])
def test_collective_savings_match_reference(qmode):
    assert sod_fsdp.collective_savings(0.25, ratio=0.05, qmode=qmode) == \
        jfsdp.collective_savings(0.25, ratio=0.05, qmode=qmode)


# ---------------------------------------------------------------------------
# in-process: plans, keys, tuning and the opt-outs need no ranks
# ---------------------------------------------------------------------------
def _tiled(shape, seed, density=0.3):
    return _pack(_dense(shape, density, "tiled_csc", seed), "tiled_csc", "none")


def test_auto_plan_shards_batch_and_columns():
    plan = spmd.auto_plan(MESH, _tiled((256, 512), 0))      # Nt = 4
    assert plan.batch_axes == ("data",) and plan.col_axis == "model"
    assert spmd.auto_plan(MESH, _tiled((256, 128), 1)).col_axis is None


def test_mesh_key_in_tuning_cache_key():
    p = _tiled((256, 512), 2)
    plan = spmd.auto_plan(MESH, p)
    sig = f"{spmd.mesh_key(MESH)}|{plan.signature()}"
    local = spmd._local_packed(p, MESH, plan)
    s = autotune.key_str(registry.problem_key(local, m=16, backend="cpu", mesh=sig))
    assert "mesh=data=4,model=2|dp=data;col=model" in s
    assert autotune.key_str(registry.problem_key(local, m=16, backend="cpu")) != s


def test_warmup_params_spmd_counts_local_layouts(tmp_path):
    p1, p2, p3 = _tiled((256, 512), 3), _tiled((256, 512), 4), _tiled((128, 256), 5)
    cache = autotune.TuningCache(tmp_path / "warm.json")
    stats = spmd.warmup_params_spmd({"a": p1, "b": p2, "c": p3, "dense": torch.zeros(4)},
                                    (48,), MESH, backend="cpu", cache=cache)
    assert stats["tuned"] == 2
    assert spmd.warmup_params_spmd({"a": p1, "c": p3}, (48,), MESH, backend="cpu",
                                   cache=cache) == {"tuned": 0, "cached": 2, "skipped": 0}


def test_opt_outs_respected(monkeypatch):
    """``spmd=None`` and ``REPRO_SPMD=0`` keep a product whole under a mesh
    (nothing routes, so no rank is needed)."""
    p = _tiled((256, 512), 6)
    x = torch.randn(16, 256, generator=torch.Generator().manual_seed(0))
    with spmd.use_mesh(MESH), registry.record_dispatches() as log:
        ops.sod_matmul(x, p, spmd=None)
    assert log and all(not rec["key"].mesh for rec in log)
    monkeypatch.setenv("REPRO_SPMD", "0")
    with spmd.use_mesh(MESH), registry.record_dispatches() as log2:
        ops.sod_matmul(x, p)
    assert log2 and all(not rec["key"].mesh for rec in log2)


def test_registry_mesh_roles():
    assert registry.get_impl("cuda_fused").requires_shard_map
    assert registry.get_impl("cuda_block").mesh_axes == ("data", "model")
    assert not registry.get_impl("torch_oracle").requires_shard_map


def test_resident_block_refuses_to_run_whole():
    from repro_torch.core.formats import Shard

    p = dataclasses.replace(_tiled((256, 512), 7), shard=Shard((256, 512), (2, 4), None, "model"))
    with pytest.raises(ValueError, match="resident block"):
        ops.sod_matmul(torch.zeros(4, 256), p, spmd=None)


def test_active_mesh_is_seen_by_other_threads():
    """A CUDA backward runs on autograd's device threads, which replay a
    checkpointed block's forward there: the active mesh is process-wide."""
    import threading

    seen = []
    with spmd.use_mesh(MESH):
        t = threading.Thread(target=lambda: seen.append(spmd.active_mesh()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [MESH]
    assert spmd.active_mesh() is None


# ---------------------------------------------------------------------------
# MoE's all-to-all dispatch, the engine on the mesh, restore onto the mesh
# ---------------------------------------------------------------------------
def test_moe_a2a_matches_reference_a2a(runs):
    """The port's exchange against the reference's ``shard_map`` all-to-all
    on its own 8-device mesh: y, aux and the routed experts' and router's
    gradients; every rank holds the same y and the same whole gradients."""
    ref = runs["ref_mesh"]
    for rank in runs["ranks"]:
        got = rank["moe"]["a2a"]
        np.testing.assert_allclose(_np(got["y"]), ref["moe_a2a_y"], **MOE_Y_TOL)
        np.testing.assert_allclose(float(got["aux"]), float(ref["moe_a2a_aux"]), **MOE_AUX_TOL)
        for k in ROUTED_GRADS:
            np.testing.assert_allclose(_np(got["grads"][k]), ref[f"moe_a2a_g_{k}"],
                                       err_msg=k, **MOE_G_TOL)
            assert torch.equal(got["grads"][k], runs["ranks"][0]["moe"]["a2a"]["grads"][k])
        assert torch.equal(got["y"], runs["ranks"][0]["moe"]["a2a"]["y"])


def test_moe_a2a_equals_block_dispatch(runs):
    """The exchange equals the capacity dispatch in as many blocks as token
    shards (8): y bit for bit, and the exchange really ran (each rank's
    all-to-all count: two exchanges forward, and in the backward the
    return exchange's transpose; x takes no gradient here, so the first
    exchange needs none)."""
    for rank in runs["ranks"]:
        got, block = rank["moe"]["a2a"], rank["moe"]["a2a_block"]
        assert torch.equal(got["y"], block["y"])
        assert got["counts"]["counts"]["all-to-all"] == 3 and got["counts"]["all-to-all"] > 0
        assert "all-to-all" not in block["counts"].get("counts", {})


def test_moe_a2a_falls_back_when_tokens_do_not_divide(runs):
    """17 tokens over 8 shards: both packages take the block path."""
    ref = runs["ref_mesh"]
    for rank in runs["ranks"]:
        got = rank["moe"]["t17"]
        assert "all-to-all" not in got["counts"].get("counts", {})
        np.testing.assert_allclose(_np(got["y"]), ref["moe_t17_y"], **MOE_Y_TOL)
        for k in ROUTED_GRADS:
            np.testing.assert_allclose(_np(got["grads"][k]), ref[f"moe_t17_g_{k}"],
                                       err_msg=k, **MOE_G_TOL)


def test_engine_on_mesh_equals_mesh_static_decode(runs):
    """``Engine(mesh=)`` on the placed weights: every request's tokens equal
    the mesh's static greedy decode bit for bit, on every rank, and the
    packed products ran under the mesh's keys."""
    first = runs["ranks"][0]["engine"]
    for rank in runs["ranks"]:
        got = rank["engine"]
        assert got["engine"] == got["static"] == first["engine"]
        assert got["keys"] and all(k.startswith("data=4,model=2|") for k in got["keys"])


def test_restore_onto_mesh_and_unplace(runs):
    """A checkpoint the reference wrote, restored with ``shardings=``, gives
    each rank ``place`` of the whole leaves bit for bit (resident blocks
    and their metadata); ``unplace(place(p))`` is ``p``."""
    for rank in runs["ranks"]:
        r = rank["restore"]
        assert r["restored_equal"] and r["restored_meta"]
        assert r["unplaced_equal"] and r["unplaced_meta"]
        assert r["n_sharded"] > 0


@pytest.mark.parametrize("cell", list(DRY_CELLS))
def test_dry_mesh_counts_equal_a_real_rank(runs, cell):
    """The counting mesh at rank 0 of (4, 2), on meta tensors, against rank
    0 of the real group running the same step on CPU tensors: the flops,
    every collective kind's bytes and calls, and the argument bytes."""
    dry, real = runs["dry"][cell], runs["ranks"][0]["dry"][cell]
    assert dry["cost"]["flops"] == real["cost"]["flops"] > 0
    assert dry["collectives"] == real["collectives"]
    assert dry["memory"]["argument_bytes"] == real["memory"]["argument_bytes"]
    if cell.startswith("tiled"):
        assert dry["collectives"]["total"] > 0


# ---------------------------------------------------------------------------
# the dense family's partitioned steps on (4, 2) and (2, 4)
# ---------------------------------------------------------------------------
PARTITION_CASES = [(m, mode) for m in ("4x2", "2x4") for mode in ("tiled_csc", "dense")]
# packed products whose split grid dim has a padded tail (500 of 4 tiles)
PADDED = {"padded_col": ((256, 500), (None, "model")),
          "padded_row": ((500, 256), ("model", None))}


def _assert_trees_close(got, want, what, **tol):
    pairs = list(zip(leaves_with_path(got), leaves_with_path(want)))
    assert pairs and len(pairs) == len(list(leaves_with_path(want))), what
    for (path, g), (path_w, w) in pairs:
        assert path == path_w and g.shape == w.shape, (what, path, path_w)
        np.testing.assert_allclose(_np(g), _np(w), err_msg=f"{what} {path}", **tol)


@pytest.mark.parametrize("mesh,mode", PARTITION_CASES)
def test_partitioned_loss_and_grads_match_one_process(runs, mesh, mode):
    """``loss_and_grads`` of the partitioned program on each rank's blocks
    equals one process's (fp32): the loss and its metrics on every rank,
    and every gradient after ``unplace``; on the global batch (rows over
    the data axes) and on 3 rows (which divide no data axis: every rank
    takes every row)."""
    one = runs["one"][mode]
    for name in ("batch", "rows3"):
        first = runs["ranks"][0]["partition"][mesh][mode][name]
        for rank in runs["ranks"]:
            got = rank["partition"][mesh][mode][name]
            np.testing.assert_allclose(float(got["loss"]), float(one[name]["loss"]),
                                       **STEP_LOSS_TOL)
            assert float(got["loss"]) == float(first["loss"])
            assert float(got["metrics"]["ce"]) == float(got["loss"])
            _assert_trees_close(got["grads"], one[name]["grads"], f"{mesh} {mode} {name}",
                                **STEP_GRAD_TOL)
        if mode == "tiled_csc":
            assert first["keys"] and all(k.startswith(f"data={mesh[0]},model={mesh[2]}|")
                                         for k in first["keys"])


@pytest.mark.parametrize("mesh,mode", PARTITION_CASES)
def test_partitioned_train_step_matches_one_process(runs, mesh, mode):
    """One ZeRO-1 train step (moments and masters placed by
    ``opt_state_specs``): the whole state after it (``unplace``) within
    1e-5 of one process's step, leaf by leaf, its step counter equal, and
    the loss and gradient norm the same."""
    one = runs["one"][mode]["train"]
    for rank in runs["ranks"]:
        got = rank["partition"][mesh][mode]["train"]
        assert got["zero_split"] > 0
        err = state_dist(got["state"], one["state"])
        assert err.pop("step_equal") and max(err.values()) <= 1e-5, err
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got["metrics"][k]), float(one["metrics"][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mesh,mode", PARTITION_CASES)
def test_partitioned_prefill_and_decode_match_one_process(runs, mesh, mode):
    """Prefill and four greedy decode steps through the partitioned steps
    (the cache between them the rank's rows and, tiled_csc's, its block of
    positions of every KV head; the dense weights', every position of its
    KV heads): every step's tokens equal one process's and its logits
    within the products' tolerance, on every rank."""
    one = runs["one"][mode]["serve"]
    for rank in runs["ranks"]:
        got = rank["partition"][mesh][mode]["serve"]
        assert torch.equal(got["tokens"], one["tokens"])
        np.testing.assert_allclose(_np(got["logits"]), _np(one["logits"]), **Y_TOL)


@pytest.mark.parametrize("mesh,mode", PARTITION_CASES)
def test_partitioned_decode_cache_layout(runs, mesh, mode):
    """The KV leaf (L, B, S, KV, hd) a rank keeps after the decode steps.
    tiled_csc's decode step is given the cache's length, 16 + 4 + 1
    positions rounded up to a multiple of ``model``: the rank's rows and
    its block of positions of both KV heads.  The dense weights' is given
    none, at the unrounded 21 positions: the rank's rows, every position
    and the one KV head its query heads read (``local_heads``), the
    layout where the sequence does not split."""
    d, tp = int(mesh[0]), int(mesh[2])
    rows = runs["one"][mode]["serve"]["tokens"].shape[1] // d
    n_kv = configs.reduced(configs.get_config("llama3.2-1b")).n_kv_heads
    for rank in runs["ranks"]:
        got = rank["partition"][mesh][mode]["serve"]
        if mode == "tiled_csc":
            assert got["max_len"] == -(-21 // tp) * tp
            want = (rows, got["max_len"] // tp, n_kv)
        else:
            assert got["max_len"] == 21
            want = (rows, 21, 1)
        assert got["kv_shape"][1:4] == want, (got["kv_shape"], want)


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_vocab_parallel_head_loss_and_embedding(runs, mesh):
    """The vocab-parallel tied head (gemma-2's soft-cap before the max),
    cross-entropy over a masked target and embedding, each rank on its
    vocabulary block and rows, against ``layers.lm_head`` /
    ``cross_entropy`` / ``embed`` on one process: the loss, the table's
    gradient and the embedded rows."""
    one = runs["one"]["vocab"]
    for rank in runs["ranks"]:
        got = rank["partition"][mesh]["vocab"]
        np.testing.assert_allclose(float(got["loss"]), float(one["loss"]), **STEP_LOSS_TOL)
        np.testing.assert_allclose(_np(got["table_grad"]), _np(one["table_grad"]),
                                   atol=1e-6, rtol=1e-5)
        assert torch.equal(got["embed"], one["embed"])


def test_partitioned_mesh_loss_matches_reference_sharded_loss(runs):
    """The reference's own sharded program (its step jitted with
    ``in_shardings`` from ``param_specs`` and ``batch_specs`` on its
    8-device (4, 2) mesh) and the port's partitioned step on the same
    reduced cell and weights give the same loss."""
    want = float(runs["ref_mesh"]["sharded_loss"])
    np.testing.assert_allclose(want, runs["jloss"], **STEP_LOSS_TOL)
    for rank in runs["ranks"]:
        np.testing.assert_allclose(float(rank["partition"]["4x2"]["tiled_csc"]["batch"]["loss"]),
                                   want, **STEP_LOSS_TOL)


@pytest.mark.parametrize("shape,want", [((4, 2), [(2, 0, 1), (2, 1, 1)]),
                                        ((2, 4), [(1, 0, 1), (1, 0, 1), (1, 1, 1), (1, 1, 1)]),
                                        ((2, 8), [None] * 8)])
def test_local_heads_follow_the_kv_groups(shape, want):
    """Reduced llama's 4 query heads in 2 KV groups on each ``model``
    position: (heads, first KV head, KV heads).  At model = 2 the KV heads
    divide it; at 4 they do not, and two ranks share a KV head (its K and V
    whole, narrowed); at 8 the query heads do not divide it, so every rank
    attends with every head."""
    from repro_torch.models import attention, transformer

    spec = transformer.attn_spec(configs.reduced(configs.get_config("llama3.2-1b")))
    got = []
    for r in range(shape[1]):
        mesh = mesh_mod.DryMesh(shape, ("data", "model"), rank=r)
        with spmd.use_partition(spmd.Partition(mesh, ("data",))):
            got.append(attention.local_heads(spec))
    assert got == want


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
@pytest.mark.parametrize("name", list(PADDED))
def test_local_contract_with_a_padded_split(runs, mesh, name):
    """In the partitioned program a product whose split grid dim has a
    padded tail reads it whole (the rank's rows in, every column out): y
    is the reference's rows, x's gradient its rows, and the weight's
    gradient (``unplace``d, summed over the data axes) the reference's;
    padding slots get exactly 0."""
    want = runs["one"]["padded"][name]
    d = int(mesh[0])
    for r, rank in enumerate(runs["ranks"]):
        got = rank["partition"][mesh]["padded"][name]
        data = r // (N_RANKS // d)
        rows = slice(data * 8 // d, (data + 1) * 8 // d)
        np.testing.assert_allclose(_np(got["y"]), want["y"][rows], **Y_TOL)
        np.testing.assert_allclose(_np(got["x"]), want["x"][rows], **G_TOL)
        np.testing.assert_allclose(_np(got["vals"]), want["vals"], **G_TOL)
        assert torch.all(got["vals"][runs["padded"][name][1].rows < 0] == 0)
        assert got["counts"]["calls"] > 0


# ---------------------------------------------------------------------------
# the other families' partitioned steps on (4, 2), (2, 4), (1, 8)
# ---------------------------------------------------------------------------
# measured about 1e-6 apart (fp32 sums in another order)
FAMILY_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# the recurrent cases are 12 (zamba2) and 8 (xlstm) layers deep against the
# others' 2, through exponential gates, and worse conditioned: jittering
# every parameter by 1e-7 of itself moves one process's gradients by up to
# 6.8e-5 (xlstm's embedding, whose largest is 5.2) and zamba2's a_log
# gradient by 1.0e-5 of its norm; the mesh's fp32 sums in another order
# stay within that (measured 5.4e-5 at one element of xlstm's embedding
# gradient, AdamW's first moment of a_log 1.4e-5 and its second 2.5e-5 of
# the leaf's norm)
RECURRENT_GRAD_TOL = dict(atol=1e-4, rtol=3e-4)
RECURRENT_MOMENT_TOL = 5e-5


def _tree_dist(got, want) -> float:
    """‖got − want‖ / ‖want‖ over every float leaf of two trees at once."""
    pairs = [(g.float(), w.float()) for (_, g), (_, w) in
             zip(leaves_with_path(got), leaves_with_path(want)) if w.is_floating_point()]
    num = sum(float(torch.linalg.vector_norm(g - w)) ** 2 for g, w in pairs)
    den = sum(float(torch.linalg.vector_norm(w)) ** 2 for _, w in pairs)
    return (num / den) ** 0.5


@pytest.mark.parametrize("mesh,case", FAMILY_CASES)
def test_partitioned_family_loss_and_grads_match_one_process(runs, mesh, case):
    """``loss_and_grads`` of the MoE (granite without and qwen with a
    shared expert; ``dispatch_blocks`` 1 and 4, the all-to-all over
    ``model``, and the drop case), VLM (patches), audio (4 codebooks;
    on (1, 8) a rank holds half a codebook's columns), hybrid (zamba2's
    Mamba2 heads, one a rank on (1, 8)) and xLSTM (mLSTM heads, whole on
    (1, 8)) families' partitioned program on each rank's blocks equals one
    process's (fp32): the loss, ``ce`` and ``aux`` on every rank, and
    every gradient after ``unplace`` (the recurrent cases within
    RECURRENT_GRAD_TOL); on the global batch and on 3 rows (the
    whole-rows rule)."""
    one = runs["one"]["families"][case]
    for name in ("batch", "rows3"):
        first = runs["ranks"][0]["partition"][mesh][case][name]
        for rank in runs["ranks"]:
            got = rank["partition"][mesh][case][name]
            assert float(got["loss"]) == float(first["loss"])
            for k in ("loss", "ce", "aux"):
                np.testing.assert_allclose(float(got["metrics"][k]),
                                           float(one[name]["metrics"][k]), err_msg=k,
                                           **STEP_LOSS_TOL)
            _assert_trees_close(got["grads"], one[name]["grads"], f"{mesh} {case} {name}",
                                **(RECURRENT_GRAD_TOL if case in RECURRENT_CASES
                                   else FAMILY_GRAD_TOL))


@pytest.mark.parametrize("mesh,case", FAMILY_CASES)
def test_partitioned_family_train_step_matches_one_process(runs, mesh, case):
    """One ZeRO-1 train step of the same cases (the routed experts' stacks
    and the codebook tables among the blocks): the whole state after it
    (``unplace``) within 1e-5 of one process's, the moments leaf by leaf
    and the parameters and masters as whole trees (AdamW's first step
    divides each gradient by its own magnitude, so a zero-initialized norm
    gain with a gradient near ``eps`` takes a fp32 sum's rounding ×1e4
    into its relative distance: pixtral's read 1.2e-4 leaf by leaf and
    granite's 1.6e-5; the recurrent cases' moments within
    RECURRENT_MOMENT_TOL), its step counter equal, the loss and gradient
    norm the same."""
    one = runs["one"]["families"][case]["train"]
    for rank in runs["ranks"]:
        got = rank["partition"][mesh][case]["train"]
        assert got["zero_split"] > 0
        err = state_dist(got["state"], one["state"])
        moment_tol = RECURRENT_MOMENT_TOL if case in RECURRENT_CASES else 1e-5
        assert err["step_equal"] and max(err["m"], err["v"]) <= moment_tol, err
        for k in ("params", "master"):
            part = got["state"]["params"] if k == "params" else got["state"]["opt"][k]
            want = one["state"]["params"] if k == "params" else one["state"]["opt"][k]
            assert _tree_dist(part, want) <= 1e-5, (k, err)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got["metrics"][k]), float(one["metrics"][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mesh,case", FAMILY_CASES)
def test_partitioned_family_prefill_and_decode_match_one_process(runs, mesh, case):
    """Prefill (a VLM's with its patches; a recurrent family's prompt
    stepped through the partitioned decode step from a zeroed cache) and
    four greedy decode steps from the prompt's true end through the
    partitioned steps (the cache the rank's rows and block of positions
    of every KV head, and its Mamba2 or mLSTM heads' state, between them):
    every step's tokens equal
    one process's and its logits within the products' tolerance, every
    rank."""
    one = runs["one"]["families"][case]["serve"]
    for rank in runs["ranks"]:
        got = rank["partition"][mesh][case]["serve"]
        assert torch.equal(got["tokens"], one["tokens"])
        np.testing.assert_allclose(_np(got["logits"]), _np(one["logits"]), **Y_TOL)


@pytest.mark.parametrize("mesh", BOTH)
def test_partitioned_moe_dispatch_exchanges(runs, mesh):
    """Under the partition the all-to-all runs on the rank's rows split
    over ``model`` (its calls counted; none in the capacity dispatch), and
    the capacity dispatch's first-come slots cross the data ranks only
    where a block spans them: one histogram all-gather (``route_bytes``) a
    layer at ``dispatch_blocks`` 1, none at 4 (a multiple of the data
    size)."""
    layers = configs.reduced(configs.get_config("granite-moe-1b-a400m")).n_layers
    for rank in runs["ranks"]:
        for case in (c for m, c in MOE_CASES if m == mesh):
            counts = rank["partition"][mesh][case]["batch"]["counts"]
            a2a = counts.get("counts", {}).get("all-to-all", 0)
            assert (a2a > 0) == case.endswith("a2a"), (case, counts)
            route = counts.get("route_bytes", 0)
            if case.endswith("nb1") or case == "drop":
                assert route > 0 and counts["counts"]["all-gather"] >= layers, (case, counts)
            else:
                assert route == 0, (case, counts)


def test_partitioned_moe_drop_case_drops(runs):
    """The drop case drops: one process's loss at ``dispatch_blocks`` 1
    (128 of expert 2's 256 assignments over the global capacity) differs
    from its loss at 4 (every block's 64 fit), and the mesh's equals the
    first (held by the family tests), which it would not if a rank ranked
    and capped its own rows alone (its 64 or 128 tokens fit its own
    capacity of 128)."""
    one = runs["one"]
    assert abs(float(one["families"]["drop"]["batch"]["loss"]) - one["drop_nb4_loss"]) > 1e-4
    for mesh in BOTH:
        got = float(runs["ranks"][0]["partition"][mesh]["drop"]["batch"]["loss"])
        assert abs(got - one["drop_nb4_loss"]) > 1e-4


def test_partitioned_moe_loss_matches_reference_sharded_loss(runs):
    """The reference's own sharded program for reduced granite-moe
    (``dispatch_blocks`` 4; its step jitted with ``in_shardings`` from
    ``param_specs`` and ``batch_specs`` on its 8-device (4, 2) mesh) and
    the port's partitioned step on the same weights and batch give the
    same loss."""
    want = float(runs["ref_mesh"]["sharded_loss_granite_nb4"])
    np.testing.assert_allclose(float(runs["one"]["families"]["granite_nb4"]["batch"]["loss"]),
                               want, **STEP_LOSS_TOL)
    for rank in runs["ranks"]:
        np.testing.assert_allclose(
            float(rank["partition"]["4x2"]["granite_nb4"]["batch"]["loss"]), want,
            **STEP_LOSS_TOL)


def test_partitioned_hybrid_loss_matches_reference_sharded_loss(runs):
    """The reference's own sharded program for reduced zamba2 (its step
    jitted with ``in_shardings`` from ``param_specs`` and ``batch_specs``
    on its 8-device (4, 2) mesh: GSPMD splits the Mamba2 heads, the shared
    block's heads and MLP columns over ``model``) and the port's
    partitioned step on the same weights and batch give the same loss."""
    want = float(runs["ref_mesh"]["sharded_loss_zamba2"])
    np.testing.assert_allclose(float(runs["one"]["families"]["zamba2"]["batch"]["loss"]),
                               want, **STEP_LOSS_TOL)
    for rank in runs["ranks"]:
        np.testing.assert_allclose(
            float(rank["partition"]["4x2"]["zamba2"]["batch"]["loss"]), want,
            **STEP_LOSS_TOL)
