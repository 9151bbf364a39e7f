"""The port's partition rules and the planner's mesh pass against the JAX
package's, in-process (no ranks: the rules read only names and sizes).

The reference runs on ``jax.sharding.AbstractMesh``, the port on its
``AbstractMesh``, at (4, 2), (16, 16) and (2, 16, 16).  Every arch at full
width, on abstract shapes (the reference's ``jax.eval_shape``, the port's
meta tensors), dense and packed at density 0.3 in both formats.  The
reference stacks a group's layers into one leaf with lead dims; a port
leaf's spec must equal the reference's stacked spec without those dims
(``P()`` and ``P(None, ...)`` are one spec, so both sides are padded with
None to the leaf's rank before comparing).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core import formats as jformats
from repro.core import pruning as jpruning
from repro.core import sod as jsod
from repro.core.plan import ModelPlan as JModelPlan
from repro.models.model import LM as JLM
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime import planner as jplanner
from repro.runtime import sharding as jsharding
from repro_torch import configs
from repro_torch.core import plan as plan_mod
from repro_torch.core import sod
from repro_torch.core.plan import ModelPlan
from repro_torch.kernels import autotune
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.runtime import planner, sharding, spmd

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("dense", "tiled_csc", "block_csr")
ARCHS = configs.ARCH_NAMES
_J_PACKED = (jformats.TiledCSC, jformats.BlockCSR)
_J_FIELDS = {jformats.TiledCSC: ("vals", "rows", "scale", "codebook"),
             jformats.BlockCSR: ("block_vals", "block_ids", "tile_nnz", "scale", "codebook")}


def _meshes(name):
    sizes, names = MESHES[name]
    return JAbstractMesh(sizes, names), mesh_mod.AbstractMesh(sizes, names)


def test_production_meshes_are_the_reference_layouts():
    assert mesh_mod.make_production_mesh() == mesh_mod.AbstractMesh(*MESHES["16x16"])
    assert mesh_mod.make_production_mesh(multi_pod=True) == mesh_mod.AbstractMesh(
        *MESHES["2x16x16"])
    m = mesh_mod.make_production_mesh(multi_pod=True)
    assert mesh_mod.dp_axes(m) == ("pod", "data") and mesh_mod.tp_axis(m) == "model"
    assert spmd.mesh_key(m) == "pod=2,data=16,model=16"


@functools.lru_cache(maxsize=None)
def _trees(arch, mode):
    """Both packages' abstract parameter trees (and configs)."""
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    jp = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    tp = LM(tcfg).init(torch.Generator(), "meta")
    if mode != "dense":
        jp = jsod.sodify_abstract(jp, jsod.SoDConfig(mode=mode, density=0.3))
        tp = sod.sodify_abstract(tp, sod.SoDConfig(mode=mode, density=0.3))
    return jcfg, jp, tcfg, tp


@functools.lru_cache(maxsize=None)
def _param_specs(arch, mode, mesh):
    """Both packages' parameter specs (shared by the param and opt tests)."""
    jcfg, jp, tcfg, tp = _trees(arch, mode)
    jmesh, tmesh = _meshes(mesh)
    return jsharding.param_specs(jp, jcfg, jmesh), sharding.param_specs(tp, tcfg, tmesh)


@functools.lru_cache(maxsize=None)
def _opt_states(arch, mode):
    """Both packages' abstract AdamW states."""
    _, jp, _, tp = _trees(arch, mode)
    return jax.eval_shape(JAdamW(JAdamWConfig()).init, jp), AdamW(AdamWConfig()).init(tp)


def _name(path) -> str:
    return jax.tree_util.keystr(path).replace("'", "").replace("]", "").replace("[", ".")


def _reference_by_name(jtree, jspecs) -> dict:
    """``{reference name: (shape, spec)}``, packed leaves by field."""
    is_leaf = lambda x: isinstance(x, _J_PACKED)
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=is_leaf)
    specs = jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda x: isinstance(x, (P,) + _J_PACKED))
    assert len(flat) == len(specs)
    out = {}
    for (path, leaf), spec in zip(flat, specs):
        if isinstance(leaf, _J_PACKED):
            for f in _J_FIELDS[type(leaf)]:
                if getattr(leaf, f) is not None:
                    out[f"{_name(path)}.{f}"] = (tuple(getattr(leaf, f).shape),
                                                 tuple(getattr(spec, f)))
        else:
            out[_name(path)] = (tuple(leaf.shape), tuple(spec))
    return out


def _pad(spec, nd):
    return tuple(spec) + (None,) * (nd - len(tuple(spec)))


def _assert_port_matches(ttree, tspecs, ref: dict, period: int) -> int:
    """Every port leaf's spec is the reference's stacked one without lead."""
    n = 0
    for path, ws, _ in sod.plan_leaves(ttree, period):
        for leaf, spec in zip(ws, sharding._per_block(tspecs, path)):
            items = ([(f"{path}.{f}", getattr(leaf, f), getattr(spec, f))
                      for f in ("vals", "rows", "block_vals", "block_ids", "tile_nnz",
                                "scale", "codebook") if getattr(leaf, f, None) is not None]
                     if isinstance(leaf, (sod.TiledCSC, sod.BlockCSR))
                     else [(path, leaf, spec)])
            for name, t, s in items:
                r_shape, r_spec = ref[name]
                n_lead = len(r_shape) - t.ndim
                assert r_shape[n_lead:] == tuple(t.shape), name
                assert _pad(s, t.ndim) == _pad(r_spec, len(r_shape))[n_lead:], (name, s, r_spec)
                n += 1
    return n


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mode, mesh):
    _, jp, tcfg, tp = _trees(arch, mode)
    jspecs, tspecs = _param_specs(arch, mode, mesh)
    ref = _reference_by_name(jp, jspecs)
    assert _assert_port_matches(tp, tspecs, ref, tcfg.pattern_period) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_match_reference(arch, mode, mesh):
    """ZeRO-1 moments and masters: the reference's rule (its own
    ``_zero_spec``: the first dim the parameter's spec leaves whole and
    the data axes divide) applied to the port's per-layer leaf shape and
    the reference's parameter spec without its lead dims (the reference's
    layer-stack dim is not a port dim); where the reference's ZeRO shard
    lands on a dim the port has, its state spec itself."""
    _, jp, tcfg, _ = _trees(arch, mode)
    jmesh, tmesh = _meshes(mesh)
    jstate, tstate = _opt_states(arch, mode)
    jp_specs, tp_specs = _param_specs(arch, mode, mesh)
    jspecs = jsharding.opt_state_specs(jstate, jp_specs, jmesh)
    tspecs = sharding.opt_state_specs(tstate, tp_specs, tmesh, cfg=tcfg)
    assert tspecs["step"] == () and tuple(jspecs["step"]) == ()
    dp = mesh_mod.dp_axes(tmesh)
    dp_ax = dp if len(dp) > 1 else dp[0]
    ref_params = _reference_by_name(jp, jp_specs)
    n = 0
    for k in ("m", "v", "master"):
        ref_state = _reference_by_name(jstate[k], jspecs[k])
        for path, ws, _ in sod.plan_leaves(tstate[k], tcfg.pattern_period):
            for leaf, spec in zip(ws, sharding._per_block(tspecs[k], path)):
                items = ([(f"{path}.{f}", getattr(leaf, f), getattr(spec, f))
                          for f in ("vals", "rows", "block_vals", "block_ids", "tile_nnz",
                                    "scale", "codebook") if getattr(leaf, f, None) is not None]
                         if isinstance(leaf, (sod.TiledCSC, sod.BlockCSR))
                         else [(path, leaf, spec)])
                for name, t, got in items:
                    if t.ndim == 0:
                        assert tuple(got) == (), name
                        continue
                    r_shape, r_pspec = ref_params[name]
                    n_lead = len(r_shape) - t.ndim
                    pspec = _pad(r_pspec, len(r_shape))[n_lead:]
                    want = jsharding._zero_spec(P(*pspec), tuple(t.shape), jmesh, dp)
                    assert _pad(got, t.ndim) == _pad(want, t.ndim), (name, got, want)
                    r_state = _pad(ref_state[name][1], len(r_shape))
                    if dp_ax in r_state[n_lead:]:
                        assert _pad(got, t.ndim) == r_state[n_lead:], (name, got, r_state)
                    n += 1
    assert n > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES[1:])
@pytest.mark.parametrize("arch", ARCHS)
def test_packed_matmul_plans_match_reference(arch, mode, mesh):
    """Plans for lead-less packed leaves only (an untied head), none for a
    stacked projection, in both packages."""
    jcfg, jp, tcfg, tp = _trees(arch, mode)
    jmesh, tmesh = _meshes(mesh)
    jplans = jsharding.packed_matmul_plans(jp, jcfg, jmesh)
    tplans = sharding.packed_matmul_plans(tp, tcfg, tmesh)
    assert {k: vars(v) for k, v in tplans.items()} == {
        k: {"batch_axes": v.batch_axes, "col_axis": v.col_axis, "row_axis": v.row_axis,
            "gather_axis": v.gather_axis} for k, v in jplans.items()}


def test_reduced_llama_has_no_packed_matmul_plans():
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b"))
    tcfg = configs.reduced(configs.get_config("llama3.2-1b"))
    jmesh, tmesh = _meshes("4x2")
    for scan in (True, False):
        jp = jsod.sodify_abstract(jax.eval_shape(JLM(jcfg.with_(scan_layers=scan)).init,
                                                 jax.random.PRNGKey(0)),
                                  jsod.SoDConfig(mode="tiled_csc", density=0.3, min_dim=64))
        assert jsharding.packed_matmul_plans(jp, jcfg, jmesh) == {}
    tp = sod.sodify_abstract(LM(tcfg).init(torch.Generator(), "meta"),
                             sod.SoDConfig(mode="tiled_csc", density=0.3, min_dim=64))
    assert sharding.packed_matmul_plans(tp, tcfg, tmesh) == {}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rows", [8, 6, 64])
def test_batch_specs_match_reference(rows, mesh):
    jmesh, tmesh = _meshes(mesh)
    shapes = {"tokens": (rows, 32), "targets": (rows, 32), "loss_mask": (rows, 32),
              "patches": (rows, 16, 1024)}
    jb = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
    tb = {k: torch.empty(s, dtype=torch.int32, device="meta") for k, s in shapes.items()}
    ref = jsharding.batch_specs(jb, jmesh)
    assert sharding.batch_specs(tb, tmesh) == {k: tuple(v) for k, v in ref.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    """The rules on one tree: the reference's cache shapes as meta tensors."""
    jcfg = jconfigs.get_config(arch)
    jmesh, tmesh = _meshes(mesh)
    for batch, seq in ((32, 256), (1, 512)):
        jc = jax.eval_shape(lambda: JLM(jcfg).init_cache(batch, seq))
        tc = jax.tree_util.tree_map(
            lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"), jc)
        ref = jsharding.cache_specs(jc, jcfg, jmesh, batch, seq)
        got = sharding.cache_specs(tc, configs.get_config(arch), tmesh, batch, seq)
        assert got == jax.tree_util.tree_map(tuple, ref, is_leaf=lambda x: isinstance(x, P))


# ---------------------------------------------------------------------------
# the planner's mesh pass
# ---------------------------------------------------------------------------
def _two_leaf_trees():
    key = jax.random.PRNGKey(11)
    wu = np.asarray(jpruning.random_sparse(jax.random.fold_in(key, 21), (256, 512), 0.3))
    wd = np.asarray(jpruning.random_sparse(jax.random.fold_in(key, 22), (512, 256), 0.3))
    jtree = {"blocks": {"mlp": {"w_up": jnp.asarray(wu), "w_down": jnp.asarray(wd)}}}
    ttree = {"blocks": {"mlp": {"w_up": torch.from_numpy(wu), "w_down": torch.from_numpy(wd)}}}
    return jtree, ttree


def test_planner_attaches_the_reference_spmd_plans(tmp_path):
    """``w_up`` gets a column plan, ``w_down`` a row plan, the plan the mesh
    key; a JSON round trip keeps them, and a plan file crosses packages."""
    jtree, ttree = _two_leaf_trees()
    jmesh, tmesh = _meshes("4x2")
    kw = dict(m_values=(48,))
    jp = jplanner.build_plan(jtree, jsod.SoDConfig(mode="tiled_csc", density=0.3, min_dim=128),
                             cfg=jconfigs.get_config("llama3.2-1b"), mesh=jmesh, **kw)
    tp = planner.build_plan(ttree, sod.SoDConfig(mode="tiled_csc", density=0.3, min_dim=128),
                            cfg=configs.get_config("llama3.2-1b"), mesh=tmesh, **kw)
    assert tp.mesh == jp.mesh == "data=4,model=2"
    assert {p: e.spmd for p, e in tp.entries.items()} == {
        p: e.spmd for p, e in jp.entries.items()}
    assert tp.get(".blocks.mlp.w_up").spmd["col_axis"] == "model"
    assert tp.get(".blocks.mlp.w_down").spmd["row_axis"] == "model"
    loaded = ModelPlan.load(tp.save(tmp_path / "plan.json"))
    assert loaded.entries == tp.entries and loaded.mesh == tp.mesh
    jloaded = JModelPlan.load(tp.save(tmp_path / "cross.json"))
    assert {p: e.spmd for p, e in jloaded.entries.items()} == {
        p: e.spmd for p, e in jp.entries.items()}


def test_plan_spmd_only_under_its_own_mesh():
    _, ttree = _two_leaf_trees()
    tp = planner.build_plan(ttree, sod.SoDConfig(mode="tiled_csc", density=0.3),
                            cfg=configs.get_config("llama3.2-1b"),
                            mesh=_meshes("4x2")[1], m_values=(48,))
    entry = tp.get(".blocks.mlp.w_up")
    assert sod._plan_spmd(entry) is None                  # no mesh active
    with spmd.use_mesh(_meshes("4x2")[1]), plan_mod.use_plan(tp):
        assert sod._plan_spmd(entry) == spmd.SpmdPlan(batch_axes=("data",),
                                                      col_axis="model")
    with spmd.use_mesh(_meshes("16x16")[1]), plan_mod.use_plan(tp):
        assert sod._plan_spmd(entry) is None              # built for another mesh


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internlm2-1.8b"])
def test_planner_mesh_pass_on_a_reduced_model(arch):
    """Stacked leaves carry no ``spmd`` in either package; an untied head
    (internlm2) carries the same plan in both."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = configs.reduced(configs.get_config(arch))
    jmesh, tmesh = _meshes("4x2")
    jshapes = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    tshapes = LM(tcfg).init(torch.Generator(), "meta")
    sc = dict(mode="tiled_csc", density=0.3, min_dim=64)
    jp = jplanner.build_plan(jshapes, jsod.SoDConfig(**sc), cfg=jcfg, mesh=jmesh)
    tp = planner.build_plan(tshapes, sod.SoDConfig(**sc), cfg=tcfg, mesh=tmesh)
    assert tp.mesh == jp.mesh == "data=4,model=2"
    assert {p: e.spmd for p, e in tp.entries.items()} == {
        p: e.spmd for p, e in jp.entries.items()}
    assert all(e.spmd is None for p, e in tp.entries.items() if e.lead)
    assert (tp.get(".head") is not None) == (arch == "internlm2-1.8b")


def test_warmup_plan_tunes_local_shards_under_mesh_keys(tmp_path):
    _, ttree = _two_leaf_trees()
    tmesh = _meshes("4x2")[1]
    tp = planner.build_plan(ttree, sod.SoDConfig(mode="tiled_csc", density=0.3),
                            cfg=configs.get_config("llama3.2-1b"), mesh=tmesh,
                            m_values=(48,))
    cache = autotune.TuningCache(tmp_path / "warm.json")
    stats = planner.warmup_plan(tp, mesh=tmesh, backend="cpu", cache=cache, iters=1,
                                device="cpu")
    assert stats == {"tuned": 2, "cached": 0, "skipped": 0}
    keys = list(cache.entries) if hasattr(cache, "entries") else list(cache._entries)
    assert any("mesh=data=4,model=2|dp=data;col=model" in k for k in keys)
    assert any("mesh=data=4,model=2|dp=data;row=model" in k for k in keys)
    assert planner.warmup_plan(tp, mesh=tmesh, backend="cpu", cache=cache, iters=1,
                               device="cpu") == {"tuned": 0, "cached": 2, "skipped": 0}


@pytest.mark.parametrize("mode", MODES[1:])
def test_sodify_abstract_keeps_expert_stacks(mode):
    """The routed experts' abstract pack keeps its (E,) stack, as the
    concrete ``sodify_params`` and the reference's ``sodify_abstract``
    (whose stacked leaf is (groups, period, E, ...)) do."""
    _, jp, _, tp = _trees("granite-moe-1b-a400m", mode)
    field = "vals" if mode == "tiled_csc" else "block_vals"
    for name in ("w_gate", "w_up", "w_down"):
        want = getattr(jp["blocks"]["moe"][name], field).shape[2:]
        for layer in tp["layers"]:
            assert tuple(getattr(layer["moe"][name], field).shape) == tuple(want)
