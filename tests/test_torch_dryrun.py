"""The port's dry-run (``launch/specs.py``, ``launch/dryrun.py``, the shapes of
``configs/base.py``) held against the JAX package's, in-process.

The reference's shapes and cells are read from its own modules: its specs
through ``jax.eval_shape``, its plan through ``_plan_for_cell`` on a
``jax.sharding.AbstractMesh`` (its production mesh needs 256 devices).
Its ``launch/dryrun.py`` forces 512 host devices through ``XLA_FLAGS`` at
import, so the variable is put back right after the import, before any
backend starts.  The counting mesh's numbers against a real rank of a
``gloo`` group are in ``tests/test_torch_spmd.py`` (its group runs them).
"""
import functools
import json
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core import sod as jsod
from repro.launch import specs as jspecs
from repro.models.model import LM as JLM
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.core import sod
from repro_torch.launch import dryrun, specs
from repro_torch.launch import mesh as mesh_mod

torch.set_num_threads(1)
ARCHS = configs.ARCH_NAMES
MODES = ("dense", "tiled_csc", "block_csr")


@pytest.fixture(scope="module")
def jdryrun():
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
def test_shapes_are_the_reference_shapes():
    assert {k: tuple(vars(v).values()) for k, v in base.SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in jbase.SHAPES.items()}
    assert base.SUBQUADRATIC_FAMILIES == jbase.SUBQUADRATIC_FAMILIES
    assert configs.ShapeConfig is base.ShapeConfig and configs.SHAPES is base.SHAPES
    assert configs.shape_applicable is base.shape_applicable


@pytest.mark.parametrize("shape", list(base.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_matches_reference(arch, shape):
    assert base.shape_applicable(configs.get_config(arch), base.SHAPES[shape]) == \
        jbase.shape_applicable(jconfigs.get_config(arch), jbase.SHAPES[shape])


def _flat_specs(tree, prefix=""):
    """``{name: (shape, dtype)}`` of a dict/list/tuple tree of tensors or
    ShapeDtypeStructs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}.{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_specs(v, f"{prefix}[{i}]"))
        return out
    return {prefix: (tuple(tree.shape), _dtype(tree.dtype))}


@pytest.mark.parametrize("shape", list(base.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    """Inputs of every arch × shape at full width: the same shapes, the
    same dtypes but the token ids' (int64 here, int32 there); a decode
    cache is the reference's leaf by leaf, its (groups, period) layer dims
    one dim here."""
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    ref = jspecs.input_specs(jcfg, jbase.SHAPES[shape])
    got = specs.input_specs(tcfg, base.SHAPES[shape])
    assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(got))
    if base.SHAPES[shape].kind == "decode":
        jcache = jax.tree_util.tree_leaves(ref["cache"])
        tcache = jax.tree_util.tree_leaves(got["cache"])
        assert len(jcache) == len(tcache) > 0
        for a, t in zip(jcache, tcache):
            r = tuple(a.shape)
            if len(r) == t.ndim + 1:          # stacked (groups, period, ...)
                r = (r[0] * r[1],) + r[2:]
            assert (r, str(a.dtype)) == (tuple(t.shape), _dtype(t.dtype))
        ref, got = ({k: v for k, v in d.items() if k != "cache"} for d in (ref, got))
    want = {k: (s, "int64" if d == "int32" else d) for k, (s, d) in _flat_specs(ref).items()}
    assert _flat_specs(got) == want


@functools.lru_cache(maxsize=None)
def _abstract(arch, mode):
    sc = dict(mode=mode, density=0.3)
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    jp = jspecs.abstract_params(JLM(jcfg), jsod.SoDConfig(**sc) if mode != "dense" else None)
    tp = specs.abstract_params(dryrun.LM(tcfg), sod.SoDConfig(**sc) if mode != "dense" else None)
    return jp, tp, tcfg


def _reference_leaves(jtree) -> dict:
    """``{plan path[.field]: (stacked shape, dtype)}`` of the reference."""
    out = {}
    packed = (jsod.TiledCSC, jsod.BlockCSR)
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=lambda x: isinstance(x, packed))
    for path, leaf in flat:
        name = "." + jax.tree_util.keystr(path).replace("'", "").replace("]", "").replace(
            "[", ".").lstrip(".")
        if isinstance(leaf, packed):
            for f, a in zip(dryrun.PACKED_FIELDS[type(_port_type(leaf))], leaf.tree_flatten()[0]):
                if a is not None:
                    out[f"{name}.{f}"] = (tuple(a.shape), str(a.dtype))
        else:
            out[name] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _port_type(jleaf):
    return sod.TiledCSC.__new__(sod.TiledCSC) if isinstance(jleaf, jsod.TiledCSC) else \
        sod.BlockCSR.__new__(sod.BlockCSR)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch, mode):
    """Every port leaf (a dict per layer) is its stacked reference leaf
    without the lead dims, in shape and dtype, packed fields included."""
    jp, tp, tcfg = _abstract(arch, mode)
    ref = _reference_leaves(jp)
    n = 0
    for path, ws, _ in sod.plan_leaves(tp, tcfg.pattern_period):
        for leaf in ws:
            items = ([(f"{path}.{f}", getattr(leaf, f)) for f in dryrun.PACKED_FIELDS[type(leaf)]
                      if getattr(leaf, f) is not None]
                     if type(leaf) in dryrun.PACKED_FIELDS else [(path, leaf)])
            for name, t in items:
                assert t.device.type == "meta", name
                r_shape, r_dtype = ref[name]
                assert r_shape[len(r_shape) - t.ndim:] == tuple(t.shape), name
                assert r_dtype == _dtype(t.dtype), name
                n += 1
    assert n > 0


# ---------------------------------------------------------------------------
# the dry-run's pure parts and records
# ---------------------------------------------------------------------------
def test_group_size_and_extrapolate_match_reference(jdryrun):
    for arch in ARCHS:
        assert dryrun._group_size(configs.get_config(arch)) == \
            jdryrun._group_size(jconfigs.get_config(arch))
    rng = np.random.default_rng(0)
    kinds = dryrun._COLLECTIVES + ("total",)
    for _ in range(20):
        a1 = {"cost": {"flops": float(rng.integers(1, 1e9))},
              "collectives": {k: float(rng.integers(0, 1e6)) for k in kinds}}
        a2 = {"cost": {"flops": float(rng.integers(1, 1e9))},
              "collectives": {k: float(rng.integers(0, 1e6)) for k in kinds}}
        g = int(rng.integers(3, 60))
        assert dryrun._extrapolate(a1, a2, 1, 2, g) == jdryrun._extrapolate(a1, a2, 1, 2, g)
    bad = {"cost": {"error": "x"}, "collectives": {}}
    assert dryrun._extrapolate(bad, bad, 1, 2, 4) == jdryrun._extrapolate(bad, bad, 1, 2, 4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "musicgen-medium"])
def test_skipped_cell_record_matches_reference(jdryrun, arch):
    for mp in (False, True):
        for sod_mode in (None, "tiled_csc"):
            assert dryrun.run_cell(arch, "long_500k", mp, sod_mode) == \
                jdryrun.run_cell(arch, "long_500k", mp, sod_mode)


def _no_hint(summary: dict) -> dict:
    """A plan summary without the dispatch hint (``(prior:impl)``: the
    packages' kernel names differ)."""
    return {p: re.sub(r" \((prior|tuned)[^)]*\)$", "", s) for p, s in summary.items()}


@pytest.mark.parametrize("sod_mode", ["tiled_csc", "block_csr"])
def test_cell_plan_matches_reference(jdryrun, sod_mode, tmp_path, monkeypatch):
    """One cell's ``pack_plan``, ``pack_plan_bytes``, ``params_b`` and
    ``active_params_b``: the reference's ``_plan_for_cell`` on its abstract
    production mesh."""
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "tc.json"))
    from repro_torch.kernels import autotune

    autotune.set_cache(None)
    try:
        cfg, shape, mesh, plan = dryrun.build_cell("llama3.2-1b", "train_4k", False,
                                                   sod_mode, 0.3)
    finally:
        autotune.set_cache(None)
    jcfg = jconfigs.get_config("llama3.2-1b").with_(
        sod=jsod.SoDConfig(mode=sod_mode, density=0.3))
    jplan = jdryrun._plan_for_cell(jcfg, jbase.SHAPES["train_4k"],
                                   JAbstractMesh((16, 16), ("data", "model")), None)
    assert _no_hint(plan.summary()) == _no_hint(jplan.summary())
    assert plan.compressed_bytes() == jplan.compressed_bytes()
    assert plan.mesh == jplan.mesh == "data=16,model=16"
    # the hints name the card's kernels (a block plan at this density keeps
    # every leaf dense in both packages: packed would exceed dense bytes)
    assert all("cuda" in s for s in plan.summary().values() if not s.startswith("dense"))
    assert (cfg.param_count(), cfg.active_param_count()) == (
        jcfg.param_count(), jcfg.active_param_count())
    assert mesh.dry and mesh.rank == 0 and mesh.shape == {"data": 16, "model": 16}


def test_depth_extrapolation_is_exact():
    """Reduced llama at 4 layers on the counting mesh: the 1- and 2-layer
    runs, extrapolated, give the full run's flops and collective bytes
    exactly."""
    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        n_layers=4, sod=sod.SoDConfig(mode="tiled_csc", density=0.3))
    shape = base.ShapeConfig("t", "train", 32, 8)
    mesh = mesh_mod.DryMesh((4, 2), ("data", "model"))
    runs = {}
    for n in (1, 2, 4):
        c = cfg.with_(n_layers=n)
        plan = dryrun._plan_for_cell(c, shape, mesh, None)
        runs[n] = dryrun.measure(c, shape, mesh, plan)
    ext = dryrun._extrapolate(runs[1], runs[2], 1, 2, 4)
    assert ext["cost"] == runs[4]["cost"]
    assert ext["collectives"] == {k: runs[4]["collectives"][k]
                                  for k in dryrun._COLLECTIVES + ("total",)}
    assert runs[4]["collectives"]["total"] > runs[2]["collectives"]["total"] > 0


def test_counting_mesh_runs_without_a_group_and_launches_nothing():
    """Every collective counts and returns a meta tensor of the group's
    shape; a packed product resolves the card's kernel and runs none."""
    from repro_torch.kernels import block_matmul, decompress, sod_matmul
    from repro_torch.runtime import spmd

    mesh = mesh_mod.DryMesh((4, 2), ("data", "model"), rank=5)
    assert mesh.coords == {"data": 2, "model": 1} and mesh.index(("data", "model")) == 5
    with pytest.raises(RuntimeError):
        mesh.group("data")
    t = torch.empty(3, 4, device="meta", dtype=torch.bfloat16)
    with spmd.count_collectives() as c:
        g = spmd.all_gather(t, mesh, "data", 0, "output_bytes")
        r = spmd.all_reduce(t, mesh, ("data", "model"))
        a = spmd.all_to_all(torch.empty(4, 5, device="meta"), mesh, "data")
    assert (g.shape, r.shape, r.dtype, a.shape) == ((12, 4), (3, 4), torch.bfloat16, (4, 5))
    assert all(x.device.type == "meta" for x in (g, r, a))
    assert (c["all-gather"], c["all-reduce"], c["all-to-all"]) == (96, 96, 80)
    assert c["counts"] == {"all-gather": 1, "all-reduce": 1, "all-to-all": 1}
    assert c["a2a_bytes"] == 60
    before = (sod_matmul.launches, block_matmul.launches, decompress.launches)
    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        sod=sod.SoDConfig(mode="block_csr", density=0.3))
    shape = base.ShapeConfig("d", "decode", 32, 8)
    found = dryrun.measure(cfg, shape, mesh)      # no plan: the config's budgets pack
    assert {r["impl"] for r in found["dispatch_log"]} == {"cuda_block"}
    assert all(r["key"].backend == "cuda" and r["key"].mesh.startswith("data=4,model=2|")
               for r in found["dispatch_log"])
    assert (sod_matmul.launches, block_matmul.launches, decompress.launches) == before
    assert found["memory"]["peak_bytes"] >= found["memory"]["argument_bytes"] > 0


def test_split_axes_follow_the_placed_blocks():
    """``sharding.split_axes`` of a placed train state under its specs
    (``train_state_specs``), leaf by leaf in walk order: a leaf is split
    over axes whose sizes multiply to its whole size over its resident
    size (a packed leaf's blocked fields over its block's axes, a plain
    leaf over its spec's: the embedding's vocabulary, the projections'
    split dims); the state's specs place the whole state as the placed
    parameters' state lies, and ``layout_specs`` reads the same layout
    back from the placed parameters and the config."""
    import math

    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim.adamw import AdamW, AdamWConfig
    from repro_torch.runtime import sharding

    mesh = mesh_mod.DryMesh((4, 2), ("data", "model"), rank=5)
    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        sod=sod.SoDConfig(mode="tiled_csc", density=0.3, min_dim=64))
    params = specs.abstract_params(dryrun.LM(cfg), cfg.sod)
    pspecs = sharding.param_specs(params, cfg, mesh)
    opt = AdamW(AdamWConfig())
    placed = sharding.place(params, pspecs, mesh)
    state = {"params": placed, "opt": opt.init(placed)}
    whole = {"params": params, "opt": opt.init(params)}
    laid = sharding.place(whole, sharding.train_state_specs(pspecs), mesh)
    axes = sharding.split_axes(state, sharding.train_state_specs(pspecs))
    assert sharding.split_axes(placed, sharding.layout_specs(placed, cfg, mesh)) == \
        sharding.split_axes(placed, pspecs)
    leaves, whole_leaves = tree_leaves(state), tree_leaves(whole)
    assert len(axes) == len(leaves) == len(whole_leaves)
    assert [t.shape for t in tree_leaves(laid)] == [t.shape for t in leaves]
    assert any(axes)
    for a, t, w in zip(axes, leaves, whole_leaves):
        assert math.prod(mesh.shape[x] for x in a) * t.numel() == w.numel()


# rank 0's all-gather bytes on DryMesh((4, 2)) in the tiled_csc cell below
# before the dense family's steps ran the partitioned program (every plain
# op on the global batch, every packed product's output gathered)
UNPARTITIONED_ALL_GATHER = 1_933_312


@pytest.mark.parametrize("mode", ["tiled_csc", "dense"])
def test_partitioned_train_cell_divides_the_work(mode):
    """Reduced llama's train step at 8 × 32 on rank 0 of DryMesh((4, 2))
    against the same step on one rank (DryMesh((1, 1))): the flops at most
    1.5 / (data · model) of the one rank's, the argument bytes at most 0.35
    of them (the parameters split over ``model`` only; ZeRO-1 splits the
    optimizer state over ``data``), and (packed) the all-gather bytes
    below the unpartitioned program's."""
    cfg = configs.reduced(configs.get_config("llama3.2-1b"))
    if mode != "dense":
        cfg = cfg.with_(sod=sod.SoDConfig(mode=mode, density=0.3))
    shape = base.ShapeConfig("t", "train", 32, 8)
    one = dryrun.measure(cfg, shape, mesh_mod.DryMesh((1, 1), ("data", "model")))
    got = dryrun.measure(cfg, shape, mesh_mod.DryMesh((4, 2), ("data", "model")))
    assert 0 < got["cost"]["flops"] <= 1.5 / 8 * one["cost"]["flops"]
    assert 0 < got["memory"]["argument_bytes"] <= 0.35 * one["memory"]["argument_bytes"]
    assert got["memory"]["peak_bytes"] < one["memory"]["peak_bytes"]
    if mode != "dense":
        assert got["collectives"]["all-gather"] < UNPARTITIONED_ALL_GATHER


RECORD_KEYS = {"arch", "shape", "mesh", "sod", "density", "kernel_dispatch",
               "dispatch_counts", "pack_plan", "pack_plan_bytes", "memory", "cost",
               "collectives", "n_devices", "params_b", "active_params_b", "status"}


def test_cli_writes_its_record_under_build(tmp_path, monkeypatch):
    """``main`` on reduced llama at a cut train shape (the config and shape
    patched in): status ok, the reference's record keys, ``device: meta``,
    written to ``RESULTS_DIR`` (a temp dir here; ``build/dryrun_torch`` of
    the checkout by default, never ``benchmarks/``)."""
    assert dryrun.RESULTS_DIR == dryrun.ROOT / "build" / "dryrun_torch"
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "tc.json"))
    full = configs.get_config
    monkeypatch.setattr(dryrun.configs, "get_config", lambda a: configs.reduced(full(a)))
    monkeypatch.setitem(dryrun.SHAPES, "train_4k", base.ShapeConfig("train_4k", "train", 32, 16))
    from repro_torch.kernels import autotune

    autotune.set_cache(None)
    try:
        assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                            "--sod", "tiled_csc"]) == 0
        assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k"]) == 0
    finally:
        autotune.set_cache(None)
    rec = json.loads((tmp_path / "llama3.2-1b__train_4k__16x16__tiled_csc.json").read_text())
    assert RECORD_KEYS <= set(rec) and rec["status"] == "ok" and rec["device"] == "meta"
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["total"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert set(rec["dispatch_counts"]) == {"cuda_fused[prior]"} and rec["n_devices"] == 256
    skipped = json.loads((tmp_path / "llama3.2-1b__long_500k__16x16__dense.json").read_text())
    assert skipped["status"] == "skipped"


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "musicgen-medium", "zamba2-2.7b",
                                  "xlstm-125m"])
def test_partitioned_family_train_cell_divides_the_work(arch):
    """Reduced granite-moe's (``dispatch_blocks`` = the data size, as the
    dry-run's cells set it), musicgen's, zamba2's and xlstm's train step at
    8 × 32 on rank 0 of DryMesh((4, 2)) against the same step on one rank:
    the flops at most 1.5 / (data · model) of the one rank's (a rank's
    rows over ``data``; its experts, heads, Mamba2 and mLSTM heads, MLP
    columns, vocabulary and codebook columns over ``model``), the argument
    bytes at most 0.35 of them.  The recurrent families ran whole rows
    before their steps were partitioned, 8 / 8 of the flops."""
    cfg = configs.reduced(configs.get_config(arch))
    if cfg.family == "moe":
        cfg = cfg.with_(moe_dispatch_blocks=4)
    shape = base.ShapeConfig("t", "train", 32, 8)
    one = dryrun.measure(cfg, shape, mesh_mod.DryMesh((1, 1), ("data", "model")))
    got = dryrun.measure(cfg, shape, mesh_mod.DryMesh((4, 2), ("data", "model")))
    assert 0 < got["cost"]["flops"] <= 1.5 / 8 * one["cost"]["flops"]
    assert 0 < got["memory"]["argument_bytes"] <= 0.35 * one["memory"]["argument_bytes"]
    assert got["memory"]["peak_bytes"] < one["memory"]["peak_bytes"]


# ---------------------------------------------------------------------------
# the decode cache's sequence over ``model``
# ---------------------------------------------------------------------------
def _block_bytes(shape, spec, sizes, itemsize) -> int:
    """Bytes of one rank's block of a leaf of ``shape`` under ``spec``."""
    n = itemsize
    for d, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n *= d // (sizes[ax] if ax is not None else 1)
    return n


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b", "zamba2-2.7b"])
def test_decode_cache_blocks_match_reference_cache_specs(arch):
    """At ``decode_32k`` on the 16 × 16 mesh each KV leaf's rank block
    (``decode_cache_specs``, its axes read from ``LM.cache_spec``) holds
    the bytes of the reference's shard under its ``cache_specs`` on
    ``AbstractMesh((16, 16))``, the same roles split: the rows over
    ``data``, the sequence over ``model`` (the two packages stack layers
    differently, so roles and bytes are compared, not the tuples)."""
    from repro.launch import specs as jspecs_mod
    from repro.runtime import sharding as jsharding
    from repro_torch.runtime import sharding

    shape = base.SHAPES["decode_32k"]
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    sizes = {"data": 16, "model": 16}
    cache = specs.input_specs(cfg, shape)["cache"]
    jcache = jspecs_mod.input_specs(jcfg, jbase.SHAPES["decode_32k"])["cache"]
    mesh = mesh_mod.AbstractMesh((16, 16), ("data", "model"))
    got = sharding.decode_cache_specs(cache, cfg, mesh, shape.global_batch)
    want = jsharding.cache_specs(jcache, jcfg, JAbstractMesh((16, 16), ("data", "model")),
                                 shape.global_batch, seq_len=shape.seq_len, seq_shard=True)
    axes = dryrun.LM(cfg).cache_spec()
    for name in ("k", "v"):
        t, jt = cache[name], jcache[name]
        port = _block_bytes(t.shape, got[name], sizes, t.element_size())
        ref = _block_bytes(jt.shape, tuple(want[name]), sizes, jt.dtype.itemsize)
        assert port == ref == t.numel() * t.element_size() // 256
        roles = {ax: i for i, ax in enumerate(got[name]) if ax is not None}
        assert roles == {"data": axes[name].batch, "model": axes[name].seq}
        jroles = {ax: jt.shape[i] for i, ax in enumerate(tuple(want[name])) if ax is not None}
        assert jroles == {"data": shape.global_batch, "model": shape.seq_len}


def _decode_32k(monkeypatch, seq_shard: str):
    monkeypatch.setenv("SOD_SEQ_SHARD_CACHE", seq_shard)
    return dryrun.build_cell("llama3.2-1b", "decode_32k", False, None, 0.3, n_layers=2)


@pytest.mark.parametrize("seq_shard, share", [("1", 256), ("0", 16)])
def test_decode_32k_rank_holds_its_share_of_the_cache(monkeypatch, seq_shard, share):
    """llama3.2-1b's ``decode_32k`` cell at 2 layers: rank 0's cache holds
    exactly 1/256 of the whole cache (rows over ``data``, positions over
    ``model``: the reference's dry-run default), and 1/16 under
    ``SOD_SEQ_SHARD_CACHE=0`` (rows only: the 8 KV heads do not divide
    ``model`` = 16)."""
    cfg, shape, mesh, plan = _decode_32k(monkeypatch, seq_shard)
    _, args = dryrun._step_and_args(cfg, shape, mesh, plan)
    whole = specs.input_specs(cfg, shape)["cache"]
    for name in ("k", "v"):
        assert args[1][name].numel() * share == whole[name].numel()


def test_decode_32k_split_moves_only_statistics(monkeypatch):
    """The same cell counted with and without the split: with it, each
    layer adds two all-reduces (the softmax's sum and the partial outputs)
    and two all-gathers (the scores' maxima and the query heads), under
    1e6 bytes in all, where the whole cache's argument bytes fall by
    15/16 of the cache; a rank's flops stay within 10 % (it scored its
    2 query heads over every position, and now every head over its
    2,048)."""
    split = dryrun.measure(*_decode_32k(monkeypatch, "1"))
    rows = dryrun.measure(*_decode_32k(monkeypatch, "0"))
    cfg, shape, *_ = _decode_32k(monkeypatch, "1")
    cache = specs.input_specs(cfg, shape)["cache"]
    cache_bytes = 2 * cache["k"].numel() * cache["k"].element_size() // 16
    c1, c0 = split["collectives"], rows["collectives"]
    assert c1["counts"]["all-reduce"] - c0["counts"]["all-reduce"] == 2 * cfg.n_layers
    assert c1["counts"]["all-gather"] - c0["counts"]["all-gather"] == 2 * cfg.n_layers
    assert 0 < c1["total"] - c0["total"] < 1e6
    assert rows["memory"]["argument_bytes"] - split["memory"]["argument_bytes"] == \
        cache_bytes * 15 // 16
    assert abs(split["cost"]["flops"] / rows["cost"]["flops"] - 1) < 0.1
