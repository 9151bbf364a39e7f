"""Partition rules: parameters, optimizer state, batches and caches → spec
trees; and :func:`place`, which leaves a rank its resident blocks.

Twin of :mod:`repro.runtime.sharding`.  A spec is a tuple with an axis name,
a tuple of names, or None for each dim (the reference's ``PartitionSpec``).
The rules are the reference's, path-pattern based and format-aware: a
packed leaf (TiledCSC / BlockCSR) shards its tile-grid dims (Kt, Nt) as the
dense (K, N) it stands for.  ZeRO-1 additionally shards optimizer moments
and float32 masters over the data axes along the first dim that divides.

The reference stacks the layers of a group into one leaf with lead dims
(groups, period); the port keeps a dict per layer.  Names and lead dims
come from :func:`repro_torch.core.sod.plan_leaves`: every rule runs on the
reference's path and stacked shape, and a port leaf's spec is that stacked
spec without its lead dims (so a ZeRO shard the reference puts on a layer
dim leaves the port's per-layer leaf whole).

ZeRO-1 cannot use the reference's layer-stack dim, since the port's
leaves are per layer: :func:`opt_state_specs` applies the reference's
``_zero_spec`` rule (the first dim the parameter's spec leaves whole and
the data axes divide) to the port's own leaf shape.

:func:`place` leaves each rank the block of every leaf that its spec
names: a packed leaf its tile-grid block (``w.shard`` records where it
sits), a plain leaf its block of each split dim (the embedding's
vocabulary, an untied head's or a projection's columns, ``wo``'s and
``w_down``'s rows over ``model``; ZeRO-1's moments and masters over the
data axes), every leaf the spec leaves whole, whole.  Every family's
steps then run the partitioned program on those blocks (the routed
experts' stacks split on E, the audio embedding on its vocabulary and
its head on its flattened (codebook, id) columns, the recurrent blocks'
projections on their heads' columns or rows)
(:mod:`repro_torch.launch.steps`); the engine's steps, which run every
plain op on the global batch, take the plain leaves whole again
(:func:`gather_plain` over :func:`layout_specs`, which reads a placed
tree's layout from the config's whole shapes).  :func:`packed_matmul_plans` gives the planner the
:class:`~repro_torch.runtime.spmd.SpmdPlan` each lead-less packed leaf's
resident spec implies; like the reference it gives none to a stacked
leaf, so the port attaches none to the per-layer leaves of a group (at run
time the auto plan applies to each layer, as inside the reference's scan).
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any

import torch

from repro_torch.core import sod
from repro_torch.core.formats import BlockCSR, Shard, TiledCSC
from repro_torch.core.tree import PACKED_FIELDS
from repro_torch.launch.mesh import dp_axes
from repro_torch.runtime import spmd
from repro_torch.runtime.spmd import _axes_of, all_gather

__all__ = ["param_specs", "opt_state_specs", "train_state_specs", "batch_specs",
           "cache_specs", "decode_cache_specs", "seq_split", "packed_matmul_plans",
           "place", "unplace", "whole", "split_axes", "layout_specs", "split_plain",
           "gather_plain", "is_split"]

Params = Any


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= mesh.shape[a]
        return n
    return mesh.shape[name]


def _period(cfg) -> int:
    return cfg.pattern_period if cfg is not None else 1


def _is_packed(leaf) -> bool:
    return isinstance(leaf, (TiledCSC, BlockCSR))


# ---------------------------------------------------------------------------
# dense-weight rules: the spec of the matrix dims (K, N); lead dims unsharded
# ---------------------------------------------------------------------------
def _matrix_spec(path: str, shape: tuple[int, ...], cfg, tp: int) -> tuple:
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    kv_ok = cfg.n_kv_heads % tp == 0

    def col_shard(dim):  # shard output/N dim on model axis when divisible
        return "model" if dim % tp == 0 else None

    if "embed" in path and len(shape) >= 2:
        # (V, D) vocab-sharded; audio (C, V, D)
        return ("model", None) if len(shape) == 2 else (None, "model", None)
    if "patch_proj" in path:
        return (None, None)
    if "head" in path:
        return (None, col_shard(shape[-1]))
    if re.search(r"w[qkv]\b|wq|wk|wv", path):
        if ("wk" in path or "wv" in path) and not kv_ok:
            return (None, None)          # replicate KV when heads < TP
        if ("wk" in path or "wv" in path):
            return (None, "model")
        return (None, col_shard(shape[-1]))
    if "wo" in path:
        return (col_shard(shape[-2]), None)
    if "w_down" in path or "out_proj" in path or "w_out" in path:
        return (col_shard(shape[-2]), None)
    if re.search(r"w_gate|w_up|in_proj|w_z|w_x\b", path):
        return (None, col_shard(shape[-1]))
    if "router" in path or "w_dt" in path or "w_b" in path or "w_c" in path:
        return (None, None)
    if "w_if" in path or "w_gates" in path:
        return (None, None)
    return tuple(None for _ in shape[-2:]) if len(shape) >= 2 else (None,)


_PACKED_TAIL = {"vals": 2, "rows": 2, "block_vals": 3, "block_ids": 1,
                "tile_nnz": 0, "scale": 0}


def _drop_undivided(shape, spec, mesh) -> tuple:
    return tuple(None if (ax is not None and dim % _axis_size(mesh, ax) != 0) else ax
                 for dim, ax in zip(shape, spec))


def _leaf_spec(path: str, shape: tuple[int, ...], cfg, mesh) -> tuple:
    """The reference's spec of the leaf at ``path`` with (stacked) ``shape``."""
    tp = mesh.shape["model"]
    nd = len(shape)
    if nd <= 1:
        return ()
    # quantization codebook: a whole-matrix table, always replicated
    if path.endswith(".codebook"):
        return (None,) * nd
    # packed sub-arrays: the (Kt, Nt) grid dims shard like the dense (K, N)
    m = re.search(r"\.(vals|rows|block_vals|block_ids|tile_nnz|scale)$", path)
    if m:
        tail = _PACKED_TAIL[m.group(1)]
        grid = shape[nd - tail - 2: nd - tail]
        spec = ((None,) * (nd - tail - 2) + _matrix_spec(path, grid, cfg, tp)
                + (None,) * tail)
        return _drop_undivided(shape, spec, mesh)
    # MoE stacked experts: (..., E, d_in, d_out) — EP on the expert dim
    if re.search(r"moe.*(w_gate|w_up|w_down)", path) and nd >= 3:
        ep = "model" if shape[-3] % tp == 0 else None
        return (None,) * (nd - 3) + (ep, None, None)
    if "moe" in path and "router" in path:
        return (None,) * nd
    mat = _matrix_spec(path, shape, cfg, tp)
    return _drop_undivided(shape, (None,) * (nd - len(mat)) + mat, mesh)


# ---------------------------------------------------------------------------
# the port's trees in the reference's naming
# ---------------------------------------------------------------------------
def _stack_lead(leaf, lead: tuple[int, ...]) -> tuple[int, ...]:
    """The stack dims of a :func:`~repro_torch.core.sod.plan_leaves` lead
    (which also holds a stacked leaf's own leading dims)."""
    own = 0 if _is_packed(leaf) else max(leaf.ndim - 2, 0)
    return lead[:len(lead) - own]


def _per_block(tree, path: str) -> list:
    """Every block's value at a plan path (the inverse of ``sod._place``)."""
    name = path.strip(".")
    stack, _, rest = name.partition(".")
    stack = "layers" if stack == "blocks" else stack
    if isinstance(tree.get(stack), list):
        return [sod._get(block, rest) for block in sod._flat(tree[stack])[0]]
    return [sod._get(tree, name)]


def _map_stacked(fn, tree, period: int, *others):
    """A tree like ``tree`` with ``fn(name, stacked shape, n_lead, leaf,
    *others' leaves)`` at every tensor; a packed container maps field by
    field (``name.<field>``) into a container of the results."""
    out = sod._copy(tree)
    for path, ws, lead in sod.plan_leaves(tree, period):
        n_lead = len(_stack_lead(ws[0], lead))
        stack = tuple(lead[:n_lead])
        rest = [_per_block(o, path) for o in others]

        def one(leaf, *o, name=path):
            if leaf is None:
                return None
            if _is_packed(leaf):
                return dataclasses.replace(leaf, **{
                    f: one(getattr(leaf, f), *(getattr(x, f) for x in o),
                           name=f"{name}.{f}")
                    for f in PACKED_FIELDS[type(leaf)]})
            return fn(name, stack + tuple(leaf.shape), n_lead, leaf, *o)

        sod._place(out, path, [one(w, *(r[i] for r in rest)) for i, w in enumerate(ws)])
    return out


def param_specs(params: Params, cfg, mesh) -> Params:
    """Spec tree matching ``params`` (packed leaves as containers of their
    fields' specs)."""
    return _map_stacked(
        lambda name, shape, n_lead, leaf: _leaf_spec(name, shape, cfg, mesh)[n_lead:],
        params, _period(cfg))


def train_state_specs(specs: Params, opt_specs: Params | None = None) -> Params:
    """Specs of a train state ``{"params", "opt"}``: with ``opt_specs``
    (:func:`opt_state_specs`, ZeRO-1) the optimizer state as they lay it,
    else its AdamW moments and masters as the parameters lie; what
    :func:`place` and :func:`unplace` of the state and
    ``Checkpointer.restore(shardings=)`` take beside the mesh."""
    opt = opt_specs if opt_specs is not None else {"step": (), "m": specs, "v": specs,
                                                   "master": specs}
    return {"params": specs, "opt": opt}


# ---------------------------------------------------------------------------
# ZeRO-1 optimizer-state specs
# ---------------------------------------------------------------------------
def _zero_spec(spec: tuple, shape: tuple[int, ...], mesh, dp: tuple[str, ...]) -> tuple:
    if not shape:
        return ()
    dp_size = _axis_size(mesh, dp if len(dp) > 1 else dp[0])
    cur = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = list(cur)
    for i, (dim, ax) in enumerate(zip(shape, cur)):
        if ax is None and dim % dp_size == 0:
            out[i] = dp if len(dp) > 1 else dp[0]
            return tuple(out)
    return cur


def opt_state_specs(opt_state: Params, p_specs: Params, mesh, zero1: bool = True,
                    cfg=None) -> Params:
    """Moments and masters mirror the parameter spec, plus ZeRO-1 data-axis
    sharding on the port's own leaf shape (the reference's rule; module
    docstring); 0-d placeholders (integer leaves) get ``()``.  ``cfg``
    gives the layer pattern's period (the tree walk's; 1 without)."""
    dp = dp_axes(mesh)

    def one(name, shape, n_lead, leaf, ps):
        if leaf.ndim == 0:
            return ()
        own = tuple(leaf.shape)
        spec = tuple(ps) if len(tuple(ps)) <= len(own) else ()
        return _zero_spec(spec, own, mesh, dp) if zero1 else spec

    return {"step": (),
            **{k: _map_stacked(one, opt_state[k], _period(cfg), p_specs)
               for k in ("m", "v", "master")}}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------
def _map_leaves(fn, tree, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


def batch_specs(batch: Params, mesh) -> Params:
    """Batch rows on the data axes where they divide."""
    dp = dp_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]

    def one(_, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return ()
        if shape[0] % _axis_size(mesh, dp_ax) == 0:
            return (dp_ax,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return _map_leaves(one, batch)


def cache_specs(cache: Params, cfg, mesh, batch_size: int,
                seq_len: int | None = None, seq_shard: bool = True) -> Params:
    """KV caches: batch on the data axes; the cache's sequence dim on
    ``model`` (attention stays local per rank, the reference's choice)."""
    dp = dp_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]
    dp_size = _axis_size(mesh, dp_ax)
    tp = mesh.shape["model"]

    def one(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        nd = len(shape)
        if nd == 0:
            return ()
        spec = [None] * nd
        batch_dim = None
        for i, d in enumerate(shape):
            if d == batch_size and d % dp_size == 0:
                spec[i] = dp_ax
                batch_dim = i
                break
        is_kv = name.endswith("['k']") or name.endswith("['v']") \
            or ".k" in name or ".v" in name
        if seq_shard and is_kv and seq_len and nd >= 4:
            for i in range(nd - 1, -1, -1):
                if i != batch_dim and shape[i] == seq_len and shape[i] % tp == 0:
                    spec[i] = "model"
                    break
        if batch_dim is None and all(s is None for s in spec):
            # batch unshardable (e.g. B=1): shard kv heads / feature dim
            for i in range(nd - 1, 0, -1):
                if spec[i] is None and shape[i] % tp == 0 and shape[i] >= tp \
                        and ("ssm" in name or "mlstm" in name):
                    spec[i] = "model"
                    break
        return tuple(spec)

    return _map_leaves(one, cache)


def decode_cache_specs(cache: Params, cfg, mesh, batch_size: int,
                       seq_shard: bool = True) -> Params:
    """A decode cache as a partitioned step keeps it, read from the
    family's own axes, never from a size (a cache's L, G, P or n_m can
    equal the batch, and a reduced config's ``head_dim`` its length, which
    the reference's :func:`cache_specs` would take): each leaf's batch
    axis (:meth:`repro_torch.models.model.LM.cache_spec`) over the data
    axes where ``batch_size`` divides them; a KV leaf's sequence axis over
    ``model`` where the reference's ``seq_shard`` splits it
    (:func:`seq_split` of the length the leaf holds, a whole cache's:
    it divides ``model``), every KV head whole; else the leaf's heads
    (:func:`repro_torch.models.transformer.cache_heads`) over ``model``
    where they divide it: a KV cache's KV heads, the hybrid's Mamba2
    ``ssm`` state at its heads and ``conv.x`` at their channels, the
    xLSTM's mLSTM ``c``, ``n`` and ``m`` at its heads; ``conv.b``,
    ``conv.c``, the mLSTM conv and sLSTM's state take rows only.  The
    recurrent state's heads split over ``model``, where the reference's
    rule places it by rows only: the partitioned step runs those heads
    on their own rank."""
    from repro_torch.models import cache as cache_mod  # deferred: rules over models
    from repro_torch.models import transformer
    from repro_torch.models.model import LM

    dp = dp_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]
    rows = dp_ax if batch_size % _axis_size(mesh, dp_ax) == 0 else None
    tp = mesh.shape.get("model", 1)
    split = seq_split(cfg, mesh, _kv_length(cache, cfg), seq_shard) is not None

    def one(ax, leaf, heads):
        spec = [None] * leaf.ndim
        spec[ax.batch] = rows
        if split and ax.seq is not None:
            spec[ax.seq] = "model"
        if heads is not None and tp > 1 and heads.heads % tp == 0:
            spec[heads.axis] = "model"
        return tuple(spec)

    return cache_mod.map_axes(one, LM(cfg).cache_spec(), cache,
                              transformer.cache_heads(cfg, seq_split=split))


def _kv_length(cache: Params, cfg) -> int | None:
    """The length of ``cache``'s KV leaves at the sequence axis
    :meth:`repro_torch.models.model.LM.cache_spec` names; None for a cache
    without one (the xLSTM's)."""
    from repro_torch.models import cache as cache_mod
    from repro_torch.models.model import LM

    found: list = []
    cache_mod.map_axes(lambda ax, t: found.append(t.shape[ax.seq]) if ax.seq is not None
                       else None, LM(cfg).cache_spec(), cache)
    return found[0] if found else None


def seq_split(cfg, mesh, seq_len: int | None, seq_shard: bool = True) -> int | None:
    """``seq_len`` where a decode step on ``mesh`` splits a
    ``seq_len``-position KV cache's sequence over ``model`` (the
    reference's ``cache_specs(seq_len=, seq_shard=True)``, its dry-run's
    default: ``model`` > 1 and the length divides it), else None; None too
    for a family without a KV leaf (the xLSTM's) and for no ``seq_len``,
    as the reference's rule splits nothing without one."""
    from repro_torch.models import cache as cache_mod
    from repro_torch.models.model import LM

    tp = mesh.shape.get("model", 1)
    if not (seq_shard and seq_len and tp > 1 and seq_len % tp == 0):
        return None
    kv: list = []
    cache_mod.map_axes(lambda ax: kv.append(ax.seq is not None), LM(cfg).cache_spec())
    return seq_len if any(kv) else None


# ---------------------------------------------------------------------------
# SPMD matmul plans for packed leaves
# ---------------------------------------------------------------------------
def packed_matmul_plans(params: Params, cfg, mesh) -> dict:
    """``{plan path: SpmdPlan}`` for every lead-less packed leaf: the plan of
    its resident spec (:func:`repro_torch.runtime.spmd.plan_from_spec`) — a
    sharded Kt grid dim becomes row parallelism, a sharded Nt dim column
    parallelism — so its product reads the block the rank holds."""
    plans = {}
    for path, ws, lead in sod.plan_leaves(params, _period(cfg)):
        leaf = ws[0]
        if not _is_packed(leaf) or lead:
            continue
        field = "vals" if isinstance(leaf, TiledCSC) else "block_vals"
        spec = _leaf_spec(f"{path}.{field}", tuple(getattr(leaf, field).shape), cfg, mesh)
        plans[path] = spmd.plan_from_spec(spec, mesh)
    return plans


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def _full(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def is_split(spec) -> bool:
    """Whether a leaf's spec tuple splits any dim."""
    return any(ax is not None for ax in tuple(spec))


def _block_nd(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of ``t`` under its spec tuple (a dim over several
    axes split row-major over them, as the reference's)."""
    for dim, ax in enumerate(_full(spec, t.ndim)):
        if ax is not None:
            n = _axis_size(mesh, ax)
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(_axes_of(ax)) * size, size)
    return t.contiguous()


def _unblock_nd(t: torch.Tensor, mesh, spec, kind: str) -> torch.Tensor:
    """Inverse of :func:`_block_nd`: the whole tensor from every rank's
    block (bytes over the mesh)."""
    for dim, ax in reversed(list(enumerate(_full(spec, t.ndim)))):
        if ax is not None:
            t = all_gather(t, mesh, _axes_of(ax), dim, kind)
    return t


def _unsplit(field: str, t: torch.Tensor) -> bool:
    """Fields that stay whole in a block: the codebook (a whole-matrix
    table) and an optimizer state's 0-d placeholder of an integer field."""
    return field == "codebook" or t.ndim < 2


def _grid_axes(leaf, spec):
    field = "vals" if isinstance(leaf, TiledCSC) else "block_vals"
    return _full(getattr(spec, field), 2)[:2]


def _resident(leaf, spec, mesh):
    """This rank's block of a whole packed leaf under its spec container:
    every field's block of its own spec (the tile-grid dims as the dense
    matrix's; an optimizer state's ZeRO-1 dim too)."""
    kt_ax, nt_ax = _grid_axes(leaf, spec)
    fields = {f: getattr(leaf, f) for f in PACKED_FIELDS[type(leaf)]}
    split = {f for f, t in fields.items()
             if t is not None and not _unsplit(f, t) and is_split(getattr(spec, f))}
    if not split:
        return dataclasses.replace(leaf, **{
            f: None if t is None else t.to(mesh.device) for f, t in fields.items()})
    kt, nt = leaf.grid
    bk, bn = leaf.tile
    k, n = leaf.shape
    local = {f: None if t is None else (
        _block_nd(t, mesh, getattr(spec, f)) if f in split else t).contiguous().to(mesh.device)
        for f, t in fields.items()}
    shape = ((kt // _axis_size(mesh, kt_ax)) * bk if kt_ax else k,
             (nt // _axis_size(mesh, nt_ax)) * bn if nt_ax else n)
    return dataclasses.replace(leaf, **local, shape=shape,
                               shard=Shard((k, n), (kt, nt), kt_ax, nt_ax))


def place(params: Params, specs: Params, mesh) -> Params:
    """The parameters as a rank holds them (the twin of ``to_shardings`` and
    ``device_put``): every leaf reduced to the block its spec names (a
    packed leaf's ``w.shard`` records where its block sits), each whole
    leaf whole; all on ``mesh.device`` but a 0-d tensor (an optimizer's
    step counter), which stays where it is.  Optimizer states and batches
    place the same way under :func:`opt_state_specs` and
    :func:`batch_specs`."""
    if _is_packed(params):
        return _resident(params, specs, mesh)
    if isinstance(params, dict):
        return {k: place(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(place(v, s, mesh) for v, s in zip(params, specs))
    if isinstance(params, torch.Tensor):
        if not params.ndim:         # a step counter stays where it is
            return params
        if is_split(specs):
            params = _block_nd(params, mesh, specs)
        return params.to(mesh.device)
    return params


def _unblocked(leaf, spec, mesh):
    """The whole packed leaf from every rank's resident block (bytes)."""
    if leaf.shard is None:
        return leaf
    kt_ax, nt_ax = _grid_axes(leaf, spec)
    if (kt_ax, nt_ax) != (leaf.shard.kt_axis, leaf.shard.nt_axis):
        raise ValueError(f"spec axes {(kt_ax, nt_ax)} are not the block's "
                         f"{(leaf.shard.kt_axis, leaf.shard.nt_axis)}")
    fields = {f: t if t is None or _unsplit(f, t) else
              _unblock_nd(t, mesh, getattr(spec, f), "reshard_bytes")
              for f, t in ((f, getattr(leaf, f)) for f in PACKED_FIELDS[type(leaf)])}
    return dataclasses.replace(leaf, **fields, shape=leaf.shard.shape, shard=None)


def unplace(params: Params, specs: Params, mesh) -> Params:
    """The inverse of :func:`place` (the twin of ``device_get`` on sharded
    arrays): every leaf's blocks gathered back, as bytes over the mesh,
    into the whole leaf.  A collective: every rank of the mesh calls it
    and gets the whole tree."""
    if _is_packed(params):
        return _unblocked(params, specs, mesh)
    if isinstance(params, dict):
        return {k: unplace(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(unplace(v, s, mesh) for v, s in zip(params, specs))
    if isinstance(params, torch.Tensor) and params.ndim and is_split(specs):
        return _unblock_nd(params, mesh, specs, "reshard_bytes")
    return params


def _spec_axes(spec) -> tuple[str, ...]:
    return tuple(a for ax in tuple(spec) for a in _axes_of(ax))


def split_axes(tree: Params, specs: Params | None = None) -> list[tuple[str, ...]]:
    """The mesh axes each tensor leaf of a placed tree is split over, in the
    walk order of :func:`repro_torch.core.tree.tree_leaves`: with ``specs``
    (:func:`place`'s, or :func:`layout_specs` of the tree) each leaf's
    spec's axes; without, a packed leaf's blocked fields its resident
    block's Kt and Nt axes and every other leaf none."""
    if _is_packed(tree):
        if specs is not None:
            return [() if _unsplit(f, t) else _spec_axes(getattr(specs, f))
                    for f in PACKED_FIELDS[type(tree)] if (t := getattr(tree, f)) is not None]
        shard = tree.shard
        axes = tuple(a for a in (shard.kt_axis, shard.nt_axis) if a) if shard else ()
        return [() if _unsplit(f, t) else axes
                for f in PACKED_FIELDS[type(tree)] if (t := getattr(tree, f)) is not None]
    if isinstance(tree, dict):
        return [a for k, v in tree.items()
                for a in split_axes(v, None if specs is None else specs[k])]
    if isinstance(tree, (list, tuple)):
        return [a for i, v in enumerate(tree)
                for a in split_axes(v, None if specs is None else specs[i])]
    if isinstance(tree, torch.Tensor):
        return [_spec_axes(specs) if specs is not None and tree.ndim else ()]
    return []


def whole(tree: Params) -> Params:
    """``tree`` with every packed leaf's metadata the whole operand's (its
    ``shape`` the global one, no ``shard``): for fields that hold the whole
    grid again, such as a checkpoint read into a placed template."""
    if _is_packed(tree):
        return dataclasses.replace(tree, shape=tuple(tree.global_shape), shard=None)
    if isinstance(tree, dict):
        return {k: whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(whole(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# a placed tree's layout, and its plain leaves whole again
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _whole_specs(cfg, axis_sizes: tuple, axis_names: tuple):
    """The config's whole parameter shapes (meta) and their specs."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import LM  # deferred: runtime rules over models

    raw = LM(cfg).init(torch.Generator(), "meta")
    return raw, param_specs(raw, cfg, AbstractMesh(axis_sizes, axis_names))


def _effective(tree, raw, spec):
    if _is_packed(tree):
        kt_ax, nt_ax = (tree.shard.kt_axis, tree.shard.nt_axis) if tree.shard else (None, None)
        return spmd.packed_specs(tree, kt_ax, nt_ax)
    if isinstance(tree, dict):
        return {k: _effective(v, raw.get(k) if isinstance(raw, dict) else None,
                              spec.get(k) if isinstance(spec, dict) else None)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        same = isinstance(raw, (list, tuple)) and len(raw) == len(tree)
        return type(tree)(_effective(v, raw[i] if same else None, spec[i] if same else None)
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        if (isinstance(raw, torch.Tensor) and tuple(tree.shape) != tuple(raw.shape)
                and isinstance(spec, tuple)):
            return spec
        return ()
    return None


def layout_specs(tree: Params, cfg, mesh) -> Params:
    """The specs of ``tree`` as it lies on ``mesh``: a packed leaf's its
    resident block's (``w.shard``), a plain leaf's its spec where it is
    smaller than the config's whole leaf (placed), ``()`` where it is
    whole.  What the optimizer's clip (:func:`split_axes`) and
    :func:`gather_plain` read; placed or whole trees alike."""
    raw, specs = _whole_specs(cfg, tuple(mesh.axis_sizes), tuple(mesh.axis_names))
    return _effective(tree, raw, specs)


def split_plain(tree: Params, specs: Params) -> list[torch.Tensor]:
    """The plain tensor leaves of ``tree`` that ``specs`` splits."""
    if _is_packed(tree):
        return []
    if isinstance(tree, dict):
        return [t for k, v in tree.items() for t in split_plain(v, specs[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v, s in zip(tree, specs) for t in split_plain(v, s)]
    if isinstance(tree, torch.Tensor) and tree.ndim and is_split(specs):
        return [tree]
    return []


def gather_plain(tree: Params, specs: Params, mesh) -> Params:
    """``tree`` with every split plain leaf whole again (packed leaves as
    they lie): all-gathered over its spec's axes, differentiably while
    autograd records (each rank's gradient its own block,
    :func:`repro_torch.runtime.spmd.gather_rows`)."""
    if _is_packed(tree):
        return tree
    if isinstance(tree, dict):
        return {k: gather_plain(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_plain(v, s, mesh) for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor) and tree.ndim and is_split(specs):
        for dim, ax in reversed(list(enumerate(_full(specs, tree.ndim)))):
            if ax is not None:
                tree = spmd.gather_rows(tree, mesh, _axes_of(ax), dim)
    return tree
