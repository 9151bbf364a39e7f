"""Sparse-on-Dense as a composable module: config, packing, apply.

Twin of :mod:`repro.core.sod` for the ``tiled_csc`` and ``block_csr``
modes, in every ``qmode``: :class:`SoDConfig` says how projection weights
are stored, :func:`pack_param` and :func:`sodify_params` prune, pack and
quantize them — with a global config, or per layer under a
:class:`~repro_torch.core.plan.ModelPlan` — and :func:`apply` is the one
matmul entry point every model layer calls: dense tensors bypass
decompression, packed operands dispatch through the kernel registry
(:func:`repro_torch.kernels.ops.sod_matmul`) with their layer's plan.

The port keeps per-layer dicts in ``params["layers"]`` (the recurrent
families in ``mamba_blocks[g][j]``, ``mlstm_blocks[g][j]`` and
``slstm_blocks[g]``); a plan keeps the reference's paths and stacks:
``layers[l].attn.wq`` is the plan's ``.blocks.attn.wq`` with
``lead=(groups, period)``, ``mamba_blocks[g][j].mamba.w_z`` is
``.mamba_blocks.mamba.w_z`` with lead (G, P), one entry (and one ``cap``)
for the whole stack, so a plan file of either package replays in the
other (:func:`plan_leaves`).  An MoE layer's routed experts are one
``(E, d, f)`` leaf: its entry's lead is ``(groups, period, E)``, each
expert pruned on its own, and each layer gets an ``(E,)``-stacked pack,
which :func:`repro_torch.models.moe.moe_mlp` refuses, as the reference
does (fault R4: serve MoE under a plan without routed-expert entries).
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Any, Iterator

import torch
import torch.nn.functional as F

from repro_torch.core import formats, pruning
from repro_torch.core import plan as plan_mod
from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.plan import QMODES, ModelPlan, PackPlan

__all__ = ["SoDConfig", "DENSE", "prune_weight", "pack_param", "apply",
           "sodify_params", "sodify_abstract", "plan_leaves", "weight_bytes",
           "tree_weight_bytes", "expected_cap"]

IMPLS = ("auto", "jnp", "cuda", "pallas")


@dataclasses.dataclass(frozen=True)
class SoDConfig:
    """Storage/compute mode for the model's projection weights."""

    mode: str = "dense"            # dense | tiled_csc | block_csr
    density: float = 1.0           # pruning target (1.0 = keep as-is)
    prune_method: str = "magnitude"  # magnitude | block | nm
    tile: tuple[int, int] = (128, 128)
    br: int = 8                    # BlockCSR sub-block rows
    impl: str = "auto"             # auto | jnp | cuda (pallas: the same as cuda)
    min_dim: int = 128             # matrices smaller than this stay dense
    qmode: str = "none"            # none | int8 | fp8 | codebook

    def __post_init__(self):
        if self.mode not in ("dense", "tiled_csc", "block_csr"):
            raise ValueError(f"unknown SoD mode {self.mode!r}")
        _check_method(self.prune_method)
        if self.impl not in IMPLS:
            raise ValueError(f"unknown SoD impl {self.impl!r} (expected one of "
                             f"{IMPLS})")
        if self.qmode not in QMODES:
            raise ValueError(f"unknown SoD qmode {self.qmode!r}")

    @property
    def enabled(self) -> bool:
        """True when a Sparse-on-Dense mode is configured."""
        return self.mode != "dense"


def _check_method(method: str) -> None:
    if method not in ("magnitude", "block", "nm"):
        raise ValueError(f"unknown prune method {method!r}")


DENSE = SoDConfig()


def prune_weight(w: torch.Tensor, density: float, method: str = "magnitude",
                 tile: tuple[int, int] = (128, 128), br: int = 8) -> torch.Tensor:
    """Prune one 2-D weight to ``density`` with the named method:
    unstructured magnitude, whole (br, tile[1]) blocks by L2 norm, or N:8
    along K (N = round(8 · density), at least 1; K padded to a multiple of 8
    for the grouping)."""
    _check_method(method)
    if density >= 1.0:
        return w
    if method == "block":
        return pruning.block_prune(w, density, block=(br, tile[1]))
    if method == "nm":
        m = 8
        n = max(int(round(density * m)), 1)
        pad = (-w.shape[0]) % m
        return pruning.nm_prune(F.pad(w, (0, 0, 0, pad)), n=n, m=m,
                                axis=0)[: w.shape[0]]
    return pruning.magnitude_prune(w, density)


def _prune_leaf(w: torch.Tensor, density: float, method: str, tile, br: int
                ) -> torch.Tensor:
    """:func:`prune_weight` of one layer's leaf: a 2-D weight as it is, a
    stacked one (the routed experts' (E, d, f)) one matrix at a time, as
    the reference's ``_prune_leaf``."""
    if w.ndim == 2:
        return prune_weight(w, density, method, tile, br)
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    return torch.stack([prune_weight(m, density, method, tile, br)
                        for m in flat]).reshape(w.shape)


def _pack(w: torch.Tensor, mode: str, tile, br: int, qmode: str,
          cap: int | None = None, bcap: int | None = None):
    """Pack a (possibly stacked) pruned weight in ``mode`` and quantize it
    (a stack is quantized as one: a scale per layer and tile, a codebook per
    layer)."""
    if mode == "tiled_csc":
        return formats.pack_tiled_csc(w, tile=tile, cap=cap, qmode=qmode)
    return formats.pack_block_csr(w, tile=tile, br=br, bcap=bcap, qmode=qmode)


def pack_param(w: torch.Tensor, cfg: SoDConfig, prune: bool = True):
    """Prune (optional) and pack one dense 2-D weight per the config; the
    dense tensor comes back unchanged when the config is dense or the
    matrix is smaller than ``cfg.min_dim``."""
    if not cfg.enabled or w.ndim != 2 or min(w.shape) < cfg.min_dim:
        return w
    if prune:
        w = prune_weight(w, cfg.density, cfg.prune_method, cfg.tile, cfg.br)
    return _pack(w, cfg.mode, cfg.tile, cfg.br, cfg.qmode)


def _layout_key(w) -> tuple:
    """Layout signature of a packed operand (of the whole one, for a
    rank's resident block) — matches
    :meth:`repro_torch.core.plan.PackPlan.layout_key`."""
    if isinstance(w, TiledCSC):
        return ("tiled_csc", w.global_shape, tuple(w.tile), w.cap, 0, w.qmode)
    return ("block_csr", w.global_shape, tuple(w.tile), w.bcap, w.br, w.qmode)


def _plan_spmd(entry: PackPlan):
    """The :class:`repro_torch.runtime.spmd.SpmdPlan` of a plan entry's
    serialized ``spmd`` fields — only under an active mesh of the plan's
    own signature, and never inside a rank's local product."""
    from repro_torch.runtime import spmd as spmd_mod  # deferred: runtime over core

    mesh = spmd_mod.active_mesh()
    if mesh is None or spmd_mod.in_spmd_body():
        return None
    mp = plan_mod.active_plan()
    if mp is not None and mp.mesh and mp.mesh != spmd_mod.mesh_key(mesh):
        return None  # the plan was built for another mesh
    sp = spmd_mod.SpmdPlan.from_dict(entry.spmd)
    if not set(sp.axes()) <= set(mesh.axis_names):
        return None
    return sp


def apply(x: torch.Tensor, w, cfg: SoDConfig | None = None,
          plan: PackPlan | None = None, **kw) -> torch.Tensor:
    """``x @ W`` through the Sparse-on-Dense datapath.

    Packed operands dispatch through the kernel registry: ``impl="auto"``
    takes the tuning cache's winner for this (layout, M bucket, backend) or
    the prior's choice on a cold cache (the CUDA kernel on a CUDA tensor,
    the plain version on a CPU one); ``impl`` may force ``cuda`` (or
    ``pallas``) or ``jnp``.

    ``plan`` is the layer's :class:`~repro_torch.core.plan.PackPlan` (model
    blocks pass it); when omitted and a
    :class:`~repro_torch.core.plan.ModelPlan` is active
    (:func:`repro_torch.core.plan.use_plan`), the operand's layout signature
    finds it.  The plan supplies the impl hint, the tuned dispatch
    parameters (which seed a cold cache only) and, under an active mesh,
    the layer's SPMD partition plan; explicit kwargs always win.
    """
    from repro_torch.kernels import ops  # local import: kernels depend on core

    if isinstance(w, (TiledCSC, BlockCSR)):
        if plan is None:
            plan = plan_mod.lookup_active(_layout_key(w))
        if plan is not None:
            # an explicit impl= from the caller disables the plan's impl hint
            # AND its params
            user_forced = "impl" in kw
            if not user_forced and plan.impl != "auto":
                kw["impl"] = plan.impl
            if (plan.dispatch_params and not user_forced
                    and "fallback_params" not in kw):
                kw["fallback_params"] = plan.dispatch_params
            if plan.spmd and kw.get("spmd", "auto") == "auto":
                sp = _plan_spmd(plan)
                if sp is not None:
                    kw["spmd"] = sp
        impl = kw.pop("impl", cfg.impl if cfg else "auto")
        return ops.sod_matmul(x, w, impl=impl, **kw)
    kw.pop("impl", None)
    return ops.dense_matmul(x, w, kw.pop("out_dtype", None) or x.dtype)


_SOD_PATHS = re.compile(
    r"(wq|wk|wv|wo|w_gate|w_up|w_down|head|w_z|w_x|out_proj)$")


def expected_cap(bk: int, density: float) -> int:
    """Static per-column slot budget for Bernoulli(density) sparsity: mean +
    4σ of Binomial(bk, density), aligned to 8 (the math lives in
    :mod:`repro_torch.core.plan`; this keeps the reference's name here)."""
    return plan_mod.expected_cap(bk, density)


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _named_leaves(v, name)
        else:
            yield name, v


def _get(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return tree


def _set(tree, name, value):
    *path, last = name.split(".")
    for part in path:
        tree = tree[part]
    tree[last] = value


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


def _flat(blocks: list) -> tuple[list, tuple[int, ...]]:
    """A stack's per-block trees in order, and its nesting dims: a list of
    G groups of P blocks is (G, P), a flat list of G blocks (G,)."""
    if blocks and isinstance(blocks[0], list):
        return [b for g in blocks for b in g], (len(blocks), len(blocks[0]))
    return list(blocks), (len(blocks),)


def _stacks(params: dict[str, Any], period: int):
    """``(reference stack name, per-block trees, lead)`` of every list in
    the tree: the attention family's ``layers`` is the reference's
    ``blocks`` with lead ``(layers // period, period)``; the recurrent
    families' ``mamba_blocks``, ``mlstm_blocks`` (lists of groups) and
    ``slstm_blocks`` keep their names and take their nesting as lead."""
    for key, v in params.items():
        if key == "layers":
            yield "blocks", list(v), (len(v) // period, period)
        elif isinstance(v, list):
            yield (key, *_flat(v))


def plan_leaves(params: dict[str, Any], period: int = 1
                ) -> Iterator[tuple[str, list[torch.Tensor], tuple[int, ...]]]:
    """``(plan path, tensors, lead)`` of every leaf, in the reference's
    naming and stacking: a leaf ``<name>`` of every block of a stack
    (:func:`_stacks`: ``layers[l]``, ``mamba_blocks[g][j]``,
    ``mlstm_blocks[g][j]``, ``slstm_blocks[g]``) is the stacked leaf
    ``.<stack>.<name>`` with the stack's lead and the leaf's own stack dims
    (an MoE layer's ``E`` routed experts) after it; any other leaf
    ``<name>``, in a dict of the top level too (the hybrid's
    ``shared_attn``), is ``.<name>`` with no lead.  ``period`` is the
    attention family's layer-pattern period (1 for llama)."""
    for name, leaf in _named_leaves({k: v for k, v in params.items()
                                     if not isinstance(v, list)}):
        yield f".{name}", [leaf], ()
    for stack, blocks, lead in _stacks(params, period):
        if not blocks:
            continue
        for name, leaf in _named_leaves(blocks[0]):
            own = tuple(int(d) for d in leaf.shape[:-2])
            yield (f".{stack}.{name}", [_get(block, name) for block in blocks],
                   lead + own)


def _packable(name: str, shape) -> bool:
    return len(shape) >= 2 and _SOD_PATHS.search(name) is not None


def _check_plan_truncation(name: str, ws: list[torch.Tensor], packed) -> None:
    """Warn when a plan's fixed capacity dropped non-zeros (a plan built from
    abstract shapes budgets capacities statistically; packing still succeeds,
    keeping the largest values, but the replay is then lossy — never
    silently)."""
    total = sum(int(torch.count_nonzero(w)) for w in ws)
    if isinstance(packed, TiledCSC):
        stored = int((packed.rows >= 0).sum())
    else:   # invalid blocks are zeroed; valid blocks store raw values
        stored = int(torch.count_nonzero(packed.block_vals))
    if stored < total:
        warnings.warn(
            f"pack plan capacity truncated {total - stored} of {total} "
            f"non-zeros on {name!r} (cap budget below the data's "
            f"requirement); re-plan against concrete weights or raise the "
            f"entry's cap/bcap", stacklevel=3)


def _pack_planned(name: str, ws: list[torch.Tensor], entry: PackPlan,
                  prune: bool):
    """Prune and pack one stacked leaf (its layers ``ws``) per its
    :class:`~repro_torch.core.plan.PackPlan`: the plan's explicit
    ``cap``/``bcap``, not the data, size the containers, so a plan replays
    with byte-identical layouts and hence identical tuning-cache keys.
    Returns the per-layer results: pruned dense tensors for a ``dense``
    entry (the plan chooses the storage format, not whether the layer is
    sparse), else each layer's slice of the stacked pack."""
    if prune and entry.density < 1.0:
        ws = [_prune_leaf(w, entry.density, entry.prune_method, entry.tile,
                          entry.br) for w in ws]
    if entry.mode == "dense":
        return ws
    stack = torch.stack(ws)
    packed = _pack(stack, entry.mode, entry.tile, entry.br, "none",
                   cap=entry.cap, bcap=entry.bcap)
    # truncation is judged on the unquantized pack: quantization may round
    # small survivors to code 0, which is lossy by design, not capacity loss
    _check_plan_truncation(name, ws, packed)
    del stack
    if entry.qmode != "none":
        packed = formats.quantize_packed(packed, entry.qmode)
    return [packed.layer(i) for i in range(len(ws))]


def sodify_params(params: dict[str, Any], cfg: SoDConfig, prune: bool = True,
                  plan: ModelPlan | None = None) -> dict[str, Any]:
    """Prune, pack and quantize every eligible projection weight.

    Without a plan: the reference's global-config, stacked-leaf path — each
    projection pruned per layer, the whole layer stack packed with one
    shared data-dependent (lossless) ``cap`` or ``bcap`` and quantized, each
    layer given its slice.  With a :class:`~repro_torch.core.plan.ModelPlan`
    (:mod:`repro_torch.runtime.planner`) each plan path follows its own
    entry — format, tile, explicit capacity, qmode — and unplanned leaves
    stay as they are (strict replay).  Returns a new tree; the input's
    tensors are not modified.
    """
    if plan is None and not cfg.enabled:
        return params
    out = _copy(params)
    for path, ws, _ in plan_leaves(params):
        if plan is not None:
            entry = plan.get(path)
            if entry is None:
                continue
            packed = _pack_planned(path, ws, entry, prune)
        elif _packable(path, ws[0].shape) and min(ws[0].shape[-2:]) >= cfg.min_dim:
            stack = torch.stack([_prune_leaf(w, cfg.density, cfg.prune_method,
                                             cfg.tile, cfg.br) if prune else w
                                 for w in ws])
            whole = _pack(stack, cfg.mode, cfg.tile, cfg.br, cfg.qmode)
            del stack
            packed = [whole.layer(i) for i in range(len(ws))]
        else:
            continue
        _place(out, path, packed)
    return out


def _place(tree: dict[str, Any], path: str, per_block: list) -> None:
    """Set a plan path's per-block results back into the port's tree."""
    name = path.strip(".")
    stack, _, rest = name.partition(".")
    stack = "layers" if stack == "blocks" else stack
    if isinstance(tree.get(stack), list):
        for block, value in zip(_flat(tree[stack])[0], per_block):
            _set(block, rest, value)
    else:
        _set(tree, name, per_block[0])


# ---------------------------------------------------------------------------
# abstract packing: shapes only, on device="meta" (the reference's
# ShapeDtypeStructs)
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_qside(kt: int, nt: int, dtype, qmode: str, lead=()):
    """(value dtype, scale, codebook) of an abstract quantized pack: an f32
    scale per tile for int8/fp8, a shared-value table for codebook."""
    if qmode == "none":
        return dtype, None, None
    if qmode == "codebook":
        return torch.int8, None, _meta(lead + (formats.CODEBOOK_SIZE,), torch.float32)
    scale = _meta(lead + (kt, nt), torch.float32)
    return (formats.fp8_dtype() if qmode == "fp8" else torch.int8), scale, None


def abstract_tiled(k: int, n: int, dtype, tile, cap: int,
                   qmode: str = "none", lead: tuple[int, ...] = ()) -> TiledCSC:
    """A TiledCSC of meta tensors with this exact layout (``lead``: stack
    dims ahead of the grid, an MoE layer's experts)."""
    bk, bn = tile
    kt, nt = -(-k // bk), -(-n // bn)
    lead = tuple(lead)
    vdt, scale, codebook = _abstract_qside(kt, nt, dtype, qmode, lead)
    idx = torch.int8 if bk <= 128 else torch.int32
    return TiledCSC(vals=_meta(lead + (kt, nt, cap, bn), vdt),
                    rows=_meta(lead + (kt, nt, cap, bn), idx), shape=(k, n),
                    tile=tuple(tile), scale=scale, codebook=codebook, qmode=qmode)


def abstract_block(k: int, n: int, dtype, tile, br: int, bcap: int,
                   qmode: str = "none", lead: tuple[int, ...] = ()) -> BlockCSR:
    """A BlockCSR of meta tensors with this exact layout."""
    bk, bn = tile
    kt, nt = -(-k // bk), -(-n // bn)
    lead = tuple(lead)
    vdt, scale, codebook = _abstract_qside(kt, nt, dtype, qmode, lead)
    return BlockCSR(block_vals=_meta(lead + (kt, nt, bcap, br, bn), vdt),
                    block_ids=_meta(lead + (kt, nt, bcap), torch.int32),
                    tile_nnz=_meta(lead + (kt, nt), torch.int32), shape=(k, n),
                    tile=tuple(tile), br=br, scale=scale, codebook=codebook,
                    qmode=qmode)


def sodify_abstract(params: dict[str, Any], cfg: SoDConfig,
                    plan: ModelPlan | None = None) -> dict[str, Any]:
    """:func:`sodify_params` over shapes: ``params`` of ``device="meta"``
    tensors (any device works: only shapes and dtypes are read) become
    packed containers of meta tensors with deterministic capacities — each
    plan entry's explicit ``cap``/``bcap``, the exact layouts
    :func:`sodify_params` produces under the same plan; without a plan the
    shared sizing functions' budgets (:func:`~repro_torch.core.plan.
    tiled_cap` / :func:`~repro_torch.core.plan.block_bcap`)."""
    if plan is None and not cfg.enabled:
        return params
    out = _copy(params)
    for path, ws, _ in plan_leaves(params):
        if plan is not None:
            e = plan.get(path)
            if e is None or e.mode == "dense":
                continue
            mode, tile, br, qmode = e.mode, e.tile, e.br, e.qmode
            cap = e.cap if e.cap is not None else plan_mod.tiled_cap(tile[0], e.density)
            bcap = e.bcap if e.bcap is not None else plan_mod.block_bcap(
                tile[0] // br, e.density, e.prune_method, br * tile[1])
        elif _packable(path, ws[0].shape) and min(ws[0].shape[-2:]) >= cfg.min_dim:
            mode, tile, br, qmode = cfg.mode, cfg.tile, cfg.br, cfg.qmode
            cap = plan_mod.tiled_cap(tile[0], cfg.density)
            bcap = plan_mod.block_bcap(tile[0] // br, cfg.density,
                                       cfg.prune_method, br * tile[1])
        else:
            continue
        k, n = ws[0].shape[-2:]
        own = tuple(ws[0].shape[:-2])      # an MoE layer's experts stay stacked
        one = (abstract_tiled(k, n, ws[0].dtype, tile, cap, qmode, own)
               if mode == "tiled_csc" else
               abstract_block(k, n, ws[0].dtype, tile, br, bcap, qmode, own))
        _place(out, path, [one] * len(ws))
    return out


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------
def weight_bytes(w, value_bits: int | None = None) -> int:
    """Bytes this operand occupies (compressed when packed, at its own
    qmode's width and side band); a dense tensor at 16 bits an element, or
    ``value_bits``."""
    if isinstance(w, (TiledCSC, BlockCSR)):
        return w.nbytes_compressed()
    if isinstance(w, torch.Tensor):
        return w.numel() * (16 if value_bits is None else value_bits) // 8
    return 0


def _all_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _all_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _all_leaves(v)
    else:
        yield tree


def tree_weight_bytes(params: Any) -> dict[str, float]:
    """Compressed vs dense byte totals over a parameter tree: packed leaves
    at their qmode's width plus side band, dense leaves at 16 bits per
    element on both sides, and compressed / dense, as in the reference."""
    compressed = dense = 0
    for leaf in _all_leaves(params):
        if isinstance(leaf, (TiledCSC, BlockCSR)):
            compressed += leaf.nbytes_compressed()
            dense += leaf.nbytes_dense()
        elif isinstance(leaf, torch.Tensor):
            compressed += leaf.numel() * 2
            dense += leaf.numel() * 2
    return {"compressed": compressed, "dense": dense,
            "ratio": compressed / max(dense, 1)}
