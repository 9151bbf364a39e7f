"""AdamW with float32 master weights over packed (Sparse-on-Dense) parameter
trees — twin of :mod:`repro.optim.adamw`.

Packed containers contribute *compressed-sized* moments (the paper's
effective-capacity argument applied to optimizer state): a ``TiledCSC``'s
moments are ``TiledCSC``-shaped trees whose ``vals`` moments have the shape
of the stored slots.  Integer leaves (``rows``, ``block_ids``,
``tile_nnz``, int8 codes and codebook indices) and leaves without a
gradient pass through untouched; their moments and master are 0-d
placeholders.  float8 codes are float leaves, as in the reference.

The step counter is a 0-d int32 tensor on the CPU, so a schedule's value
never waits on the card.  On a mesh a state placed under ZeRO-1
(:func:`repro_torch.runtime.sharding.opt_state_specs`) holds, for a leaf
whose moments are smaller than the parameter, the rank's block over the
data axes: the rank updates that block of m, v and master from its block
of the (whole over the data axes, already summed) gradient, and the new
parameters are all-gathered over the data axes, every leaf's block in one
collective.  ``update`` applies the reference's formula with
``torch._foreach_*`` over all float leaves at once, in place on the
state's moments and master weights, and returns fresh parameter tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.tree import leaves_along, max_rel_dist, tree_leaves, tree_map

Params = Any


def _is_float(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def _sq_norm(params: Params, live: list[int], gs: list[torch.Tensor], mesh,
             specs=None) -> torch.Tensor:
    """The squared global norm of ``gs`` (the float gradients at the leaves
    ``live``), summed over the mesh where a leaf is split (``specs``: the
    parameters' layout, :func:`repro_torch.runtime.sharding.layout_specs`;
    without, only packed leaves' resident blocks count as split)."""
    norms = torch._foreach_norm(gs)
    if mesh is None:
        return sum(n * n for n in norms)
    from repro_torch.runtime import sharding, spmd

    axes = sharding.split_axes(params, specs)
    by_axes: dict[tuple[str, ...], torch.Tensor] = {}
    for i, n in zip(live, norms):
        by_axes[axes[i]] = by_axes.get(axes[i], 0) + n * n
    return sum(spmd.all_reduce(sq, mesh, a) if a else sq for a, sq in sorted(by_axes.items()))


def state_dist(got: Params, want: Params) -> dict:
    """How far two whole train states ``{"params", "opt"}`` lie apart, leaf
    by leaf (:func:`repro_torch.core.tree.max_rel_dist`): the parameters,
    the moments and the masters, and whether the step counters agree."""
    return {"params": max_rel_dist(got["params"], want["params"]),
            **{k: max_rel_dist(got["opt"][k], want["opt"][k]) for k in ("m", "v", "master")},
            "step_equal": int(got["opt"]["step"]) == int(want["opt"]["step"])}


def _zero_blocks(mesh, ps: list, ms: list) -> dict:
    """``{j: (dim, start, size)}`` for each leaf whose moment is the rank's
    ZeRO-1 block of its parameter: the first dim they differ on, split
    over the data axes."""
    if mesh is None:
        return {}
    from repro_torch.launch.mesh import dp_axes

    dp = dp_axes(mesh)
    out = {}
    for j, (p, m) in enumerate(zip(ps, ms)):
        if tuple(m.shape) != tuple(p.shape):
            dim = next(d for d, (a, b) in enumerate(zip(p.shape, m.shape)) if a != b)
            out[j] = (dim, mesh.index(dp) * m.shape[dim], m.shape[dim])
    return out


def _gather_blocks(mesh, blocks: list, where: list) -> list:
    """Every rank's block of each leaf over the data axes, put together on
    its ZeRO-1 dim: one all-gather of all the blocks' bytes."""
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.runtime import spmd

    flat = [b.contiguous().reshape(-1).view(torch.uint8) for b in blocks]
    sizes = [f.numel() for f in flat]
    parts = spmd.all_gather(torch.cat(flat), mesh, dp_axes(mesh), 0, "zero_bytes")
    n = parts.numel() // sum(sizes)
    per_rank = [list(torch.split(r, sizes)) for r in parts.reshape(n, -1)]
    return [torch.cat([per_rank[r][i].clone().view(b.dtype).reshape(b.shape)
                       for r in range(n)], dim)
            for i, (b, (dim, _, _)) in enumerate(zip(blocks, where))]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """The reference's hyper-parameters and defaults."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Functional AdamW: ``init(params)`` and ``update(params, grads,
    state) -> (params, state, {"grad_norm", "lr"})``."""

    cfg: AdamWConfig
    schedule: Callable | None = None    # step -> learning rate

    def init(self, params: Params) -> Params:
        """``{"step", "m", "v", "master"}``: zero float32 moments and a
        float32 copy of every float leaf, 0-d placeholders elsewhere."""
        def moments(p):
            shape = p.shape if _is_float(p) else ()
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def master(p):
            if _is_float(p):
                return p.detach().to(torch.float32, copy=True)
            return torch.zeros((), dtype=torch.float32, device=p.device)

        return {"step": torch.zeros((), dtype=torch.int32),
                "m": tree_map(moments, params), "v": tree_map(moments, params),
                "master": tree_map(master, params)}

    def update(self, params: Params, grads: Params, state: Params, mesh=None,
               specs: Params | None = None):
        """One step: the global-norm clip over all float gradients, then
        bias-corrected AdamW with decoupled weight decay on the masters.

        With ``mesh`` (the placed parameters of one rank,
        :func:`repro_torch.runtime.sharding.place`, and their whole
        gradients' blocks) the norm is the whole tree's: a split leaf holds
        only its share, so the squares of each set of split axes
        (``specs``, the parameters' layout) are summed over them, and every
        split leaf counts once.  A leaf whose moments are the rank's
        ZeRO-1 block (smaller than the parameter) is updated on that block
        and its new parameter gathered over the data axes."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = float(self.schedule(step) if self.schedule else cfg.lr)

        flat_p, flat_g = tree_leaves(params), leaves_along(params, grads)
        flat_m, flat_v = tree_leaves(state["m"]), tree_leaves(state["v"])
        flat_w = tree_leaves(state["master"])
        live = [i for i, (p, g) in enumerate(zip(flat_p, flat_g))
                if _is_float(p) and g is not None]
        gs = [flat_g[i].float() for i in live]
        ms, vs, ws = ([flat[i] for i in live] for flat in (flat_m, flat_v, flat_w))

        # global-norm clip over the float gradients
        sq = _sq_norm(params, live, gs, mesh, specs) if gs else torch.zeros(())
        zero = _zero_blocks(mesh, [flat_p[i] for i in live], ms)
        for j, (dim, start, size) in zero.items():
            gs[j] = gs[j].narrow(dim, start, size)
        gnorm = torch.sqrt(sq + 1e-20)
        # min(1, clip / gnorm) in float64 on the device: a host float's
        # numbers without reading the norm back (meta tensors have none)
        clip = torch.clamp(cfg.grad_clip / gnorm.double(), max=1.0)
        bc1 = 1 - cfg.b1 ** float(step)
        bc2 = 1 - cfg.b2 ** float(step)
        if gs:
            gs = torch._foreach_mul(gs, clip)
            torch._foreach_mul_(ms, cfg.b1)                      # m = b1 m + (1-b1) g
            torch._foreach_add_(ms, gs, alpha=1 - cfg.b1)
            torch._foreach_mul_(vs, cfg.b2)                      # v = b2 v + (1-b2) g²
            torch._foreach_addcmul_(vs, gs, gs, value=1 - cfg.b2)
            del gs
            denom = torch._foreach_div(vs, bc2)                  # sqrt(v / bc2) + eps
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, cfg.eps)
            upd = torch._foreach_div(ms, bc1)                    # (m / bc1) / denom
            torch._foreach_div_(upd, denom)
            del denom
            torch._foreach_add_(upd, ws, alpha=cfg.weight_decay)  # w -= lr (upd + wd w)
            torch._foreach_add_(ws, upd, alpha=-lr)
            del upd
        new = list(flat_p)
        for i in live:
            new[i] = flat_w[i].to(flat_p[i].dtype, copy=True)
        if zero:
            whole = _gather_blocks(mesh, [new[live[j]] for j in zero], list(zero.values()))
            for j, t in zip(zero, whole):
                new[live[j]] = t
        it = iter(new)
        new_params = tree_map(lambda p: next(it), params)
        new_state = {"step": step, "m": state["m"], "v": state["v"],
                     "master": state["master"]}
        return new_params, new_state, {"grad_norm": gnorm,
                                       "lr": torch.tensor(lr, dtype=torch.float32)}
