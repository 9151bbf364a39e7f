"""Pruning — produces the sparse weights that Sparse-on-Dense consumes.

Twin of :mod:`repro.core.pruning`: unstructured magnitude pruning,
structured N:M pruning, (br, bc) block pruning, the random sparse test
matrix, the paper's layerwise density profiles (Table III) and
:func:`prune_tree`, which prunes a whole parameter tree to a constant or a
per-leaf density.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

__all__ = ["magnitude_prune", "nm_prune", "block_prune", "random_sparse",
           "SparsityProfile", "PAPER_PROFILES", "prune_tree"]


def magnitude_prune(w: torch.Tensor, density: float) -> torch.Tensor:
    """Keep the ``density`` fraction of largest-|w| entries (unstructured).

    The rule is the reference's: the k-th largest magnitude is a threshold
    and every entry with ``|w| >= thresh`` stays.  With ties at the
    threshold (frequent in bf16) that keeps more than k entries, exactly as
    the reference does; a top-k mask chosen by index would keep another set.
    """
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0, 1], got {density}")
    if density >= 1.0:
        return w
    n = w.numel()
    k = max(int(round(n * density)), 1)
    mag = w.abs().float()      # exact for bf16/f32: the threshold compares equal
    if mag.is_cuda:
        # the same k-th largest value from a sort: torch.kthvalue on CUDA
        # selects within one thread block (planning qwen2-moe-a2.7b took 77 s
        # with it, 1.5 s with the sort; H100)
        thresh = torch.sort(mag.reshape(-1)).values[n - k]
    else:
        thresh = torch.kthvalue(mag.reshape(-1), n - k + 1).values
    return torch.where(mag >= thresh, w, torch.zeros_like(w))


def nm_prune(w: torch.Tensor, n: int = 4, m: int = 8, axis: int = 0) -> torch.Tensor:
    """Structured N:M pruning: keep the ``n`` largest-|w| of every ``m``
    consecutive entries along ``axis``.

    The reference ranks with ``argsort(argsort(-|w|))``; ``jnp.argsort`` is
    stable, so among equal magnitudes (common in bf16, and every zero) the
    lower index ranks first.  ``torch.argsort`` is asked to be stable too,
    or ties would give another mask.
    """
    if w.shape[axis] % m:
        raise ValueError(f"axis size {w.shape[axis]} not divisible by m={m}")
    wm = w.movedim(axis, -1)
    groups = wm.reshape(*wm.shape[:-1], wm.shape[-1] // m, m)
    order = torch.argsort(-groups.abs(), dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    pruned = torch.where(rank < n, groups, torch.zeros_like(groups))
    return pruned.reshape(wm.shape).movedim(-1, axis)


def block_prune(w: torch.Tensor, density: float,
                block: tuple[int, int] = (8, 128)) -> torch.Tensor:
    """Prune whole (br, bc) blocks by their L2 norm (the VREG-granular mode).

    The reference's rule: block norms in float32, the k-th largest norm is a
    threshold and every block with ``norm >= thresh`` stays.  The norms are
    computed sums, so a norm at the threshold may round differently here
    than under XLA.
    """
    br, bc = block
    k, n = w.shape
    kp = (k + br - 1) // br * br
    np_ = (n + bc - 1) // bc * bc
    wp = F.pad(w, (0, np_ - n, 0, kp - k))
    blocks = wp.reshape(kp // br, br, np_ // bc, bc)
    norms = torch.sqrt((blocks.float() ** 2).sum(dim=(1, 3)))
    nb = norms.numel()
    keep = max(int(round(nb * density)), 1)
    thresh = torch.kthvalue(norms.reshape(-1), nb - keep + 1).values
    mask = (norms >= thresh)[:, None, :, None]
    pruned = torch.where(mask, blocks, torch.zeros_like(blocks)).reshape(kp, np_)
    return pruned[:k, :n].contiguous()


def random_sparse(gen: torch.Generator, shape: tuple[int, ...], density: float,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Random matrix with Bernoulli(``density``) support, drawn from ``gen``
    on its device (the autotuner's warmup operand; its values are not the
    reference's)."""
    vals = torch.randn(shape, generator=gen, device=gen.device)
    mask = torch.rand(shape, generator=gen, device=gen.device) < density
    return torch.where(mask, vals, torch.zeros_like(vals)).to(dtype)


# ---------------------------------------------------------------------------
# Layerwise density profiles (paper Table III)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SparsityProfile:
    """Per-matrix-family target densities for a pruned network."""

    name: str
    weight_density: float                 # average over layers
    input_density: float                  # 1.0 = dense activations
    layer_densities: tuple[float, ...] = ()   # optional per-layer detail
    method: str = "magnitude"             # magnitude | movement | nm | block

    def density_for_layer(self, i: int) -> float:
        if self.layer_densities:
            return self.layer_densities[i % len(self.layer_densities)]
        return self.weight_density


# Table III of the paper + per-layer ranges quoted in Section IV-D.
PAPER_PROFILES: Mapping[str, SparsityProfile] = {
    "alexnet_conv": SparsityProfile(
        name="alexnet_conv",
        weight_density=0.41,
        input_density=0.69,
        layer_densities=(0.84, 0.38, 0.35, 0.37, 0.34),
        method="magnitude",
    ),
    "vgg16_conv": SparsityProfile(
        name="vgg16_conv",
        weight_density=0.33,
        input_density=0.61,
        layer_densities=(0.57, 0.41, 0.33, 0.31, 0.31, 0.29, 0.28, 0.26,
                         0.25, 0.26, 0.28, 0.30, 0.22),
        method="magnitude",
    ),
    "bert_squad": SparsityProfile(
        name="bert_squad",
        weight_density=0.33,
        input_density=1.0,
        layer_densities=(0.50, 0.45, 0.42, 0.40, 0.38, 0.36, 0.33, 0.30,
                         0.27, 0.22, 0.12, 0.04),
        method="movement",
    ),
    "bert_mnli": SparsityProfile(
        name="bert_mnli",
        weight_density=0.13,
        input_density=1.0,
        layer_densities=(0.22, 0.20, 0.18, 0.16, 0.15, 0.13, 0.12, 0.10,
                         0.08, 0.06, 0.03, 0.01),
        method="movement",
    ),
    # LSTM density evaluated against ESE (Fig. 8)
    "ese_lstm": SparsityProfile(
        name="ese_lstm", weight_density=0.10, input_density=1.0,
        method="magnitude",
    ),
}


def prune_tree(
    params,
    density: float | Callable[[str], float],
    method: str = "magnitude",
    min_size: int = 4096,
    path_filter: Callable[[str], bool] | None = None,
):
    """Prune every 2-D+ weight in a parameter tree to the target density.

    ``density`` may be a callable name → density for layerwise profiles.
    Embeddings/norms/biases are skipped via ``min_size`` and dimensionality.

    The port keeps one dict a layer where the reference stacks the layers,
    so the walk is the reference's (:func:`repro_torch.core.sod.plan_leaves`):
    a leaf of every block of a stack is one stacked leaf, named as the
    reference names it (``.blocks.attn.wq``: its ``keystr`` with ``'`` and
    ``]`` dropped and ``[`` read as ``.``) and visited in its order (dict
    keys sorted), so ``density`` and ``path_filter`` see the reference's
    names in the reference's order.  The rules apply to the stacked shape,
    and a stacked (L, K, N) leaf is pruned as one (L·K, N) matrix; each
    block then gets its slice back.  Returns a new tree.
    """
    from repro_torch.core import sod   # sod imports this module

    out = sod._copy(params)
    leaves = sorted(sod.plan_leaves(params), key=lambda e: e[0].split("."))
    for name, ws, lead in leaves:
        own = tuple(ws[0].shape[:-2])
        shape = tuple(lead[:len(lead) - len(own)]) + tuple(ws[0].shape)
        eligible = (
            len(shape) >= 2
            and math.prod(shape) >= min_size
            and (path_filter is None or path_filter(name))
        )
        if not eligible:
            continue
        d = density(name) if callable(density) else density
        mat = torch.stack(ws).reshape(-1, shape[-1])
        if method == "magnitude":
            pruned = magnitude_prune(mat, d)
        elif method == "block":
            pruned = block_prune(mat, d)
        elif method == "nm":
            m = 8
            n = max(int(round(d * m)), 1)
            pad = (-mat.shape[0]) % m
            matp = F.pad(mat, (0, 0, 0, pad))
            pruned = nm_prune(matp, n=n, m=m, axis=0)[: mat.shape[0]]
        else:
            raise ValueError(f"unknown pruning method {method!r}")
        pruned = pruned.reshape(len(ws), *ws[0].shape).to(ws[0].dtype)
        sod._place(out, name, list(pruned.unbind(0)))
    return out
