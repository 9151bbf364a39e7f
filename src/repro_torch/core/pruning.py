"""Pruning — produces the sparse weights that Sparse-on-Dense consumes.

Twin of :mod:`repro.core.pruning` for unstructured magnitude pruning,
structured N:M pruning, (br, bc) block pruning and the random sparse test
matrix.  The paper's layerwise density profiles are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["magnitude_prune", "nm_prune", "block_prune", "random_sparse"]


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
    k = max(int(round(w.numel() * density)), 1)
    mag = w.abs().float()      # exact for bf16/f32: the threshold compares equal
    thresh = torch.kthvalue(mag.reshape(-1), w.numel() - k + 1).values
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
