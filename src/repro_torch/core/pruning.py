"""Pruning — produces the sparse weights that Sparse-on-Dense consumes.

Twin of :mod:`repro.core.pruning` for unstructured magnitude pruning and
(br, bc) block pruning.  The N:M pruner is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["magnitude_prune", "block_prune"]


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
