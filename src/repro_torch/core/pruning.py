"""Pruning — produces the sparse weights that Sparse-on-Dense consumes.

Twin of :mod:`repro.core.pruning` for unstructured magnitude pruning.  The
N:M and block pruners come with the BlockCSR slice of the port.
"""
from __future__ import annotations

import torch

__all__ = ["magnitude_prune"]


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
