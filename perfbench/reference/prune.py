"""The pruning rules the configurations state, written for the reference.

* magnitude: the ``round(n * density)``-th largest ``|w|`` is a threshold,
  and every entry with ``|w| >= threshold`` stays (ties at the threshold
  stay too);
* block: the L2 norm of every (br, bc) block, summed in float32, is a
  score; the ``round(blocks * density)``-th largest is a threshold, and
  every block whose norm reaches it stays whole.

The block norms are a computed sum, so a norm within a rounding of the
threshold could fall either side under another order of summation; the
sum here is written as one float32 reduction over each block, which on one
device gives the same bits wherever the same reduction is taken.
"""
from __future__ import annotations

import torch


def magnitude(w: torch.Tensor, density: float) -> torch.Tensor:
    n = w.numel()
    k = max(int(round(n * density)), 1)
    mag = w.abs().float()
    thresh = torch.sort(mag.reshape(-1)).values[n - k]
    return torch.where(mag >= thresh, w, torch.zeros_like(w))


def block_norms(w: torch.Tensor, br: int, bc: int) -> torch.Tensor:
    k, n = w.shape
    if k % br or n % bc:
        raise ValueError(f"({k}, {n}) is not whole ({br}, {bc}) blocks")
    blocks = w.reshape(k // br, br, n // bc, bc)
    return torch.sqrt((blocks.float() ** 2).sum(dim=(1, 3)))


def block(w: torch.Tensor, density: float, br: int, bc: int) -> torch.Tensor:
    norms = block_norms(w, br, bc)
    nb = norms.numel()
    keep = max(int(round(nb * density)), 1)
    thresh = torch.sort(norms.reshape(-1)).values[nb - keep]
    mask = (norms >= thresh)[:, None, :, None]
    k, n = w.shape
    return torch.where(mask, w.reshape(k // br, br, n // bc, bc),
                       torch.zeros((), dtype=w.dtype, device=w.device)).reshape(k, n)


def prune(w: torch.Tensor, sod: dict) -> torch.Tensor:
    """``w`` pruned by the configuration's ``sod`` rule."""
    if sod["prune_method"] == "magnitude":
        return magnitude(w, sod["density"])
    if sod["prune_method"] == "block":
        return block(w, sod["density"], sod["br"], sod["tile"][1])
    raise ValueError(f"no reference rule for {sod['prune_method']!r}")


def stored(w_pruned: torch.Tensor, sod: dict) -> int:
    """Values the named format stores: every non-zero (magnitude) or every
    value of a kept block (block)."""
    if sod["prune_method"] == "block":
        kept = int((block_norms(w_pruned, sod["br"], sod["tile"][1]) > 0).sum())
        return kept * sod["br"] * sod["tile"][1]
    return int(torch.count_nonzero(w_pruned))
