"""Gradient accumulation and top-k compression — twin of :mod:`repro.optim.grad`.

``topk_compress`` / ``topk_decompress`` are deep-gradient-compression style
sparsification with error feedback: only the top ``ratio`` fraction of
gradient magnitudes would cross the interconnect (values and int32
indices).  ``torch.topk`` may order equal magnitudes otherwise than
``lax.top_k``; the kept set differs only among ties.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.tree import leaves_along, tree_map

__all__ = ["topk_compress", "topk_decompress", "compress_tree", "accumulate"]

Params = Any


def _f(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def topk_compress(g: torch.Tensor, ratio: float):
    """Keep the k = ratio·n largest |g|.  Returns (values, int32 indices,
    the error: g with the kept entries zeroed)."""
    flat = g.reshape(-1).float()
    k = max(int(flat.shape[0] * ratio), 1)
    idx = torch.topk(flat.abs(), k).indices
    kept = flat[idx]
    error = flat.clone()
    error[idx] = 0.0
    return kept, idx.to(torch.int32), error.reshape(g.shape)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dense tensor of ``shape`` holding ``vals`` at ``idx`` (summed
    where an index repeats), zero elsewhere, in ``dtype``."""
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    out.index_add_(0, idx.long(), vals.float())
    return out.reshape(tuple(shape)).to(dtype)


def compress_tree(grads: Params, ratio: float, errors: Params | None = None):
    """Compress every float leaf with error feedback: returns (a tree of
    ``(values, indices, shape)`` at the float leaves, non-float leaves as
    they are; the new error tree, ``None`` at non-float leaves)."""
    errs = iter(leaves_along(grads, errors))
    new_err: list = []

    def one(leaf):
        e = next(errs)
        if not _f(leaf):
            new_err.append(e)
            return leaf
        vals, idx, err = topk_compress(leaf.float() if e is None else leaf.float() + e,
                                       ratio)
        new_err.append(err)
        return vals, idx, tuple(leaf.shape)

    comp = tree_map(one, grads)
    err_it = iter(new_err)
    return comp, tree_map(lambda _: next(err_it), grads)


def accumulate(grads: Params, acc: Params | None, count: int):
    """Running mean for gradient accumulation: ``acc + (g - acc) / count``
    at float leaves (``acc`` None: the first gradient)."""
    if acc is None:
        return grads
    return tree_map(lambda a, g: a + (g - a) / count if _f(g) else g, acc, grads)
