"""A small pytree walk over the port's parameter and optimizer trees.

The reference maps over its trees with ``jax.tree_util``; the port's trees
are dicts, lists and tuples whose leaves are tensors, ``None`` (an absent
quantization side band) or the packed containers :class:`TiledCSC` and
:class:`BlockCSR`, which are nodes here: their tensor fields (``vals``,
``rows``, ``scale``, ``codebook``; ``block_vals``, ``block_ids``,
``tile_nnz``, ...) are the leaves, their layout fields (``shape``,
``tile``, ``br``, ``qmode``) the static part.  ``None`` is an empty subtree,
as in JAX: it holds no leaf and maps to ``None``.

Paths are strings in the form of ``jax.tree_util.keystr``:
``['layers'][0]['attn']['wq'].vals``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch

from repro_torch.core.formats import BlockCSR, TiledCSC

__all__ = ["PACKED_FIELDS", "tree_map", "tree_map_with_path", "tree_leaves",
           "leaves_with_path", "leaves_along", "max_rel_dist"]

# the tensor fields of each packed container, in the order they are walked
PACKED_FIELDS = {
    TiledCSC: ("vals", "rows", "scale", "codebook"),
    BlockCSR: ("block_vals", "block_ids", "tile_nnz", "scale", "codebook"),
}


def _children(tree) -> Iterator[tuple[str, Any, Callable]]:
    """(path suffix, child, key) of one node; raises for a leaf type the
    walk does not know."""
    if isinstance(tree, dict):
        return ((f"[{k!r}]", v, k) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return ((f"[{i}]", v, i) for i, v in enumerate(tree))
    fields = PACKED_FIELDS.get(type(tree))
    if fields is None:
        raise TypeError(f"not a tree node or tensor leaf: {type(tree).__name__}")
    return ((f".{f}", getattr(tree, f), f) for f in fields)


def _child(tree, key):
    if tree is None:
        return None
    if isinstance(tree, (dict, list, tuple)):
        return tree[key]
    return getattr(tree, key)


def _rebuild(tree, values: dict) -> Any:
    if isinstance(tree, dict):
        return dict(values)
    if isinstance(tree, (list, tuple)):
        return type(tree)(values[i] for i in range(len(tree)))
    return dataclasses.replace(tree, **values)


def _map(fn, path: str, tree, rest: tuple):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(path, tree, *rest)
    return _rebuild(tree, {key: _map(fn, path + suffix, child,
                                     tuple(_child(r, key) for r in rest))
                           for suffix, child, key in _children(tree)})


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` on every tensor leaf of ``tree``, the
    same structure back.  The trees of ``rest`` follow ``tree``'s structure;
    where one holds ``None`` at a leaf of ``tree``, ``fn`` gets ``None``."""
    return _map(lambda _, *leaves: fn(*leaves), "", tree, rest)


def tree_map_with_path(fn: Callable, tree):
    """``fn(path, leaf)`` on every tensor leaf, the same structure back."""
    return _map(fn, "", tree, ())


def leaves_with_path(tree, path: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """``(path, leaf)`` of every tensor leaf, in walk order."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield path, tree
        return
    for suffix, child, _ in _children(tree):
        yield from leaves_with_path(child, path + suffix)


def tree_leaves(tree) -> list[torch.Tensor]:
    """Every tensor leaf, in walk order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def max_rel_dist(got, want) -> float:
    """The largest relative distance ``‖got − want‖ / ‖want‖`` over the
    float leaves of two trees of one structure (0.0 for none); an integer
    leaf that differs counts as inf."""
    worst = 0.0
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        if not x.is_floating_point():
            worst = max(worst, 0.0 if torch.equal(x, y) else math.inf)
        elif x.numel():
            worst = max(worst, torch.linalg.vector_norm(x.float() - y.float()).item()
                        / max(torch.linalg.vector_norm(y.float()).item(), 1e-30))
    return worst


def leaves_along(tree, other) -> list:
    """``other``'s entries at ``tree``'s tensor leaves, in walk order, with
    ``None`` where ``other`` holds none (a gradient tree's integer leaves)."""
    out: list = []
    tree_map(lambda _, o: out.append(o), tree, other)
    return out
