"""Cache geometry: explicit per-leaf axis metadata for decode caches.

Twin of :mod:`repro.models.cache`.  Every family's decode cache is a tree
(dicts and tuples) of tensors whose leaves carry a batch axis (one row per
running sequence) and, for attention KV leaves, a sequence axis.  Each
family publishes a spec tree of the same structure whose leaves are
:class:`CacheAxes` (``LM.cache_spec()``): the attention family's
``{"k", "v"}`` of shape (L, B, S, KV, hd) has batch axis 1 and sequence
axis 2; recurrent state has a batch axis and no sequence axis.  The serve
path grows a prefill-sized cache along the sequence axes only
(:func:`grow_cache`), and the continuous-batching engine scatters one
sequence's state into a slot of the batched cache along the batch axes
(:func:`write_slot`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CacheAxes:
    """Axis roles of one cache leaf: ``batch`` is the slot axis, ``seq``
    the KV sequence axis (None for O(1) recurrent state)."""

    batch: int
    seq: int | None = None

    def shifted(self, lead: int) -> "CacheAxes":
        """The same leaf stacked under ``lead`` extra leading dims
        (layer-group stacking in the assemblies)."""
        return CacheAxes(self.batch + lead,
                         None if self.seq is None else self.seq + lead)


class HeadAxis(NamedTuple):
    """Where a cache leaf holds heads, for the partitioned program (the
    port's own; the reference finds its cache's dims by their sizes):
    ``axis`` holds ``heads`` heads of ``width`` elements each; ``kv``
    marks an attention KV leaf, whose rank keeps the KV heads its query
    heads read (:func:`repro_torch.models.attention.local_heads`)."""

    axis: int
    heads: int
    width: int = 1
    kv: bool = False


def map_axes(fn: Callable, spec, *trees):
    """``fn(axes, *leaves)`` at every :class:`CacheAxes` of ``spec``, the
    trees (a cache, or any tree of its structure) walked alongside; the
    spec's structure back."""
    if isinstance(spec, CacheAxes):
        return fn(spec, *trees)
    if isinstance(spec, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees)) for k, v in spec.items()}
    return type(spec)(map_axes(fn, v, *(t[i] for t in trees))
                      for i, v in enumerate(spec))


def shift_axes(spec_tree, lead: int):
    """Shift every :class:`CacheAxes` in a spec tree by ``lead`` leading
    dims — how per-cell specs compose into stacked family specs."""
    return map_axes(lambda ax: ax.shifted(lead), spec_tree)


def grow_cache(cache, spec_tree, new_len: int):
    """Zero-pad every sequence axis out to ``new_len``; leaves already that
    long, and seq-less recurrent state, are returned as they are."""

    def grow(ax: CacheAxes, t: torch.Tensor) -> torch.Tensor:
        if ax.seq is None or t.shape[ax.seq] >= new_len:
            return t
        pad_shape = list(t.shape)
        pad_shape[ax.seq] = new_len - t.shape[ax.seq]
        return torch.cat([t, t.new_zeros(pad_shape)], dim=ax.seq)

    return map_axes(grow, spec_tree, cache)


def write_slot(cache, sub, spec_tree, slot: int):
    """Write a single-sequence cache ``sub`` (batch 1 on every batch axis)
    into row ``slot`` of the batched ``cache``, in place; returns ``cache``.
    A ``sub`` leaf shorter than the cache on its sequence axis writes a
    prefix; the tail keeps whatever the slot held, which is safe because
    decode masks key positions beyond the sequence's ``pos`` and overwrites
    them in order."""

    def write(ax: CacheAxes, t: torch.Tensor, s: torch.Tensor) -> None:
        dst = t.narrow(ax.batch, slot, 1)
        if ax.seq is not None:
            dst = dst.narrow(ax.seq, 0, s.shape[ax.seq])
        dst.copy_(s)

    map_axes(write, spec_tree, cache, sub)
    return cache
