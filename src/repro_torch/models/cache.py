"""Decode-cache geometry for the attention family.

Twin of :mod:`repro.models.cache` for the one layout the port has: a dict of
``k`` and ``v`` tensors shaped ``(L, B, S, KV, hd)`` — layer, batch row,
sequence position, KV head, head dim.
"""
from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]

SEQ_AXIS = 2


def grow_cache(cache: Params, new_len: int) -> Params:
    """Zero-pad the sequence axis of every leaf out to ``new_len`` (leaves
    already that long are returned as they are)."""
    out = {}
    for name, t in cache.items():
        if t.shape[SEQ_AXIS] >= new_len:
            out[name] = t
            continue
        pad_shape = list(t.shape)
        pad_shape[SEQ_AXIS] = new_len - t.shape[SEQ_AXIS]
        out[name] = torch.cat([t, t.new_zeros(pad_shape)], dim=SEQ_AXIS)
    return out
