"""numpy → torch conversion and the weight carry-across from the JAX package.

JAX's bfloat16 and float8_e4m3fn arrays reach numpy as ``ml_dtypes``
arrays, which ``torch.from_numpy`` rejects.  They are recognised by dtype
name (this module does not import ``ml_dtypes``) and reinterpreted bit for
bit through ``uint16`` and ``uint8``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.formats import BlockCSR, TiledCSC

__all__ = ["to_torch", "params_from_numpy", "tiled_csc_from_numpy",
           "block_csr_from_numpy"]


# ml_dtypes names -> (numpy carrier of the bits, torch dtype)
_BIT_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def to_torch(a, device: str | torch.device = "cuda") -> torch.Tensor:
    """One numpy (or numpy-convertible) array as a tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:      # e.g. a view of a JAX buffer
        a = a.copy()
    if a.dtype.name in _BIT_VIEWS:
        bits, dtype = _BIT_VIEWS[a.dtype.name]
        t = torch.from_numpy(a.view(bits)).view(dtype)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: dict[str, Any], cfg,
                      device: str | torch.device = "cuda") -> dict[str, Any]:
    """The port's per-layer parameters from the JAX parameter pytree.

    ``tree`` is the JAX attention-family tree as numpy arrays: ``embed``,
    ``final_norm`` and ``blocks`` whose leaves are stacked ``(G, P, ...)``
    (layer groups × pattern period).  Layer ``l`` is ``blocks[l // P, l % P]``.
    """
    blocks = tree["blocks"]
    lead = next(iter(_leaves(blocks))).shape[:2]
    n_groups, period = int(lead[0]), int(lead[1])
    if n_groups * period != cfg.n_layers:
        raise ValueError(f"blocks stack {lead} does not hold {cfg.n_layers} "
                         "layers")
    layers = [
        _map(blocks, lambda a, g=l // period, p=l % period:
             to_torch(np.asarray(a)[g, p], device))
        for l in range(cfg.n_layers)
    ]
    return {"embed": to_torch(tree["embed"], device),
            "final_norm": to_torch(tree["final_norm"], device),
            "layers": layers}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _side(a, device) -> torch.Tensor | None:
    return None if a is None else to_torch(np.asarray(a, np.float32), device)


def tiled_csc_from_numpy(vals, rows, shape, tile,
                         device: str | torch.device = "cuda", *, scale=None,
                         codebook=None, qmode: str = "none") -> TiledCSC:
    """One packed operand (``vals``, ``rows``, the quantization side band
    ``scale``/``codebook`` of its ``qmode``, and its static layout)."""
    return TiledCSC(vals=to_torch(vals, device), rows=to_torch(rows, device),
                    shape=(int(shape[0]), int(shape[1])),
                    tile=(int(tile[0]), int(tile[1])), scale=_side(scale, device),
                    codebook=_side(codebook, device), qmode=qmode)


def block_csr_from_numpy(block_vals, block_ids, tile_nnz, shape, tile, br,
                         device: str | torch.device = "cuda", *, scale=None,
                         codebook=None, qmode: str = "none") -> BlockCSR:
    """One packed BlockCSR operand; ``block_ids`` and ``tile_nnz`` stay int32."""
    ids, nnz = (to_torch(np.asarray(a, dtype=np.int32), device)
                for a in (block_ids, tile_nnz))
    return BlockCSR(block_vals=to_torch(block_vals, device), block_ids=ids,
                    tile_nnz=nnz, shape=(int(shape[0]), int(shape[1])),
                    tile=(int(tile[0]), int(tile[1])), br=int(br),
                    scale=_side(scale, device), codebook=_side(codebook, device),
                    qmode=qmode)
