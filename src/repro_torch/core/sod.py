"""Sparse-on-Dense as a composable module: config, packing, apply.

Twin of :mod:`repro.core.sod` for static serving in the ``tiled_csc`` and
``block_csr`` modes, in every ``qmode``: :class:`SoDConfig` says how
projection weights are stored, :func:`pack_param` and :func:`sodify_params`
prune, pack and quantize them, and
:func:`apply` is the one matmul entry point every model layer calls — dense
tensors bypass decompression, packed operands go to
:func:`repro_torch.kernels.ops.sod_matmul`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from repro_torch.core import formats, pruning
from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.plan import QMODES

__all__ = ["SoDConfig", "DENSE", "prune_weight", "pack_param", "apply",
           "sodify_params", "tree_weight_bytes"]


@dataclasses.dataclass(frozen=True)
class SoDConfig:
    """Storage/compute mode for the model's projection weights."""

    mode: str = "dense"            # dense | tiled_csc | block_csr
    density: float = 1.0           # pruning target (1.0 = keep as-is)
    prune_method: str = "magnitude"  # magnitude | block
    tile: tuple[int, int] = (128, 128)
    br: int = 8                    # BlockCSR sub-block rows
    min_dim: int = 128             # matrices smaller than this stay dense
    qmode: str = "none"            # none | int8 | fp8 | codebook

    def __post_init__(self):
        if self.mode not in ("dense", "tiled_csc", "block_csr"):
            raise ValueError(f"unknown SoD mode {self.mode!r}")
        _check_method(self.prune_method)
        if self.qmode not in QMODES:
            raise ValueError(f"unknown SoD qmode {self.qmode!r}")

    @property
    def enabled(self) -> bool:
        """True when a Sparse-on-Dense mode is configured."""
        return self.mode != "dense"


def _check_method(method: str) -> None:
    if method == "nm":
        raise NotImplementedError(
            "prune_method='nm' is not ported yet: nm_prune is still open in "
            "ROADMAP.md, queue A item 3")
    if method not in ("magnitude", "block"):
        raise ValueError(f"unknown prune method {method!r}")


DENSE = SoDConfig()


def prune_weight(w: torch.Tensor, density: float, method: str = "magnitude",
                 tile: tuple[int, int] = (128, 128), br: int = 8) -> torch.Tensor:
    """Prune one 2-D weight to ``density`` with the named method: unstructured
    magnitude, or whole (br, tile[1]) blocks by L2 norm."""
    _check_method(method)
    if density >= 1.0:
        return w
    if method == "block":
        return pruning.block_prune(w, density, block=(br, tile[1]))
    return pruning.magnitude_prune(w, density)


def _pack(w: torch.Tensor, cfg: SoDConfig):
    """Pack a (possibly stacked) pruned weight in the config's format and
    qmode (a stack is quantized as one: a scale per layer and tile, a
    codebook per layer)."""
    if cfg.mode == "tiled_csc":
        return formats.pack_tiled_csc(w, tile=cfg.tile, qmode=cfg.qmode)
    return formats.pack_block_csr(w, tile=cfg.tile, br=cfg.br, qmode=cfg.qmode)


def pack_param(w: torch.Tensor, cfg: SoDConfig):
    """Prune and pack one dense 2-D weight per the config; the dense tensor
    comes back unchanged when the config is dense or the matrix is smaller
    than ``cfg.min_dim``."""
    if not cfg.enabled or w.ndim != 2 or min(w.shape) < cfg.min_dim:
        return w
    return _pack(prune_weight(w, cfg.density, cfg.prune_method, cfg.tile, cfg.br),
                 cfg)


def apply(x: torch.Tensor, w, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ W`` through the Sparse-on-Dense datapath."""
    from repro_torch.kernels import ops  # local import: kernels depend on core

    return ops.sod_matmul(x, w, out_dtype=out_dtype)


_SOD_PATHS = re.compile(
    r"(wq|wk|wv|wo|w_gate|w_up|w_down|head|w_z|w_x|out_proj)$")


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _named_leaves(v, name)
        else:
            yield name, v


def _get(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return tree


def _set(tree, name, value):
    *path, last = name.split(".")
    for part in path:
        tree = tree[part]
    tree[last] = value


def sodify_params(params: dict[str, Any], cfg: SoDConfig) -> dict[str, Any]:
    """Prune, pack and quantize every eligible projection weight, layer by
    layer.

    Mirrors the reference's stacked-leaf path: each projection is pruned
    per layer, then the whole layer stack is packed with one shared ``cap``
    or ``bcap`` (as ``lax.scan`` needs there) and quantized, and each layer
    gets its slice (with its scales and codebook).  Returns a new tree; the
    input's tensors are not modified.
    """
    if not cfg.enabled:
        return params
    layers = params["layers"]
    out_layers = [_copy(layer) for layer in layers]
    for name, leaf in _named_leaves(layers[0]):
        if not (_SOD_PATHS.search(name) and leaf.ndim == 2
                and min(leaf.shape) >= cfg.min_dim):
            continue
        stack = torch.stack([prune_weight(_get(layer, name), cfg.density,
                                          cfg.prune_method, cfg.tile, cfg.br)
                             for layer in layers])
        packed = _pack(stack, cfg)
        for i, layer in enumerate(out_layers):
            _set(layer, name, packed.layer(i))
    return {**params, "layers": out_layers}


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in tree.items()}


def _all_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _all_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _all_leaves(v)
    else:
        yield tree


def tree_weight_bytes(params: Any) -> dict[str, float]:
    """Compressed vs dense byte totals over a parameter tree: packed leaves
    at their qmode's width plus side band, dense leaves at 16 bits per
    element on both sides, and compressed / dense, as in the reference."""
    compressed = dense = 0
    for leaf in _all_leaves(params):
        if isinstance(leaf, (TiledCSC, BlockCSR)):
            compressed += leaf.nbytes_compressed()
            dense += leaf.nbytes_dense()
        elif isinstance(leaf, torch.Tensor):
            compressed += leaf.numel() * 2
            dense += leaf.numel() * 2
    return {"compressed": compressed, "dense": dense,
            "ratio": compressed / max(dense, 1)}
