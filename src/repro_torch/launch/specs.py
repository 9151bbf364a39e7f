"""Shape-only stand-ins for every model input — twin of :mod:`repro.launch.specs`.

The reference's ``jax.ShapeDtypeStruct`` is a tensor on ``device="meta"``
here: a shape and a dtype, no storage.  ``input_specs(cfg, shape)`` gives
the inputs of one (architecture × input shape) cell:

* train   → ``{"batch": {tokens, targets [, patch_embeds]}}``
* prefill → ``{"batch": {tokens [, patch_embeds]}}``
* decode  → ``{cache, tokens, pos}``, the cache at full ``seq_len``
  occupancy (:meth:`repro_torch.models.model.LM.init_cache` on meta)

Token ids are int64, the port's index dtype (the reference's are int32);
every other dtype is the reference's.  ``pos`` is a 0-d int64 spec: a step
on meta tensors takes the position it stands for as an int
(:mod:`repro_torch.launch.dryrun` passes ``seq_len - 1``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import LM

__all__ = ["token_specs", "input_specs", "abstract_params"]

Params = Any
TOKEN_DTYPE = torch.int64


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def token_specs(cfg: ModelConfig, batch: int, seq: int, with_targets: bool) -> dict:
    """``tokens`` (and ``targets``) of one batch: (B, S, codebooks) for an
    audio model, (B, S - n_patches) plus ``patch_embeds`` (B, n_patches,
    frontend_dim) for a VLM, else (B, S)."""
    if cfg.family == "audio":
        toks = _sds((batch, seq, cfg.n_codebooks), TOKEN_DTYPE)
    elif cfg.family == "vlm":
        toks = _sds((batch, seq - cfg.n_patches), TOKEN_DTYPE)
    else:
        toks = _sds((batch, seq), TOKEN_DTYPE)
    out = {"tokens": toks}
    if cfg.family == "vlm":
        out["patch_embeds"] = _sds((batch, cfg.n_patches, cfg.frontend_dim),
                                   getattr(torch, cfg.dtype))
    if with_targets:
        out["targets"] = _sds(toks.shape, TOKEN_DTYPE)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The meta inputs of one dry-run cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": token_specs(cfg, b, s, with_targets=True)}
    if shape.kind == "prefill":
        return {"batch": token_specs(cfg, b, s, with_targets=False)}
    # decode: one new token against a seq_len-deep cache
    cache = LM(cfg).init_cache(b, s, device="meta")
    toks = _sds((b, 1, cfg.n_codebooks) if cfg.family == "audio" else (b, 1), TOKEN_DTYPE)
    return {"cache": cache, "tokens": toks, "pos": _sds((), TOKEN_DTYPE)}


def abstract_params(model: LM, sod_cfg=None, plan=None) -> Params:
    """``model.init`` on meta tensors, then (with a Sparse-on-Dense config
    or a ``plan``) :func:`repro_torch.core.sod.sodify_abstract`: packed
    containers of meta tensors whose shapes equal a concrete
    ``sodify_params(..., plan=plan)``'s."""
    from repro_torch.core import sod as sod_mod

    params = model.init(torch.Generator(), "meta")
    if plan is not None or (sod_cfg is not None and sod_cfg.enabled):
        params = sod_mod.sodify_abstract(params, sod_cfg or model.cfg.sod, plan=plan)
    return params
