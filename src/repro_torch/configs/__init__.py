"""Architecture registry of the port: ``get_config(arch)`` + reduced variants.

Only the architectures whose model path is ported are listed.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCH_NAMES", "ModelConfig", "get_config", "reduced"]

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    """The named architecture's config."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family tiny variant for CPU tests — the reference's rules
    (``repro.configs.reduced``), copied."""
    period = cfg.pattern_period
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2 * period, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab=512,
        attn_chunk=64,
        ssm_chunk=32,
        remat=False,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
    )
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), ep_axis=4,
                  d_shared_ff=128 if cfg.d_shared_ff else 0)
    if cfg.family == "vlm":
        kw.update(frontend_dim=64, n_patches=16)
    if cfg.family == "hybrid":
        kw.update(n_layers=2 * cfg.hybrid_attn_every, ssm_state=16,
                  ssm_headdim=32, head_dim=32)
    if cfg.family == "ssm":
        kw.update(n_layers=2 * (cfg.slstm_every or 1))
    if cfg.attn_scale is not None:
        kw["attn_scale"] = (kw["d_model"] / kw["n_heads"]) ** -0.5
    return dataclasses.replace(cfg, **kw)
