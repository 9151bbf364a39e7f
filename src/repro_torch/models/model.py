"""Model facade: init / prefill / decode over the attention-family decoder.

Twin of :class:`repro.models.model.LM` for the static serving path.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache as cache_mod
from repro_torch.models import transformer

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LM:
    """Functional language model: init / prefill / decode_step."""

    cfg: ModelConfig

    def init(self, generator: torch.Generator, device: torch.device | str) -> Params:
        """Random weights drawn from ``generator`` on ``device``."""
        return transformer.init_transformer(generator, self.cfg, torch.device(device))

    def apply(self, params: Params, tokens: torch.Tensor, want_cache: bool = False):
        """Full-sequence forward: (logits (B, S, V), cache or None)."""
        return transformer.transformer_forward(params, tokens, self.cfg, want_cache)

    def prefill(self, params: Params, tokens: torch.Tensor):
        """(last-position logits (B, V), KV cache sized to the prompt)."""
        logits, cache = self.apply(params, tokens, want_cache=True)
        return logits[:, -1], cache

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos: int):
        """tokens (B, 1) at scalar position ``pos`` → (logits (B, 1, V),
        cache); the cache is updated in place."""
        return transformer.transformer_decode(params, cache, tokens, pos, self.cfg)

    def init_cache(self, batch: int, max_len: int, device: torch.device | str) -> Params:
        """Zeroed KV cache for ``batch`` rows of ``max_len`` positions."""
        return transformer.transformer_init_cache(self.cfg, batch, max_len,
                                                  torch.device(device))

    def grow_cache(self, cache: Params, new_len: int) -> Params:
        """Zero-pad the cache's sequence axis out to ``new_len``."""
        return cache_mod.grow_cache(cache, new_len)
