"""Model facade: init / prefill / decode over the attention-family decoder.

Twin of :class:`repro.models.model.LM` and :func:`repro.models.model.build_model`
for training (``loss``), the static serving path and the continuous-batching
engine's paged decode, chunked prefill and speculative verification, for
the dense and MoE families.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache as cache_mod
from repro_torch.core.tree import tree_leaves
from repro_torch.models import layers, transformer

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LM:
    """Functional language model: init / apply / loss / prefill / decode_step."""

    cfg: ModelConfig

    def init(self, generator: torch.Generator, device: torch.device | str) -> Params:
        """Random weights drawn from ``generator`` on ``device``."""
        return transformer.init_transformer(generator, self.cfg, torch.device(device))

    def apply(self, params: Params, tokens: torch.Tensor, want_cache: bool = False):
        """Full-sequence forward: (logits (B, S, V), cache or None); the
        router aux loss is :meth:`loss`'s."""
        logits, _, cache = transformer.transformer_forward(params, tokens, self.cfg,
                                                           want_cache)
        return logits, cache

    def loss(self, params: Params, batch: dict[str, torch.Tensor]):
        """``(loss, {"loss", "ce", "aux"})`` of a batch ``{"tokens",
        "targets"}`` (int, (B, S)) with an optional ``"loss_mask"``: the
        mean token cross-entropy of the float32 logits plus ``aux``, the
        MoE blocks' router aux losses summed over the layers (0 for the
        dense family)."""
        logits, aux, _ = transformer.transformer_forward(params, batch["tokens"],
                                                         self.cfg)
        ce = layers.cross_entropy(logits, batch["targets"], batch.get("loss_mask"))
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

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

    # -- paged decode (continuous-batching engine) -----------------------------
    def init_paged_pool(self, n_pages: int, page_size: int,
                        device: torch.device | str) -> Params:
        """Zeroed KV page pool (L, n_pages, page, KV, hd); page 0 is trash."""
        return transformer.transformer_init_paged_pool(
            self.cfg, n_pages, page_size, torch.device(device))

    def paged_decode_step(self, params: Params, pool: Params,
                          block_tables: torch.Tensor, tokens: torch.Tensor,
                          pos: torch.Tensor, valid_len: torch.Tensor | None = None):
        """Ragged decode step over the paged pool: tokens (B, 1), pos (B,),
        block_tables (B, max_pages), optional per-row write cutoff
        ``valid_len`` (B,), all int64.  Returns (logits, pool); the pool is
        updated in place."""
        return transformer.transformer_decode_paged(
            params, pool, block_tables, tokens, pos, self.cfg,
            valid_len=valid_len)

    def prefill_chunk(self, params: Params, pool: Params,
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      start: int, valid_len: int):
        """Chunked prefill against the paged pool: tokens (B, C) covering
        prompt positions [start, start+C), zero-padded past ``valid_len``.
        Returns (logits for all C positions, pool)."""
        return transformer.transformer_prefill_chunk(
            params, pool, block_tables, tokens, start, valid_len, self.cfg)

    def verify_chunk(self, params: Params, pool: Params,
                     block_tables: torch.Tensor, tokens: torch.Tensor,
                     start: torch.Tensor, valid_len: torch.Tensor):
        """Speculative-window verification: tokens (B, C) at cache positions
        [start[b], start[b] + C) a row, writes cut off at ``valid_len[b]``.
        Returns (logits for all C positions, pool); row i's logits are what
        C sequential paged decode steps give at their i-th."""
        return transformer.transformer_verify_chunk(
            params, pool, block_tables, tokens, start, valid_len, self.cfg)

    # -- info ------------------------------------------------------------------
    def param_count(self, params: Params | None = None) -> int:
        """The config's parameter count, or with ``params`` the elements of
        every tensor leaf (a packed operand's stored buffers)."""
        if params is None:
            return self.cfg.param_count()
        return sum(int(t.numel()) for t in tree_leaves(params))


def build_model(cfg: ModelConfig) -> LM:
    """The model of ``cfg``."""
    return LM(cfg)
