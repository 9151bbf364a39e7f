"""Model facade: init / apply / loss / prefill / decode over the assemblies.

Twin of :class:`repro.models.model.LM` and :func:`repro.models.model.build_model`
for training (``loss``), the static serving path and the continuous-batching
engine, dispatching by family: the attention-family decoder (dense, MoE,
and the VLM and audio backbones), the hybrid (``hybrid``: zamba2) and the
xLSTM (``ssm``).  A VLM's patch embeddings ride beside its tokens
(``patch_embeds``) and its loss reads only the text's logits; an audio
model's tokens and targets are (B, S, n_codebooks).  The paged decode,
chunked prefill and speculative verification are the attention family's;
the recurrent families keep O(1) state a slot and raise there, with the
reference's messages.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models import cache as cache_mod
from repro_torch.models import layers, transformer

Params = dict[str, Any]

RECURRENT = ("hybrid", "ssm")

# family -> (init, forward, decode, init_cache, cache_spec)
_FAMILIES = {
    "hybrid": (transformer.init_hybrid, transformer.hybrid_forward,
               transformer.hybrid_decode, transformer.hybrid_init_cache,
               transformer.hybrid_cache_spec),
    "ssm": (transformer.init_xlstm_lm, transformer.xlstm_forward,
            transformer.xlstm_decode, transformer.xlstm_init_cache,
            transformer.xlstm_cache_spec),
}
_ATTENTION = (transformer.init_transformer, transformer.transformer_forward,
              transformer.transformer_decode, transformer.transformer_init_cache,
              transformer.transformer_cache_spec)


@dataclasses.dataclass(frozen=True)
class LM:
    """Functional language model: init / apply / loss / prefill / decode_step."""

    cfg: ModelConfig

    @property
    def _fns(self) -> tuple:
        return _FAMILIES.get(self.cfg.family, _ATTENTION)

    def init(self, generator: torch.Generator, device: torch.device | str) -> Params:
        """Random weights drawn from ``generator`` on ``device``."""
        transformer.check_supported(self.cfg)
        return self._fns[0](generator, self.cfg, torch.device(device))

    def apply(self, params: Params, tokens: torch.Tensor, want_cache: bool = False,
              *, patch_embeds: torch.Tensor | None = None):
        """Full-sequence forward: (logits (B, S, V), cache or None); the
        router aux loss is :meth:`loss`'s.  A VLM's ``patch_embeds`` (B,
        n_patches, frontend_dim) go before its text, so S counts them; an
        audio model's tokens are (B, S, C) and its logits (B, S, C, V).  A
        recurrent family's cache is the hybrid's shared-block KV only, or
        None (the xLSTM): its state is built by stepping the prompt."""
        logits, _, cache = self._fns[1](params, tokens, self.cfg, want_cache,
                                        patch_embeds=patch_embeds)
        return logits, cache

    def loss(self, params: Params, batch: dict[str, torch.Tensor]):
        """``(loss, {"loss", "ce", "aux"})`` of a batch ``{"tokens",
        "targets"}`` (int, (B, S), or (B, S, C) for audio) with an optional
        ``"loss_mask"`` and, for a VLM, ``"patch_embeds"``: the mean token
        cross-entropy of the float32 logits (a VLM's over its text only,
        an audio model's over every codebook) plus ``aux``, the MoE blocks'
        router aux losses summed over the layers (0 for the dense
        family).  In a partitioned step (the batch the rank's rows) the
        mean is the global batch's: the sums over the data axes divided by
        the global count of (masked-in) tokens, so the metrics equal one
        process's."""
        logits, aux, _ = self._fns[1](params, batch["tokens"], self.cfg,
                                      patch_embeds=batch.get("patch_embeds"))
        targets = batch["targets"]
        if self.cfg.family == "vlm":       # the patches' positions carry no loss
            logits = logits[:, logits.shape[1] - targets.shape[1]:]
        ce = layers.cross_entropy(logits, targets, batch.get("loss_mask"),
                                  vocab=self.cfg.padded_vocab,
                                  codebooks=self.cfg.n_codebooks or None)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def prefill(self, params: Params, tokens: torch.Tensor, *,
                patch_embeds: torch.Tensor | None = None):
        """(last-position logits (B, V), KV cache sized to the prompt, a
        VLM's patches included).  The attention families' fused prefill;
        the recurrent families build their state by stepping
        (``launch/serve.py:prefill_cache``)."""
        logits, cache = self.apply(params, tokens, want_cache=True,
                                   patch_embeds=patch_embeds)
        return logits[:, -1], cache

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos):
        """tokens (B, 1) → (logits (B, 1, V), cache), or for audio (B, 1, C)
        → (B, 1, C, V); the cache is updated in place.  ``pos`` is an int
        (every row at one position) or a (B,) int64 tensor (each row at its
        own, the engine's slots)."""
        return self._fns[2](params, cache, tokens, pos, self.cfg)

    def init_cache(self, batch: int, max_len: int, device: torch.device | str) -> Params:
        """Zeroed decode cache for ``batch`` rows of ``max_len`` positions."""
        return self._fns[3](self.cfg, batch, max_len, torch.device(device))

    # -- cache geometry (serving engine / serve path) ------------------------
    def cache_spec(self) -> Params:
        """The decode cache's tree of
        :class:`repro_torch.models.cache.CacheAxes`: every leaf's batch and
        sequence axes."""
        return self._fns[4](self.cfg)

    def grow_cache(self, cache: Params, new_len: int) -> Params:
        """Zero-pad the cache's sequence axes (and only those) out to
        ``new_len``."""
        return cache_mod.grow_cache(cache, self.cache_spec(), new_len)

    def _paged_only(self, what: str) -> None:
        if self.cfg.family in RECURRENT:
            raise ValueError(f"family {self.cfg.family!r} {what}")

    # -- paged decode (continuous-batching engine) -----------------------------
    def init_paged_pool(self, n_pages: int, page_size: int,
                        device: torch.device | str) -> Params:
        """Zeroed KV page pool (L, n_pages, page, KV, hd); page 0 is trash."""
        self._paged_only("keeps O(1) recurrent state per slot; only "
                         "attention-family KV caches are paged")
        return transformer.transformer_init_paged_pool(
            self.cfg, n_pages, page_size, torch.device(device))

    def paged_decode_step(self, params: Params, pool: Params,
                          block_tables: torch.Tensor, tokens: torch.Tensor,
                          pos: torch.Tensor, valid_len: torch.Tensor | None = None):
        """Ragged decode step over the paged pool: tokens (B, 1), pos (B,),
        block_tables (B, max_pages), optional per-row write cutoff
        ``valid_len`` (B,), all int64.  Returns (logits, pool); the pool is
        updated in place."""
        self._paged_only("has no paged decode path")
        return transformer.transformer_decode_paged(
            params, pool, block_tables, tokens, pos, self.cfg,
            valid_len=valid_len)

    def prefill_chunk(self, params: Params, pool: Params,
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      start: int, valid_len: int):
        """Chunked prefill against the paged pool: tokens (B, C) covering
        prompt positions [start, start+C), zero-padded past ``valid_len``.
        Returns (logits for all C positions, pool)."""
        self._paged_only("has no paged prefill path — recurrent prompts replay "
                         "through the decode step")
        return transformer.transformer_prefill_chunk(
            params, pool, block_tables, tokens, start, valid_len, self.cfg)

    def verify_chunk(self, params: Params, pool: Params,
                     block_tables: torch.Tensor, tokens: torch.Tensor,
                     start: torch.Tensor, valid_len: torch.Tensor):
        """Speculative-window verification: tokens (B, C) at cache positions
        [start[b], start[b] + C) a row, writes cut off at ``valid_len[b]``.
        Returns (logits for all C positions, pool); row i's logits are what
        C sequential paged decode steps give at their i-th."""
        self._paged_only("has no paged verify path — speculative decoding "
                         "needs the paged-KV cache")
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
