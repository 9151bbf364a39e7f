"""Prefill / decode step builders — twins of :mod:`repro.launch.steps`.

PyTorch runs eagerly, so a step is a plain closure (the reference jits it).
"""
from __future__ import annotations

from repro_torch.models.model import LM


def make_prefill_step(model: LM):
    """``(params, tokens) -> (greedy next tokens (B,), cache)``."""
    def prefill_step(params, tokens):
        last_logits, cache = model.prefill(params, tokens)
        return last_logits.argmax(dim=-1), cache

    return prefill_step


def make_decode_step(model: LM):
    """``(params, cache, tokens, pos) -> (greedy tokens (B, 1), logits,
    cache)``."""
    def decode_step(params, cache, tokens, pos):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        return logits.argmax(dim=-1), logits, cache

    return decode_step
