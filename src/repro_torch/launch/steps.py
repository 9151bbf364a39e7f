"""Prefill / decode step builders — twins of :mod:`repro.launch.steps`.

PyTorch runs eagerly, so a step is a plain closure (the reference jits it).
Every ``make_*`` function takes an optional ``plan`` (a
:class:`repro_torch.core.plan.ModelPlan`): the step body runs inside
:func:`repro_torch.core.plan.use_plan`, so each packed matmul dispatches
with its layer's :class:`~repro_torch.core.plan.PackPlan`.
"""
from __future__ import annotations

from repro_torch.core.plan import use_plan
from repro_torch.models.model import LM


def make_prefill_step(model: LM, plan=None):
    """``(params, tokens) -> (greedy next tokens (B,), cache)``."""
    def prefill_step(params, tokens):
        with use_plan(plan):
            last_logits, cache = model.prefill(params, tokens)
        return last_logits.argmax(dim=-1), cache

    return prefill_step


def make_decode_step(model: LM, plan=None):
    """``(params, cache, tokens, pos) -> (greedy tokens (B, 1), logits,
    cache)``."""
    def decode_step(params, cache, tokens, pos):
        with use_plan(plan):
            logits, cache = model.decode_step(params, cache, tokens, pos)
        return logits.argmax(dim=-1), logits, cache

    return decode_step


def make_prefill_full(model: LM, plan=None):
    """``(params, tokens) -> (logits (B, S, V), cache)``: every position's
    logits.  The engine pads a prompt to a page-aligned bucket before the
    fused prefill, so the last real token's logits sit at ``len - 1``, not
    ``-1``; it takes that row itself."""
    def prefill_full(params, tokens):
        with use_plan(plan):
            return model.apply(params, tokens, want_cache=True)

    return prefill_full


def make_chunked_prefill_step(model: LM, plan=None):
    """``(params, pool, block_tables, tokens, start, valid_len) -> (logits,
    pool)``: one chunk of prompt prefill into the paged KV pool.  ``tokens``
    (B, C) covers positions [start, start+C); logits of every chunk position
    come back so the engine can take the last real prompt token's row."""
    def chunked_prefill_step(params, pool, block_tables, tokens, start, valid_len):
        with use_plan(plan):
            return model.prefill_chunk(params, pool, block_tables, tokens, start,
                                       valid_len)

    return chunked_prefill_step


def make_paged_decode_step(model: LM, plan=None):
    """``(params, pool, block_tables, tokens, pos, valid_len=None) ->
    (greedy tokens (B, 1), logits, pool)``: a ragged decode step over the
    paged KV pool, every engine slot at its own ``pos``; rows at or beyond
    their ``valid_len`` write to the trash page."""
    def paged_decode_step(params, pool, block_tables, tokens, pos, valid_len=None):
        with use_plan(plan):
            logits, pool = model.paged_decode_step(params, pool, block_tables,
                                                   tokens, pos, valid_len=valid_len)
        return logits.argmax(dim=-1), logits, pool

    return paged_decode_step


def make_verify_step(model: LM, plan=None):
    """``(params, pool, block_tables, tokens, start, valid_len) -> (greedy
    tokens (B, C), logits, pool)``: every engine slot scores its committed
    token and k draft proposals (C = k + 1) in one batched pass; greedy
    token ``(b, i)`` is what the sequential paged decode step emits at that
    position."""
    def verify_step(params, pool, block_tables, tokens, start, valid_len):
        with use_plan(plan):
            logits, pool = model.verify_chunk(params, pool, block_tables, tokens,
                                              start, valid_len)
        return logits.argmax(dim=-1), logits, pool

    return verify_step
