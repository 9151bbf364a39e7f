"""Train / prefill / decode step builders — twins of :mod:`repro.launch.steps`.

PyTorch runs eagerly, so a step is a plain closure (the reference jits it).
Gradients are taken functionally, as ``jax.value_and_grad(...,
allow_int=True)``: every float leaf of the parameter tree enters the loss
as a fresh leaf that requires grad (a detached view, no copy), and
``torch.autograd.grad`` returns their gradients; integer leaves get
``None``.
Every ``make_*`` function takes an optional ``mesh`` (a
:class:`repro_torch.launch.mesh.Mesh`): the step body runs inside
:func:`repro_torch.launch.mesh.mesh_context`, so each packed matmul runs
as this rank's local problem of its SPMD plan
(:mod:`repro_torch.runtime.spmd`).  A mesh step takes the global batch on
every rank and returns what the unsharded step returns, on every rank.
Every ``make_*`` function also takes an optional ``plan`` (a
:class:`repro_torch.core.plan.ModelPlan`): the step body runs inside
:func:`repro_torch.core.plan.use_plan`, so each packed matmul dispatches
with its layer's :class:`~repro_torch.core.plan.PackPlan`.
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import use_plan
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.mesh import mesh_context
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW


def make_loss_and_grads(model: LM, mesh=None, plan=None):
    """``(params, batch) -> (loss, metrics, grads)``: the loss of
    :meth:`LM.loss`, its metrics (detached), and a gradient tree shaped like
    ``params`` (float leaves' gradients in their own dtype, zeros for an
    unused one; ``None`` at integer leaves)."""
    def loss_and_grads(params, batch):
        with mesh_context(mesh), use_plan(plan):
            live = tree_map(lambda p: p.detach().requires_grad_(True)
                            if p.is_floating_point() else p, params)
            leaves = [p for p in tree_leaves(live) if p.requires_grad]
            loss, metrics = model.loss(live, batch)
            gs = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))
        grads = tree_map(lambda p: next(gs) if p.requires_grad else None, live)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    return loss_and_grads


def make_train_step(model: LM, optimizer: AdamW, mesh=None, plan=None):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``: one
    optimizer step, the loss's and the optimizer's metrics merged."""
    loss_and_grads = make_loss_and_grads(model, mesh=mesh, plan=plan)

    def train_step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(params, batch)
        params, opt_state, opt_metrics = optimizer.update(params, grads, opt_state, mesh=mesh)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(model: LM, mesh=None, plan=None):
    """``(params, tokens, *, patch_embeds=None) -> (greedy next tokens (B,),
    cache)``; a VLM's patches go in as ``patch_embeds``."""
    def prefill_step(params, tokens, *, patch_embeds=None):
        with mesh_context(mesh), use_plan(plan):
            last_logits, cache = model.prefill(params, tokens, patch_embeds=patch_embeds)
        return last_logits.argmax(dim=-1), cache

    return prefill_step


def make_decode_step(model: LM, mesh=None, plan=None):
    """``(params, cache, tokens, pos) -> (greedy tokens (B, 1), logits,
    cache)``."""
    def decode_step(params, cache, tokens, pos):
        with mesh_context(mesh), use_plan(plan):
            logits, cache = model.decode_step(params, cache, tokens, pos)
        return logits.argmax(dim=-1), logits, cache

    return decode_step


def make_prefill_full(model: LM, mesh=None, plan=None):
    """``(params, tokens) -> (logits (B, S, V), cache)``: every position's
    logits.  The engine pads a prompt to a page-aligned bucket before the
    fused prefill, so the last real token's logits sit at ``len - 1``, not
    ``-1``; it takes that row itself."""
    def prefill_full(params, tokens):
        with mesh_context(mesh), use_plan(plan):
            return model.apply(params, tokens, want_cache=True)

    return prefill_full


def make_chunked_prefill_step(model: LM, mesh=None, plan=None):
    """``(params, pool, block_tables, tokens, start, valid_len) -> (logits,
    pool)``: one chunk of prompt prefill into the paged KV pool.  ``tokens``
    (B, C) covers positions [start, start+C); logits of every chunk position
    come back so the engine can take the last real prompt token's row."""
    def chunked_prefill_step(params, pool, block_tables, tokens, start, valid_len):
        with mesh_context(mesh), use_plan(plan):
            return model.prefill_chunk(params, pool, block_tables, tokens, start,
                                       valid_len)

    return chunked_prefill_step


def make_paged_decode_step(model: LM, mesh=None, plan=None):
    """``(params, pool, block_tables, tokens, pos, valid_len=None) ->
    (greedy tokens (B, 1), logits, pool)``: a ragged decode step over the
    paged KV pool, every engine slot at its own ``pos``; rows at or beyond
    their ``valid_len`` write to the trash page."""
    def paged_decode_step(params, pool, block_tables, tokens, pos, valid_len=None):
        with mesh_context(mesh), use_plan(plan):
            logits, pool = model.paged_decode_step(params, pool, block_tables,
                                                   tokens, pos, valid_len=valid_len)
        return logits.argmax(dim=-1), logits, pool

    return paged_decode_step


def make_verify_step(model: LM, mesh=None, plan=None):
    """``(params, pool, block_tables, tokens, start, valid_len) -> (greedy
    tokens (B, C), logits, pool)``: every engine slot scores its committed
    token and k draft proposals (C = k + 1) in one batched pass; greedy
    token ``(b, i)`` is what the sequential paged decode step emits at that
    position."""
    def verify_step(params, pool, block_tables, tokens, start, valid_len):
        with mesh_context(mesh), use_plan(plan):
            logits, pool = model.verify_chunk(params, pool, block_tables, tokens,
                                              start, valid_len)
        return logits.argmax(dim=-1), logits, pool

    return verify_step
