"""Train / prefill / decode step builders — twins of :mod:`repro.launch.steps`.

PyTorch runs eagerly, so a step is a plain closure (the reference jits it).
Gradients are taken functionally, as ``jax.value_and_grad(...,
allow_int=True)``: every float leaf of the parameter tree enters the loss
as a fresh leaf that requires grad (a detached view, no copy), and
``torch.autograd.grad`` returns their gradients; integer leaves get
``None``.
Every ``make_*`` function takes an optional ``mesh`` (a
:class:`repro_torch.launch.mesh.Mesh`, its parameters placed on it by
:func:`repro_torch.runtime.sharding.place`).  A mesh step takes the
global batch on every rank and returns what the unsharded step returns,
on every rank.  Inside, the train, prefill and decode steps of every
family (``PARTITIONED``) run the partitioned program
(:class:`repro_torch.runtime.spmd.Partition`), as GSPMD partitions the
reference's jitted step: at entry each rank takes its rows
(:func:`repro_torch.runtime.sharding.batch_specs`: over the data axes
where they divide, else every row; a VLM's patches too), its ops run on
its share of heads, Mamba2 and mLSTM heads, MLP columns, routed experts,
vocabulary and codebook columns, the loss's mean is the global batch's,
every gradient is summed over the data axes (a whole one's in one
coalesced all-reduce), and at exit the tokens and logits are gathered.
The decode cache between steps stays the rank's: its rows, the KV heads
its query heads read, its Mamba2 or mLSTM heads' state
(:func:`_local_cache`); a decode step given its KV cache's length
(``seq_len``) splits that cache's sequence over ``model`` where the
length divides it, as the reference's ``cache_specs`` lays it out: the
rank keeps its block of positions of every KV head, and attention
combines its softmax across ranks.  A recurrent prompt is served by
:func:`make_stepped_prefill`, through the partitioned decode step.  The
engine's steps (``make_prefill_full``, ``make_chunked_prefill_step``,
``make_paged_decode_step``, ``make_verify_step``) and ``partition=False``
run every op on the global batch on every rank, each packed product a
rank's local problem (:mod:`repro_torch.runtime.spmd`), the plain leaves
taken whole again (:func:`repro_torch.runtime.sharding.gather_plain`;
once a parameter tree outside autograd).
Every ``make_*`` function also takes an optional ``plan`` (a
:class:`repro_torch.core.plan.ModelPlan`): the step body runs inside
:func:`repro_torch.core.plan.use_plan`, so each packed matmul dispatches
with its layer's :class:`~repro_torch.core.plan.PackPlan`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch

from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.plan import use_plan
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.mesh import dp_axes, mesh_context
from repro_torch.models import attention, transformer
from repro_torch.models import cache as cache_mod
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import sharding, spmd

# the families whose mesh steps run the partitioned program
PARTITIONED = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


def partition_for(model: LM, mesh, n_rows: int, rows=None) -> spmd.Partition | None:
    """The partition of a step of ``model`` on ``mesh`` over a batch of
    ``n_rows`` rows, or None (no mesh, or a family that runs whole rows):
    rows over the data axes where they divide (``rows``, when given: the
    axes the batch's rows are already split over)."""
    if mesh is None or model.cfg.family not in PARTITIONED:
        return None
    if rows is None:
        dp = dp_axes(mesh)
        rows = dp if dp and n_rows % spmd._axes_size(mesh, dp) == 0 else ()
    return spmd.Partition(mesh, tuple(rows))


def _take_rows(t, part: spmd.Partition, given: bool):
    """This rank's rows of a global batch tensor (as they are when the
    batch already holds them)."""
    if given or not part.rows or not isinstance(t, torch.Tensor):
        return t
    return spmd.shard_rows(t, part.mesh, part.rows)


def _whole_out(t: torch.Tensor, part: spmd.Partition, cfg) -> torch.Tensor:
    """The global logits from the rank's rows and vocabulary block (an
    audio model's (..., C_l, V_l) block of the flattened (codebook, id)
    columns: gathered flat, then read as (..., C, V))."""
    v = cfg.padded_vocab
    if cfg.family == "audio":
        c = cfg.n_codebooks
        if tuple(t.shape[-2:]) != (c, v):
            t = spmd.all_gather(t.flatten(-2), part.mesh, "model", t.ndim - 2,
                                "output_bytes").unflatten(-1, (c, v))
    elif t.shape[-1] != v and part.tp > 1:
        t = spmd.all_gather(t, part.mesh, "model", t.ndim - 1, "output_bytes")
    return spmd.all_gather(t, part.mesh, part.rows, 0, "output_bytes")


def _local_cache(cache, part: spmd.Partition, model: LM, rows: int):
    """The decode cache as the rank keeps it (``rows`` of them), inside the
    partition: views of its rows (at each leaf's batch axis,
    :meth:`LM.cache_spec`) and of its heads (at the axes
    :func:`repro_torch.models.transformer.cache_heads` names: its block
    where the heads divide ``model``, a KV leaf's the KV heads its query
    heads read, :func:`repro_torch.models.attention.local_heads`) of a
    whole cache; the cache itself where it holds them already.  Where the
    sequence splits (``part.seq``), a KV leaf as :func:`_seq_local` keeps
    it."""
    kv = attention.local_heads(transformer.attn_spec(model.cfg))

    def local(ax, t, heads):
        if part.seq is not None and ax.seq is not None:
            return _seq_local(ax, t, heads, part, rows)
        if t.shape[ax.batch] != rows:
            t = spmd._own_block(t, part.mesh, part.rows, ax.batch)
        block = _head_block(heads, kv)
        if block is not None and t.shape[heads.axis] != block[1]:
            t = t.narrow(heads.axis, *block)
        return t

    return cache_mod.map_axes(local, model.cache_spec(), cache,
                              transformer.cache_heads(model.cfg))


def _seq_local(ax, t, heads, part: spmd.Partition, rows: int):
    """A KV leaf under the sequence split, whose whole length the step was
    given (``part.seq``): the leaf itself where it holds the rank's block
    of positions (as this step returns it, or :func:`~repro_torch.runtime.
    sharding.place` of :func:`~repro_torch.runtime.sharding.
    decode_cache_specs` leaves it); from a leaf of every position (a whole
    cache, or the rank's rows and the KV heads its query heads read, as
    the partitioned prefill returns it), its rows, every KV head
    all-gathered over ``model``, then a copy of its block of positions
    (:func:`repro_torch.runtime.spmd.seq_block`).  Any other length
    raises."""
    first, size = spmd.seq_block()
    n = t.shape[ax.seq]
    if n == size:
        if t.shape[ax.batch] != rows or t.shape[heads.axis] != heads.heads:
            raise ValueError(f"a block of {n} positions of shape {tuple(t.shape)}: want "
                             f"{rows} rows and {heads.heads} KV heads")
        return t
    if n != part.seq:
        raise ValueError(f"a KV leaf of {n} positions on a decode step over {part.seq}: "
                         f"neither every position nor a rank's block of {size}")
    if t.shape[ax.batch] != rows:
        t = spmd._own_block(t, part.mesh, part.rows, ax.batch)
    if t.shape[heads.axis] != heads.heads:
        t = spmd.all_gather(t, part.mesh, "model", heads.axis, "reshard_bytes")
        if t.shape[heads.axis] != heads.heads:   # each rank held the one its heads share
            step = part.tp // heads.heads
            t = t.index_select(heads.axis, torch.arange(0, part.tp, step, device=t.device))
    return t.narrow(ax.seq, first, size).clone(memory_format=torch.contiguous_format)


def _head_block(heads, kv):
    """``(start, size)`` along a cache leaf's head axis of the rank's
    heads (:class:`repro_torch.models.cache.HeadAxis` ``heads``), or None
    where it keeps every head."""
    if heads is None:
        return None
    if heads.kv:
        return None if kv is None else (kv[1], kv[2])
    block = spmd.model_block(heads.heads)
    return None if block is None else (block[0] * heads.width, block[1] * heads.width)


def _plain_grads(grads, part: spmd.Partition):
    """Every plain leaf's gradient summed over the batch axes, in one
    float32 all-reduce (packed leaves' gradients are summed by their
    products' backward)."""
    if not part.rows:
        return grads
    found: list = []

    def walk(t):
        if isinstance(t, (TiledCSC, BlockCSR)):
            return
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            found.append(t)

    walk(grads)
    if not found:
        return grads
    flat = spmd.all_reduce(torch.cat([g.float().reshape(-1) for g in found]), part.mesh,
                           part.rows, "grad_bytes")
    summed = {id(g): s.reshape(g.shape).to(g.dtype)
              for g, s in zip(found, torch.split(flat, [g.numel() for g in found]))}
    return _replace(grads, summed)


def _replace(tree, by_id: dict):
    if isinstance(tree, dict):
        return {k: _replace(v, by_id) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace(v, by_id) for v in tree)
    if isinstance(tree, torch.Tensor):
        return by_id.get(id(tree), tree)
    return tree


# the last parameter tree taken whole outside autograd: (a weak reference
# to one of its split leaves, the tree's id, the whole tree)
_WHOLE: list = []


def whole_params(params, model: LM, mesh):
    """``params`` with its split plain leaves whole again for a step that
    runs whole rows (:func:`repro_torch.runtime.sharding.gather_plain`):
    differentiably while autograd records, else once for a tree (kept
    until that tree's split leaves are freed)."""
    if mesh is None:
        return params
    specs = sharding.layout_specs(params, model.cfg, mesh)
    split = sharding.split_plain(params, specs)
    if not split:
        return params
    if torch.is_grad_enabled():
        return sharding.gather_plain(params, specs, mesh)
    if _WHOLE and _WHOLE[0][0]() is split[0] and _WHOLE[0][1] == id(params):
        return _WHOLE[0][2]
    out = sharding.gather_plain(params, specs, mesh)
    _WHOLE[:] = [(weakref.ref(split[0], lambda _: _WHOLE.clear()), id(params), out)]
    return out


def make_loss_and_grads(model: LM, mesh=None, plan=None, rows=None):
    """``(params, batch) -> (loss, metrics, grads)``: the loss of
    :meth:`LM.loss`, its metrics (detached), and a gradient tree shaped like
    ``params`` (float leaves' gradients in their own dtype, zeros for an
    unused one; ``None`` at integer leaves).  On a mesh each gradient is
    the whole batch's, of the leaf's block the rank holds.  ``rows``: the
    axes the batch's rows are already split over (the dry-run's placed
    batch); None, the global batch."""
    def loss_and_grads(params, batch):
        part = partition_for(model, mesh, batch["tokens"].shape[0], rows)
        with mesh_context(mesh), use_plan(plan), (
                spmd.use_partition(part) if part else contextlib.nullcontext()):
            live = tree_map(lambda p: p.detach().requires_grad_(True)
                            if p.is_floating_point() else p, params)
            leaves = [p for p in tree_leaves(live) if p.requires_grad]
            if part is None:
                loss, metrics = model.loss(whole_params(live, model, mesh), batch)
            else:
                loss, metrics = model.loss(live, {k: _take_rows(v, part, rows is not None)
                                                  for k, v in batch.items()})
            gs = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))
        grads = tree_map(lambda p: next(gs) if p.requires_grad else None, live)
        if part is not None:
            grads = _plain_grads(grads, part)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    return loss_and_grads


def make_train_step(model: LM, optimizer: AdamW, mesh=None, plan=None, rows=None):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``: one
    optimizer step, the loss's and the optimizer's metrics merged.  On a
    mesh the optimizer state may be placed under ZeRO-1
    (:func:`repro_torch.runtime.sharding.opt_state_specs`) or lie as the
    parameters do."""
    loss_and_grads = make_loss_and_grads(model, mesh=mesh, plan=plan, rows=rows)

    def train_step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(params, batch)
        specs = sharding.layout_specs(params, model.cfg, mesh) if mesh is not None else None
        params, opt_state, opt_metrics = optimizer.update(params, grads, opt_state,
                                                          mesh=mesh, specs=specs)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(model: LM, mesh=None, plan=None, partition: bool = True, rows=None):
    """``(params, tokens, *, patch_embeds=None) -> (greedy next tokens (B,),
    cache)``; a VLM's patches go in as ``patch_embeds``.  ``partition=False``
    runs whole rows on a mesh (the engine's reference decode)."""
    def prefill_step(params, tokens, *, patch_embeds=None):
        part = partition_for(model, mesh, tokens.shape[0], rows) if partition else None
        if part is None:
            with mesh_context(mesh), use_plan(plan):
                last_logits, cache = model.prefill(whole_params(params, model, mesh), tokens,
                                                   patch_embeds=patch_embeds)
            return last_logits.argmax(dim=-1), cache
        given = rows is not None
        with mesh_context(mesh), use_plan(plan), spmd.use_partition(part):
            last_logits, cache = model.prefill(
                params, _take_rows(tokens, part, given),
                patch_embeds=_take_rows(patch_embeds, part, given))
        last = _whole_out(last_logits, part, model.cfg)
        return last.argmax(dim=-1), cache

    return prefill_step


def make_decode_step(model: LM, mesh=None, plan=None, partition: bool = True, rows=None,
                     seq_len: int | None = None):
    """``(params, cache, tokens, pos) -> (greedy tokens (B, 1), logits,
    cache)``; ``pos`` an int or (B,).  ``partition=False`` runs whole rows
    on a mesh.  ``seq_len`` is the whole length of the KV cache the step
    serves, given where its sequence is to split over ``model``, as the
    reference's ``cache_specs(seq_len=, seq_shard=True)`` is given it: in
    the partitioned step, where it divides ``model``
    (:func:`repro_torch.runtime.sharding.seq_split`), the step takes a
    cache of every position (whole, or the one the partitioned prefill
    returned, grown to ``seq_len``) or the rank's block of it, and returns
    the rank's block of positions of every KV head (:func:`_seq_local`);
    otherwise the cache keeps the rank's rows and KV heads of every
    position."""
    seq = None if mesh is None else sharding.seq_split(model.cfg, mesh, seq_len)

    def decode_step(params, cache, tokens, pos):
        part = partition_for(model, mesh, tokens.shape[0], rows) if partition else None
        if part is None:
            with mesh_context(mesh), use_plan(plan):
                logits, cache = model.decode_step(whole_params(params, model, mesh), cache,
                                                  tokens, pos)
            return logits.argmax(dim=-1), logits, cache
        tokens = _take_rows(tokens, part, rows is not None)
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            pos = _take_rows(pos, part, rows is not None)
        if seq is not None:
            part = dataclasses.replace(part, seq=seq)
        with mesh_context(mesh), use_plan(plan), spmd.use_partition(part):
            cache = _local_cache(cache, part, model, tokens.shape[0])
            logits, cache = model.decode_step(params, cache, tokens, pos)
        logits = _whole_out(logits, part, model.cfg)
        return logits.argmax(dim=-1), logits, cache

    return decode_step


def make_stepped_prefill(model: LM, mesh=None, plan=None, seq_shard: bool = True):
    """``(params, tokens, max_len) -> (greedy next tokens (B,), cache)``: the
    prompt served as ``launch/serve.py:prefill_cache`` serves a recurrent
    family's, stepped through :func:`make_decode_step` from a zeroed cache
    of ``max_len`` positions (which builds the state exactly); on a mesh
    through the partitioned decode step, from the rank's own zeroed rows
    and heads, a KV leaf's block of positions where ``seq_shard`` splits
    its sequence (the decode step to follow is then given ``seq_len =
    max_len``)."""
    def stepped_prefill(params, tokens, max_len):
        seq_len = max_len if seq_shard else None
        decode = make_decode_step(model, mesh=mesh, plan=plan, seq_len=seq_len)
        b = tokens.shape[0]
        part = partition_for(model, mesh, b)
        if part is None:
            cache = model.init_cache(b, max_len, tokens.device)
        else:
            rows = b // spmd._axes_size(part.mesh, part.rows)
            part = dataclasses.replace(part, seq=sharding.seq_split(model.cfg, mesh, seq_len))
            zero = model.init_cache(rows, max_len // (part.tp if part.seq else 1),
                                    tokens.device)
            with spmd.use_partition(part):
                cache = cache_mod.map_axes(lambda _, t: t.clone(), model.cache_spec(),
                                           _local_cache(zero, part, model, rows))
        for t in range(tokens.shape[1]):
            nxt, _, cache = decode(params, cache, tokens[:, t:t + 1], t)
        return nxt[:, 0], cache

    return stepped_prefill


def make_prefill_full(model: LM, mesh=None, plan=None):
    """``(params, tokens) -> (logits (B, S, V), cache)``: every position's
    logits.  The engine pads a prompt to a page-aligned bucket before the
    fused prefill, so the last real token's logits sit at ``len - 1``, not
    ``-1``; it takes that row itself."""
    def prefill_full(params, tokens):
        with mesh_context(mesh), use_plan(plan):
            return model.apply(whole_params(params, model, mesh), tokens, want_cache=True)

    return prefill_full


def make_chunked_prefill_step(model: LM, mesh=None, plan=None):
    """``(params, pool, block_tables, tokens, start, valid_len) -> (logits,
    pool)``: one chunk of prompt prefill into the paged KV pool.  ``tokens``
    (B, C) covers positions [start, start+C); logits of every chunk position
    come back so the engine can take the last real prompt token's row."""
    def chunked_prefill_step(params, pool, block_tables, tokens, start, valid_len):
        with mesh_context(mesh), use_plan(plan):
            return model.prefill_chunk(whole_params(params, model, mesh), pool, block_tables,
                                       tokens, start, valid_len)

    return chunked_prefill_step


def make_paged_decode_step(model: LM, mesh=None, plan=None):
    """``(params, pool, block_tables, tokens, pos, valid_len=None) ->
    (greedy tokens (B, 1), logits, pool)``: a ragged decode step over the
    paged KV pool, every engine slot at its own ``pos``; rows at or beyond
    their ``valid_len`` write to the trash page."""
    def paged_decode_step(params, pool, block_tables, tokens, pos, valid_len=None):
        with mesh_context(mesh), use_plan(plan):
            logits, pool = model.paged_decode_step(whole_params(params, model, mesh), pool,
                                                   block_tables, tokens, pos,
                                                   valid_len=valid_len)
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
            logits, pool = model.verify_chunk(whole_params(params, model, mesh), pool,
                                              block_tables, tokens, start, valid_len)
        return logits.argmax(dim=-1), logits, pool

    return verify_step
