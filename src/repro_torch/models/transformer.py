"""Attention-family decoder: full-sequence forward and cached decode.

Twin of the ``TransformerLM`` functions of :mod:`repro.models.transformer`
for the dense and MoE families: tied or untied LM head, gemma-2's post
norms, final logit soft-cap and local/global layers, and a block's MLP
either dense or the Mixture-of-Experts block of :mod:`repro_torch.models.moe`
(whose router aux loss the full forward sums over the layers; the decode,
prefill-chunk and verify paths drop it, as the reference does).  Layers are
a Python loop over per-layer parameter dicts — the reference's
``scan_layers=False`` lowering — so every packed projection is one
unstacked operand and runs the fused kernel.  The paged functions serve the
continuous-batching engine: its KV pool is ``{"k", "v"}`` of shape (L,
n_pages, page, KV, hd) — layer, page id, offset in the page, KV head, head
dim — where the reference stacks (G, P, n_pages, page, KV, hd); every layer
indexes its pool with the same block tables.  The pool, like the static
cache, is updated in place.  An untied head is a packed ``head`` leaf like
any projection, so it runs the Sparse-on-Dense kernel with float32 out.
The hybrid and xLSTM assemblies and the VLM and audio frontends are not
ported yet.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as plan_mod
from repro_torch.core import sod
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe

Params = dict[str, Any]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The working dtype named by ``cfg.dtype``."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a model family the port does not have yet (all but dense
    and MoE)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} not ported yet")


def attn_spec(cfg: ModelConfig) -> attn.AttnSpec:
    """The attention spec of every layer of ``cfg``."""
    return attn.AttnSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, scale=cfg.attn_scale,
        softcap=cfg.attn_softcap, chunk_q=cfg.attn_chunk,
        chunk_k=cfg.attn_chunk)


def moe_spec(cfg: ModelConfig) -> moe.MoESpec:
    """The MoE spec of every layer of an MoE ``cfg``."""
    return moe.MoESpec(
        n_experts=cfg.n_experts,
        n_experts_padded=moe.pad_experts(cfg.n_experts, cfg.ep_axis),
        top_k=cfg.top_k, d_model=cfg.d_model, d_ff=cfg.d_ff,
        n_shared=cfg.n_shared_experts, d_shared_ff=cfg.d_shared_ff,
        capacity_factor=cfg.capacity_factor,
        router_aux_weight=cfg.router_aux_weight, act=cfg.act,
        dispatch_blocks=cfg.moe_dispatch_blocks, a2a_axis=cfg.moe_a2a_axis)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_attn_block(gen: torch.Generator, cfg: ModelConfig,
                    device: torch.device) -> Params:
    """One layer: two RMSNorm gains, attention projections, the MLP (``moe``
    for the MoE family, else ``mlp``), and with ``cfg.use_post_norms`` the
    gains of the norms after attention and MLP."""
    dt = dtype_of(cfg)
    p: Params = {
        "norm1": layers.init_rms_norm(cfg.d_model, device),
        "norm2": layers.init_rms_norm(cfg.d_model, device),
        "attn": attn.init_attention(gen, cfg.d_model, attn_spec(cfg), dt, device),
    }
    if cfg.family == "moe":
        p["moe"] = moe.init_moe(gen, moe_spec(cfg), dt, device)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
    if cfg.use_post_norms:
        p["norm1_post"] = layers.init_rms_norm(cfg.d_model, device)
        p["norm2_post"] = layers.init_rms_norm(cfg.d_model, device)
    return p


def init_embed_head(gen: torch.Generator, cfg: ModelConfig,
                    device: torch.device) -> Params:
    """``{"embed", "final_norm"}``, and ``"head"`` (d_model, padded vocab)
    when the embeddings are untied.  The VLM and audio frontends raise."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} frontend is not ported yet")
    dt = dtype_of(cfg)
    p: Params = {"embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                            dt, device),
                 "final_norm": layers.init_rms_norm(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["head"] = layers.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt, device)
    return p


def init_transformer(gen: torch.Generator, cfg: ModelConfig,
                     device: torch.device) -> Params:
    """``{"embed", "final_norm", ["head",] "layers": [per-layer dicts]}``;
    the layers are drawn first, then the embedding and the head."""
    check_supported(cfg)
    layer_params = [init_attn_block(gen, cfg, device) for _ in range(cfg.n_layers)]
    return {**init_embed_head(gen, cfg, device), "layers": layer_params}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _post_norm(bp: Params, name: str, y: torch.Tensor, cfg: ModelConfig,
               rows: bool = False) -> torch.Tensor:
    """gemma-2's sandwich norm ``name`` on a sub-block's output ``y`` under
    ``cfg.use_post_norms``, else ``y``; with ``rows`` one window position
    at a time (:func:`_norm_rows`)."""
    if not cfg.use_post_norms:
        return y
    if rows:
        return _norm_rows(y, bp[name], cfg.norm_eps)
    return layers.rms_norm(y, bp[name], cfg.norm_eps)


def _apply_mlp(bp: Params, h: torch.Tensor, cfg: ModelConfig):
    """The block's MLP: ``(y, aux)``, the MoE block's router aux loss or 0.
    The active plan's entries for the block's projections go with it (the
    layer stack shares one path, hence one entry): the MLP's, or the MoE
    shared expert's."""
    if cfg.family == "moe":
        return moe.moe_mlp(bp["moe"], h, moe_spec(cfg),
                           plans=plan_mod.active_subplans("shared"))
    return layers.mlp(bp["mlp"], h, cfg.act,
                      plans=plan_mod.active_subplans("mlp")), 0.0


def attn_block_full(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, window: int | None):
    """Full-sequence block.  Returns (x, (k, v), aux)."""
    spec = attn_spec(cfg)
    h = layers.rms_norm(x, bp["norm1"], cfg.norm_eps)
    q, k, v = attn._project_qkv(bp["attn"], h, spec, positions)
    s = x.shape[1]
    eff_window = None if (window is None or window >= s) else window
    ao = attn.chunked_attention(q, k, v, spec, window=eff_window)
    ao = sod.apply(ao.reshape(*x.shape[:2], -1), bp["attn"]["wo"],
                   plan=plan_mod.active_entry("attn.wo"))
    x = x + _post_norm(bp, "norm1_post", ao, cfg)
    h2 = layers.rms_norm(x, bp["norm2"], cfg.norm_eps)
    mo, aux = _apply_mlp(bp, h2, cfg)
    return x + _post_norm(bp, "norm2_post", mo, cfg), (k, v), aux


def attn_block_decode(bp: Params, x: torch.Tensor, cache: Params, pos,
                      cfg: ModelConfig, window: int | None,
                      block_tables: torch.Tensor | None = None,
                      valid_len: torch.Tensor | None = None):
    """One decode block.  ``cache`` is this layer's dense ``{"k", "v"}``
    cache slice, or — when ``block_tables`` is given — its slice of the paged
    KV pool; ``valid_len`` (paged only) is the per-row write cutoff of
    :func:`repro_torch.models.attention.paged_decode_attention`."""
    spec = attn_spec(cfg)
    h = layers.rms_norm(x, bp["norm1"], cfg.norm_eps)
    if block_tables is None:
        ao, cache = attn.decode_attention(bp["attn"], h, cache, pos, spec,
                                          window=window)
    else:
        ao, cache = attn.paged_decode_attention(
            bp["attn"], h, cache, block_tables, pos, spec, window=window,
            valid_len=valid_len)
    x = x + _post_norm(bp, "norm1_post", ao, cfg)
    h2 = layers.rms_norm(x, bp["norm2"], cfg.norm_eps)
    return x + _post_norm(bp, "norm2_post", _apply_mlp(bp, h2, cfg)[0], cfg), cache


def attn_block_prefill_chunk(bp: Params, x: torch.Tensor, layer_pool: Params,
                             block_tables: torch.Tensor, start: int,
                             valid_len: int, cfg: ModelConfig,
                             window: int | None):
    """One block over a prefill chunk against the paged KV pool: the norm /
    residual order of :func:`attn_block_full` with the full-sequence
    attention replaced by
    :func:`repro_torch.models.attention.paged_prefill_attention`, so a prompt
    prefilled in chunks gives the tokens of one fused prefill."""
    h = layers.rms_norm(x, bp["norm1"], cfg.norm_eps)
    ao, layer_pool = attn.paged_prefill_attention(
        bp["attn"], h, layer_pool, block_tables, start, valid_len,
        attn_spec(cfg), window=window)
    ao = sod.apply(ao, bp["attn"]["wo"], plan=plan_mod.active_entry("attn.wo"))
    x = x + _post_norm(bp, "norm1_post", ao, cfg)
    h2 = layers.rms_norm(x, bp["norm2"], cfg.norm_eps)
    return x + _post_norm(bp, "norm2_post", _apply_mlp(bp, h2, cfg)[0], cfg), layer_pool


def _norm_rows(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of a verify window one position at a time, each call at the
    decode step's shape (B, 1, D): torch's reduction then keeps each row's
    bits, which it need not do at B·C rows at once (on the card 2 of 320
    rows differed at 20 rows against 4; ``PERF.md`` §6)."""
    return torch.cat([layers.rms_norm(x[:, i:i + 1].contiguous(), gain, eps)
                      for i in range(x.shape[1])], 1)


def attn_block_verify(bp: Params, x: torch.Tensor, layer_pool: Params,
                      block_tables: torch.Tensor, start: torch.Tensor,
                      valid_len: torch.Tensor, cfg: ModelConfig,
                      window: int | None):
    """One block over a speculative verification window: the paged branch
    of :func:`attn_block_decode` (same norm / residual order, ``wo`` inside
    the attention call) with the one-token attention replaced by
    :func:`repro_torch.models.attention.paged_verify_attention`, so row
    ``b`` scores C window positions from ``start[b]``.  The matmuls run once
    over all B·C rows; the norms (the post norms too) and the attention
    core run once a window position at the decode step's shape; everything
    else is elementwise."""
    h = _norm_rows(x, bp["norm1"], cfg.norm_eps)
    ao, layer_pool = attn.paged_verify_attention(
        bp["attn"], h, layer_pool, block_tables, start, valid_len,
        attn_spec(cfg), window=window)
    x = x + _post_norm(bp, "norm1_post", ao, cfg, rows=True)
    h2 = _norm_rows(x, bp["norm2"], cfg.norm_eps)
    mo = _post_norm(bp, "norm2_post", _apply_mlp(bp, h2, cfg)[0], cfg, rows=True)
    return x + mo, layer_pool


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def project_logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm and LM head: float32 logits over the padded vocabulary,
    soft-capped, padded ids masked to -1e30."""
    return _head(params, layers.rms_norm(x, params["final_norm"], cfg.norm_eps), cfg)


def _head(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The LM head on the final-normed ``h``, in the reference's order
    (``src/repro/models/transformer.py:286-304``): the logits, then
    ``cfg.final_softcap``, then the padded-vocabulary mask.

    Tied: the embedding table through
    :func:`repro_torch.kernels.ops.dense_matmul`, operands in
    h's dtype, products summed in float32, and the f32 sums are the logits,
    never rounded to bfloat16 on the way.  Untied: the ``head`` weight
    through :func:`repro_torch.core.sod.apply` with float32 out and the
    active plan's ``head`` entry, so a packed head runs the SoD kernel.
    """
    tied = cfg.tie_embeddings
    logits = layers.lm_head(h, params["embed"] if tied else params["head"], tied,
                            cfg.final_softcap, plan=plan_mod.active_entry("head"))
    v = cfg.padded_vocab
    if v != cfg.vocab:
        pad = torch.arange(v, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    return logits


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------
def _remat_block(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, window: int | None):
    """:func:`attn_block_full` under activation checkpointing (the
    reference's ``jax.checkpoint`` of ``cfg.remat``): the block keeps only
    its inputs, and autograd runs its forward again, under the pack plan
    active now, before its backward — every matmul of the block launches
    twice a step."""
    plan = plan_mod.active_plan()
    return checkpoint(attn_block_full, bp, x, cfg, positions, window,
                      use_reentrant=False,
                      context_fn=lambda: (plan_mod.use_plan(plan),
                                          plan_mod.use_plan(plan)))


def transformer_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                        want_cache: bool = False):
    """``(logits (B, S, V), aux, cache)``: ``aux`` is the MoE blocks'
    router aux losses summed over the layers (a float32 scalar; the float 0
    for the dense family), ``cache`` with ``want_cache`` the KV cache
    ``{"k", "v"}`` of shape (L, B, S, KV, hd), else None.  Under
    ``cfg.remat`` (full width) a forward that records gradients checkpoints
    every block."""
    x = layers.embed(params["embed"], tokens, scale=cfg.embed_scale)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    ks, vs = [], []
    aux = 0.0
    remat = cfg.remat and not want_cache and torch.is_grad_enabled()
    block = _remat_block if remat else attn_block_full
    for i, bp in enumerate(params["layers"]):
        x, (k, v), a = block(bp, x, cfg, positions, cfg.window_for(i))
        aux = aux + a
        if want_cache:
            ks.append(k)
            vs.append(v)
    logits = project_logits(params, x, cfg)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if want_cache else None
    return logits, aux, cache


def transformer_decode(params: Params, cache: Params, tokens: torch.Tensor,
                       pos: int, cfg: ModelConfig):
    """One decode step at scalar ``pos``: tokens (B, 1) → logits (B, 1, V);
    the cache is updated in place and returned."""
    x = layers.embed(params["embed"], tokens, scale=cfg.embed_scale)
    for i, bp in enumerate(params["layers"]):
        slot = {"k": cache["k"][i], "v": cache["v"][i]}   # views into the cache
        x, _ = attn_block_decode(bp, x, slot, pos, cfg, cfg.window_for(i))
    return project_logits(params, x, cfg), cache


def transformer_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                           device: torch.device) -> Params:
    """Zeroed KV cache (L, B, max_len, KV, hd) in the working dtype."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# paged decode / chunked prefill (continuous-batching engine)
# ---------------------------------------------------------------------------
def transformer_init_paged_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                                device: torch.device) -> Params:
    """Zeroed per-layer KV page pools, ``{"k", "v"}`` of shape
    (L, n_pages, page, KV, hd) in the working dtype.  A sequence's logical
    block j lives at one page id in every layer, so the engine keeps a
    single (slots, max_pages) block table."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _layer_pool(pool: Params, i: int) -> Params:
    return {"k": pool["k"][i], "v": pool["v"][i]}     # views into the pool


def transformer_decode_paged(params: Params, pool: Params,
                             block_tables: torch.Tensor, tokens: torch.Tensor,
                             pos: torch.Tensor, cfg: ModelConfig,
                             valid_len: torch.Tensor | None = None):
    """One ragged decode step over the paged KV pool: tokens (B, 1), ``pos``
    (B,) — one position per engine slot — and block tables (B, max_pages),
    all int64.  ``valid_len`` (optional, (B,)) gates each row's KV write:
    rows at or beyond their cutoff write to the trash page.  Returns
    (logits (B, 1, V), pool); the pool is updated in place."""
    x = layers.embed(params["embed"], tokens, scale=cfg.embed_scale)
    for i, bp in enumerate(params["layers"]):
        x, _ = attn_block_decode(bp, x, _layer_pool(pool, i), pos, cfg,
                                 cfg.window_for(i), block_tables=block_tables,
                                 valid_len=valid_len)
    return project_logits(params, x, cfg), pool


def transformer_prefill_chunk(params: Params, pool: Params,
                              block_tables: torch.Tensor, tokens: torch.Tensor,
                              start: int, valid_len: int, cfg: ModelConfig):
    """Prefill one fixed-size chunk of a prompt into the paged KV pool.

    ``tokens`` (B, C) — the engine admits one sequence at a time, B = 1 —
    covers prompt positions ``[start, start + C)``, zero-padded past
    ``valid_len`` (pad KV goes to the trash page).  Returns (logits for all
    C positions (B, C, V), pool); the engine takes the last real prompt
    position's row for the sequence's first token."""
    x = layers.embed(params["embed"], tokens, scale=cfg.embed_scale)
    for i, bp in enumerate(params["layers"]):
        x, _ = attn_block_prefill_chunk(bp, x, _layer_pool(pool, i),
                                        block_tables, start, valid_len, cfg,
                                        cfg.window_for(i))
    return project_logits(params, x, cfg), pool


def transformer_verify_chunk(params: Params, pool: Params,
                             block_tables: torch.Tensor, tokens: torch.Tensor,
                             start: torch.Tensor, valid_len: torch.Tensor,
                             cfg: ModelConfig):
    """Verify a speculative window for every engine slot at once.

    ``tokens`` (B, C): row ``b`` holds its committed last token and C - 1
    draft proposals, at cache positions ``[start[b], start[b] + C)``; writes
    at or beyond ``valid_len[b]`` go to the trash page.  It is
    :func:`transformer_decode_paged` with each block swapped for
    :func:`attn_block_verify` and the final norm taken a position at a
    time, so up to the LM head row ``(b, i)`` is what the sequential decode
    step gives at position ``start[b] + i`` after the window's first i
    tokens.  The head is one matmul over all B·C rows, like the engine's
    decode step over B rows against static serving's one: a tied head's
    GEMM is not held row-invariant, an untied head's SoD kernel is by
    design (its K splits do not depend on M).  Returns (logits (B, C, V), pool); the pool is updated
    in place."""
    x = layers.embed(params["embed"], tokens, scale=cfg.embed_scale)
    for i, bp in enumerate(params["layers"]):
        x, _ = attn_block_verify(bp, x, _layer_pool(pool, i), block_tables,
                                 start, valid_len, cfg, cfg.window_for(i))
    return _head(params, _norm_rows(x, params["final_norm"], cfg.norm_eps), cfg), pool
