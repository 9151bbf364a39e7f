"""Attention-family decoder: full-sequence forward and cached decode.

Twin of the ``TransformerLM`` functions of :mod:`repro.models.transformer`
for the dense family with tied embeddings (llama).  Layers are a Python loop
over per-layer parameter dicts — the reference's ``scan_layers=False``
lowering — so every packed projection is one unstacked operand and runs the
fused kernel.  The paged functions serve the continuous-batching engine:
its KV pool is ``{"k", "v"}`` of shape (L, n_pages, page, KV, hd) — layer,
page id, offset in the page, KV head, head dim — where the reference stacks
(G, P, n_pages, page, KV, hd); every layer indexes its pool with the same
block tables.  The pool, like the static cache, is updated in place.  MoE,
the hybrid and xLSTM assemblies and the untied / soft-capped heads are not
ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as plan_mod
from repro_torch.core import sod
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import layers

Params = dict[str, Any]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The working dtype named by ``cfg.dtype``."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for model features this slice of the port does not have."""
    missing = [what for what, bad in (
        (f"family {cfg.family!r}", cfg.family != "dense"),
        ("untied LM head", not cfg.tie_embeddings),
        ("post norms", cfg.use_post_norms),
        ("final logit soft-cap", cfg.final_softcap is not None),
    ) if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet")


def attn_spec(cfg: ModelConfig) -> attn.AttnSpec:
    """The attention spec of every layer of ``cfg``."""
    return attn.AttnSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, scale=cfg.attn_scale,
        softcap=cfg.attn_softcap, chunk_q=cfg.attn_chunk,
        chunk_k=cfg.attn_chunk)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_attn_block(gen: torch.Generator, cfg: ModelConfig,
                    device: torch.device) -> Params:
    """One layer: two RMSNorm gains, attention and MLP projections."""
    dt = dtype_of(cfg)
    return {
        "norm1": layers.init_rms_norm(cfg.d_model, device),
        "norm2": layers.init_rms_norm(cfg.d_model, device),
        "attn": attn.init_attention(gen, cfg.d_model, attn_spec(cfg), dt, device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def init_transformer(gen: torch.Generator, cfg: ModelConfig,
                     device: torch.device) -> Params:
    """``{"embed", "final_norm", "layers": [per-layer dicts]}``."""
    check_supported(cfg)
    layer_params = [init_attn_block(gen, cfg, device) for _ in range(cfg.n_layers)]
    return {
        "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                   dtype_of(cfg), device),
        "final_norm": layers.init_rms_norm(cfg.d_model, device),
        "layers": layer_params,
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _mlp(bp: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # the active plan's entries for this block's projections (the layer
    # stack shares one path, hence one entry)
    return layers.mlp(bp["mlp"], h, cfg.act, plans=plan_mod.active_subplans("mlp"))


def attn_block_full(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, window: int | None):
    """Full-sequence block.  Returns (x, (k, v))."""
    spec = attn_spec(cfg)
    h = layers.rms_norm(x, bp["norm1"], cfg.norm_eps)
    q, k, v = attn._project_qkv(bp["attn"], h, spec, positions)
    s = x.shape[1]
    eff_window = None if (window is None or window >= s) else window
    ao = attn.chunked_attention(q, k, v, spec, window=eff_window)
    x = x + sod.apply(ao.reshape(*x.shape[:2], -1), bp["attn"]["wo"],
                      plan=plan_mod.active_entry("attn.wo"))
    h2 = layers.rms_norm(x, bp["norm2"], cfg.norm_eps)
    return x + _mlp(bp, h2, cfg), (k, v)


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
    x = x + ao
    h2 = layers.rms_norm(x, bp["norm2"], cfg.norm_eps)
    return x + _mlp(bp, h2, cfg), cache


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
    x = x + sod.apply(ao, bp["attn"]["wo"], plan=plan_mod.active_entry("attn.wo"))
    h2 = layers.rms_norm(x, bp["norm2"], cfg.norm_eps)
    return x + _mlp(bp, h2, cfg), layer_pool


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
    over all B·C rows; the norms and the attention core run once a window
    position at the decode step's shape; everything else is elementwise."""
    h = _norm_rows(x, bp["norm1"], cfg.norm_eps)
    ao, layer_pool = attn.paged_verify_attention(
        bp["attn"], h, layer_pool, block_tables, start, valid_len,
        attn_spec(cfg), window=window)
    x = x + ao
    h2 = _norm_rows(x, bp["norm2"], cfg.norm_eps)
    return x + _mlp(bp, h2, cfg), layer_pool


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def project_logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm and tied LM head: float32 logits over the padded
    vocabulary, padded ids masked to -1e30."""
    return _head(params, layers.rms_norm(x, params["final_norm"], cfg.norm_eps), cfg)


def _head(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The tied LM head on the final-normed ``h``.

    As the reference's dot with ``preferred_element_type=float32``: operands
    in h's dtype, products summed in float32, and the f32 sums are the
    logits, never rounded to bfloat16 on the way (:func:`ops.dense_matmul`).
    """
    logits = ops.dense_matmul(h, params["embed"].to(h.dtype).T, torch.float32)
    v = cfg.padded_vocab
    if v != cfg.vocab:
        pad = torch.arange(v, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    return logits


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------
def transformer_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                        want_cache: bool = False):
    """Logits (B, S, V) and, with ``want_cache``, the KV cache
    ``{"k", "v"}`` of shape (L, B, S, KV, hd)."""
    x = layers.embed(params["embed"], tokens, scale=cfg.embed_scale)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    ks, vs = [], []
    for i, bp in enumerate(params["layers"]):
        x, (k, v) = attn_block_full(bp, x, cfg, positions, cfg.window_for(i))
        if want_cache:
            ks.append(k)
            vs.append(v)
    logits = project_logits(params, x, cfg)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if want_cache else None
    return logits, cache


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
    decode step over B rows against static serving's one (not held
    row-invariant).  Returns (logits (B, C, V), pool); the pool is updated
    in place."""
    x = layers.embed(params["embed"], tokens, scale=cfg.embed_scale)
    for i, bp in enumerate(params["layers"]):
        x, _ = attn_block_verify(bp, x, _layer_pool(pool, i), block_tables,
                                 start, valid_len, cfg, cfg.window_for(i))
    return _head(params, _norm_rows(x, params["final_norm"], cfg.norm_eps), cfg), pool
