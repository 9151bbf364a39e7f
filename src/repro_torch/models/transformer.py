"""Model assemblies: full-sequence forward and cached decode.

Twin of :mod:`repro.models.transformer` for three assemblies:

* the attention-family decoder (dense, MoE, and the VLM and audio
  backbones): tied or untied LM head,
  gemma-2's post norms, final logit soft-cap and local/global layers, and a
  block's MLP either dense or the Mixture-of-Experts block of
  :mod:`repro_torch.models.moe` (whose router aux loss the full forward
  sums over the layers; the decode, prefill-chunk and verify paths drop
  it, as the reference does).  Layers are a Python loop over per-layer
  parameter dicts in ``params["layers"]`` — the reference's
  ``scan_layers=False`` lowering — so every packed projection is one
  unstacked operand and runs the fused kernel.  The paged functions serve
  the continuous-batching engine: its KV pool is ``{"k", "v"}`` of shape
  (L, n_pages, page, KV, hd) — layer, page id, offset in the page, KV
  head, head dim — where the reference stacks (G, P, n_pages, page, KV,
  hd); every layer indexes its pool with the same block tables.  The pool,
  like the static cache, is updated in place.  An untied head is a packed
  ``head`` leaf like any projection, so it runs the Sparse-on-Dense kernel
  with float32 out.  The frontends (:func:`embed_inputs`) are the
  reference's stubs: the VLM projects precomputed patch embeddings through
  a dense ``patch_proj`` and prepends them to the text; the audio model
  sums one embedding table a codebook stream and its untied head predicts
  every codebook at once, logits (..., n_codebooks, padded vocab);
* the hybrid (zamba2): groups of ``hybrid_attn_every`` Mamba2 blocks
  (``params["mamba_blocks"][g][j]``), each group followed by the one
  weight-shared attention + MLP block ``params["shared_attn"]``, which
  keeps a KV cache of its own for every application;
* the xLSTM: groups of ``slstm_every - 1`` mLSTM blocks
  (``params["mlstm_blocks"][g][j]``) and one sLSTM block
  (``params["slstm_blocks"][g]``).

The recurrent assemblies' decode caches keep the reference's stacked
layout, (G, P, B, ...) for per-block state and (G, B, S, KV, hd) for the
shared block's KV, updated in place; their full forward returns no
recurrent state (the serve path and the engine build it by stepping the
prompt through the decode step, as the reference does).  Under
``cfg.remat`` a forward that records gradients checkpoints every layer
group of these two (every block of the attention family).

Every family's full forward and static decode also run as the
partitioned program of a mesh step (:func:`repro_torch.runtime.spmd.use_partition`,
the train, prefill and decode steps): the residual stream is the rank's
rows, whole along d_model; attention, the MLP, the routed experts, the
Mamba2 and mLSTM blocks and the head run on the rank's share of heads,
columns, experts and vocabulary (:mod:`repro_torch.models.layers`,
:mod:`repro_torch.models.attention`, :mod:`repro_torch.models.moe`,
:mod:`repro_torch.models.ssm`, :mod:`repro_torch.models.xlstm`), and the
decode cache holds the rank's rows, the KV heads its query heads read
and its Mamba2 or mLSTM heads' state (:func:`cache_heads`), each layer's
slice going in and coming out as the rank holds it.  Where the decode
step splits a KV cache's sequence over ``model`` (the reference's
``cache_specs``; :func:`repro_torch.runtime.spmd.seq_block`), a KV leaf
holds the rank's block of positions of every KV head instead, and the
attention of every family that keeps one (the hybrid's shared block too)
combines its softmax over ``model``
(:func:`repro_torch.models.attention.decode_attention`).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as plan_mod
from repro_torch.core import sod
from repro_torch.models import attention as attn
from repro_torch.models import cache as cache_mod
from repro_torch.models import layers, moe, ssm, xlstm
from repro_torch.runtime import spmd

Params = dict[str, Any]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The working dtype named by ``cfg.dtype``."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a model family the reference does not have."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one of {FAMILIES}")


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


def mamba_spec(cfg: ModelConfig) -> ssm.MambaSpec:
    """The Mamba2 spec of every block of a hybrid ``cfg``."""
    return ssm.MambaSpec(d_model=cfg.d_model, d_state=cfg.ssm_state,
                         expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                         conv_width=cfg.ssm_conv, chunk=cfg.ssm_chunk)


def xlstm_spec(cfg: ModelConfig) -> xlstm.XLSTMSpec:
    """The xLSTM spec of every block of an ``ssm`` ``cfg``."""
    return xlstm.XLSTMSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                           proj_factor=cfg.xlstm_proj_factor, chunk=cfg.ssm_chunk)


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
    """``{"embed", "final_norm"}``, ``"head"`` (d_model, padded vocab) when
    the embeddings are untied, and the VLM's ``"patch_proj"``
    (frontend_dim, d_model).  The audio model's ``"embed"`` is a stack of
    one table a codebook, (n_codebooks, padded vocab, d_model), and its
    ``"head"`` (d_model, n_codebooks · padded vocab) is untied whatever
    ``tie_embeddings`` says, as the reference's."""
    dt = dtype_of(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    if cfg.family == "audio":
        return {"embed": torch.stack([layers.embed_init(gen, v, d, dt, device)
                                      for _ in range(cfg.n_codebooks)]),
                "final_norm": layers.init_rms_norm(d, device),
                "head": layers.dense_init(gen, d, cfg.n_codebooks * v, dt, device)}
    p: Params = {"embed": layers.embed_init(gen, v, d, dt, device),
                 "final_norm": layers.init_rms_norm(d, device)}
    if not cfg.tie_embeddings:
        p["head"] = layers.dense_init(gen, d, v, dt, device)
    if cfg.family == "vlm":
        p["patch_proj"] = layers.dense_init(gen, cfg.frontend_dim, d, dt, device)
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
                      plans=plan_mod.active_subplans("mlp"), d_ff=cfg.d_ff), 0.0


def attn_block_full(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, window: int | None):
    """Full-sequence block.  Returns (x, (k, v), aux); in the partitioned
    program k and v as the rank's cache keeps them."""
    spec = attn_spec(cfg)
    h = layers.rms_norm(x, bp["norm1"], cfg.norm_eps)
    q, k, v = attn._project_qkv(bp["attn"], h, spec, positions)
    s = x.shape[1]
    eff_window = None if (window is None or window >= s) else window
    ao = attn.chunked_attention(q, k, v, spec, window=eff_window)
    ao = layers.linear(ao.reshape(*x.shape[:2], -1), bp["attn"]["wo"],
                       cfg.n_heads * cfg.head_dim, cfg.d_model,
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
# embedding / head / frontends
# ---------------------------------------------------------------------------
def embed_inputs(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The residual stream's input, (B, S, d_model) in the working dtype.

    Audio: ``tokens`` (B, S, n_codebooks), the sum of each codebook's
    embedding, added from 0 in codebook order in the working dtype, as the
    reference's ``sum``.  Otherwise ``tokens`` (B, S) through the table
    (gemma's sqrt(d) scale under ``cfg.embed_scale``).  VLM with
    ``patch_embeds`` (B, n_patches, frontend_dim): the patches cast to the
    working dtype, projected by the dense ``patch_proj`` through
    :func:`repro_torch.core.sod.apply` (float32 sums rounded once to the
    working dtype) and put before the text, so the stream is (B, n_patches
    + S, d_model).  In the partitioned program ``tokens`` and
    ``patch_embeds`` are the rank's rows: the tables are vocabulary blocks
    (:func:`repro_torch.models.layers.embed_codebooks`,
    :func:`~repro_torch.models.layers.embed`) and ``patch_proj`` is whole."""
    if cfg.family == "audio":
        x = layers.embed_codebooks(params["embed"], tokens, cfg.padded_vocab)
    else:
        x = layers.embed(params["embed"], tokens, scale=cfg.embed_scale,
                         vocab=cfg.padded_vocab)
    if cfg.family == "vlm" and patch_embeds is not None:
        prefix = sod.apply(patch_embeds.to(x.dtype), params["patch_proj"])
        x = torch.cat([prefix, x], dim=1)
    return x


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
    Audio: the untied head, its (..., n_codebooks · padded vocab) logits
    read as (..., n_codebooks, padded vocab), the codebook the slower index.
    In the partitioned program the logits may be the rank's vocabulary
    block (:func:`repro_torch.models.layers.lm_head`), for audio the
    rank's block of the flattened (codebook, id) columns read as (...,
    C_l, V_l) (:func:`repro_torch.models.layers.codebook_block`; whole
    again where the block cuts codebooks unevenly); the padded ids are
    masked at their global positions.
    """
    audio = cfg.family == "audio"
    tied = cfg.tie_embeddings and not audio
    v = cfg.padded_vocab
    n = cfg.n_codebooks * v if audio else v
    logits = layers.lm_head(h, params["embed"] if tied else params["head"], tied,
                            cfg.final_softcap, plan=plan_mod.active_entry("head"), vocab=n)
    cols = logits.shape[-1]
    part = spmd.active_partition()
    first = part.part * cols if part is not None and cols != n else 0
    if audio:                     # the soft-cap is elementwise: before or after
        block = layers.codebook_block(cols, cfg.n_codebooks, v)
        if block is None:         # whole logits (gathered where they were split)
            logits = layers.to_layout(logits, n, False)
            block = (0, cfg.n_codebooks, 0, v)
        _, c_l, first, cols = block
        logits = logits.reshape(*h.shape[:-1], c_l, cols)
    if v != cfg.vocab:
        pad = torch.arange(first, first + cols, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    return logits


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------
def _remat(fn, *args):
    """``fn(*args)`` under activation checkpointing (the reference's
    ``jax.checkpoint`` of ``cfg.remat``): only the inputs are kept, and
    autograd runs ``fn`` again, under the pack plan active now, before its
    backward — every matmul inside launches twice a step."""
    plan = plan_mod.active_plan()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (plan_mod.use_plan(plan),
                                          plan_mod.use_plan(plan)))


def _remat_block(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, window: int | None):
    """:func:`attn_block_full` under :func:`_remat`."""
    return _remat(attn_block_full, bp, x, cfg, positions, window)


def transformer_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                        want_cache: bool = False,
                        patch_embeds: torch.Tensor | None = None):
    """``(logits (B, S, V), aux, cache)``: ``aux`` is the MoE blocks'
    router aux losses summed over the layers (a float32 scalar; the float 0
    for the dense family), ``cache`` with ``want_cache`` the KV cache
    ``{"k", "v"}`` of shape (L, B, S, KV, hd), else None.  S counts a VLM's
    patches before its text (:func:`embed_inputs`); audio logits are (B, S,
    n_codebooks, V).  Under ``cfg.remat`` (full width) a forward that
    records gradients checkpoints every block."""
    x = embed_inputs(params, tokens, cfg, patch_embeds)
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
    """One decode step at scalar ``pos``: tokens (B, 1) → logits (B, 1, V)
    (audio: (B, 1, C) → (B, 1, C, V)); the cache is updated in place and
    returned."""
    x = embed_inputs(params, tokens, cfg)
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


def transformer_cache_spec(cfg: ModelConfig) -> Params:
    """Axis roles of :func:`transformer_init_cache`'s leaves: batch axis 1,
    sequence axis 2."""
    kv = cache_mod.CacheAxes(batch=1, seq=2)
    return {"k": kv, "v": kv}


def cache_heads(cfg: ModelConfig, seq_split: bool = False) -> Params:
    """The decode cache's tree (as :meth:`repro_torch.models.model.LM.
    cache_spec`) with a :class:`repro_torch.models.cache.HeadAxis` at each
    leaf that holds heads a rank may split, None elsewhere: the KV
    leaves' KV heads (axis 3; None under ``seq_split``, where a rank
    keeps its block of positions of every KV head); the hybrid's Mamba2
    state at its heads and its x conv state at their channels
    (``conv.b`` and ``conv.c`` hold none); the xLSTM's mLSTM ``c``, ``n``
    and ``m`` at its heads (its conv state holds the whole u, sLSTM's
    state every head: the partitioned program runs them whole)."""
    kv = None if seq_split else cache_mod.HeadAxis(3, cfg.n_kv_heads, kv=True)
    if cfg.family == "hybrid":
        m = mamba_spec(cfg)
        return {"ssm": cache_mod.HeadAxis(3, m.n_heads),
                "conv": {"x": cache_mod.HeadAxis(4, m.n_heads, m.headdim), "b": None,
                         "c": None}, "k": kv, "v": kv}
    if cfg.family == "ssm":
        heads = cache_mod.HeadAxis(3, cfg.n_heads)
        out: Params = {"mlstm": {"c": heads, "n": heads, "m": heads, "conv": None}}
        if cfg.slstm_every:
            out["slstm"] = (None,) * 4
        return out
    return {"k": kv, "v": kv}


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
    x = embed_inputs(params, tokens, cfg)
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
    x = embed_inputs(params, tokens, cfg)
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
    x = embed_inputs(params, tokens, cfg)
    for i, bp in enumerate(params["layers"]):
        x, _ = attn_block_verify(bp, x, _layer_pool(pool, i), block_tables,
                                 start, valid_len, cfg, cfg.window_for(i))
    return _head(params, _norm_rows(x, params["final_norm"], cfg.norm_eps), cfg), pool


# ---------------------------------------------------------------------------
# the hybrid (zamba2): Mamba2 groups + one shared attention block
# ---------------------------------------------------------------------------
def _groups_of(cfg: ModelConfig, period: int) -> int:
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole groups "
                         f"of {period}")
    return cfg.n_layers // period


def init_hybrid(gen: torch.Generator, cfg: ModelConfig,
                device: torch.device) -> Params:
    """``{"embed", "final_norm", ["head",] "mamba_blocks", "shared_attn"}``:
    ``mamba_blocks[g][j]`` is the ``{"norm", "mamba"}`` block j of group g
    (G = n_layers / hybrid_attn_every groups), ``shared_attn`` one attention
    + MLP block."""
    period = cfg.hybrid_attn_every
    n_groups = _groups_of(cfg, period)
    mspec, dt = mamba_spec(cfg), dtype_of(cfg)
    blocks = [[{"norm": layers.init_rms_norm(cfg.d_model, device),
                "mamba": ssm.init_mamba(gen, mspec, dt, device)}
               for _ in range(period)] for _ in range(n_groups)]
    return {**init_embed_head(gen, cfg, device), "mamba_blocks": blocks,
            "shared_attn": init_attn_block(gen, cfg, device)}


def _hybrid_group(gp: list, shared: Params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor):
    """One group: its Mamba2 blocks, then the shared block.  Returns (x,
    (k, v))."""
    mspec = mamba_spec(cfg)
    for bp in gp:
        x = x + ssm.mamba_forward(bp["mamba"], layers.rms_norm(x, bp["norm"],
                                                               cfg.norm_eps), mspec)
    x, kv, _ = attn_block_full(shared, x, cfg, positions, None)
    return x, kv


def hybrid_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   want_cache: bool = False,
                   patch_embeds: torch.Tensor | None = None):
    """``(logits, 0.0, cache)``: with ``want_cache`` the shared block's KV
    cache ``{"k", "v"}`` of shape (G, B, S, KV, hd), one for every
    application (the Mamba2 state is built by stepping, as the reference
    notes), else None.  ``patch_embeds`` is the attention family's
    argument; a hybrid has no frontend."""
    x = embed_inputs(params, tokens, cfg, patch_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = cfg.remat and not want_cache and torch.is_grad_enabled()
    ks, vs = [], []
    for gp in params["mamba_blocks"]:
        if remat:
            x, (k, v) = _remat(_hybrid_group, gp, params["shared_attn"], x, cfg,
                               positions)
        else:
            x, (k, v) = _hybrid_group(gp, params["shared_attn"], x, cfg, positions)
        if want_cache:
            ks.append(k)
            vs.append(v)
    logits = project_logits(params, x, cfg)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if want_cache else None
    return logits, 0.0, cache


def hybrid_decode(params: Params, cache: Params, tokens: torch.Tensor, pos,
                  cfg: ModelConfig):
    """One decode step, ``pos`` an int or (B,) int64: tokens (B, 1) →
    (logits (B, 1, V), cache); the cache is updated in place."""
    x = embed_inputs(params, tokens, cfg)
    mspec = mamba_spec(cfg)
    conv = cache["conv"]
    for g, gp in enumerate(params["mamba_blocks"]):
        for j, bp in enumerate(gp):
            state = {"ssm": cache["ssm"][g, j],
                     "conv": {n: t[g, j] for n, t in conv.items()}}
            mo, new = ssm.mamba_decode_step(
                bp["mamba"], layers.rms_norm(x, bp["norm"], cfg.norm_eps), state,
                mspec)
            x = x + mo
            state["ssm"].copy_(new["ssm"])
            for n, t in state["conv"].items():
                t.copy_(new["conv"][n])
        slot = {"k": cache["k"][g], "v": cache["v"][g]}     # views into the cache
        x, _ = attn_block_decode(params["shared_attn"], x, slot, pos, cfg, None)
    return project_logits(params, x, cfg), cache


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> Params:
    """Zeroed decode cache: ``ssm`` (G, P, B, H, d_state, headdim) float32,
    ``conv`` ``{"x", "b", "c"}`` (G, P, B, W - 1, C), and the shared
    block's ``k``/``v`` (G, B, max_len, KV, hd)."""
    period = cfg.hybrid_attn_every
    lead = (_groups_of(cfg, period), period)
    dt = dtype_of(cfg)
    one = ssm.init_mamba_cache(batch, mamba_spec(cfg), dt, device)
    kv = (lead[0], batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"ssm": one["ssm"].new_zeros(lead + tuple(one["ssm"].shape)),
            "conv": {n: t.new_zeros(lead + tuple(t.shape))
                     for n, t in one["conv"].items()},
            "k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device)}


def hybrid_cache_spec(cfg: ModelConfig) -> Params:
    """Axis roles of :func:`hybrid_init_cache`: the Mamba2 state stacked
    under (G, P) with no sequence axis, the shared block's KV under (G,)."""
    m_axes = cache_mod.shift_axes(ssm.mamba_cache_axes(), 2)
    kv = cache_mod.CacheAxes(batch=1, seq=2)
    return {"ssm": m_axes["ssm"], "conv": m_axes["conv"], "k": kv, "v": kv}


# ---------------------------------------------------------------------------
# the xLSTM: groups of (slstm_every - 1) mLSTM blocks + 1 sLSTM block
# ---------------------------------------------------------------------------
def _xlstm_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, mLSTM blocks a group)."""
    period = cfg.slstm_every or cfg.n_layers
    n_m = period - 1 if cfg.slstm_every else cfg.n_layers
    return _groups_of(cfg, period), n_m


def init_xlstm_lm(gen: torch.Generator, cfg: ModelConfig,
                  device: torch.device) -> Params:
    """``{"embed", "final_norm", ["head",] "mlstm_blocks", ["slstm_blocks"]}``:
    ``mlstm_blocks[g][j]`` and ``slstm_blocks[g]`` are ``{"norm", "cell"}``."""
    xs, dt = xlstm_spec(cfg), dtype_of(cfg)
    n_groups, n_m = _xlstm_layout(cfg)
    params = {**init_embed_head(gen, cfg, device), "mlstm_blocks": [
        [{"norm": layers.init_rms_norm(cfg.d_model, device),
          "cell": xlstm.init_mlstm(gen, xs, dt, device)} for _ in range(n_m)]
        for _ in range(n_groups)]}
    if cfg.slstm_every:
        params["slstm_blocks"] = [{"norm": layers.init_rms_norm(cfg.d_model, device),
                                   "cell": xlstm.init_slstm(gen, xs, dt, device)}
                                  for _ in range(n_groups)]
    return params


def _xlstm_group(mgp: list, sp: Params | None, x: torch.Tensor, cfg: ModelConfig):
    xs = xlstm_spec(cfg)
    for bp in mgp:
        x = x + xlstm.mlstm_block(bp["cell"], layers.rms_norm(x, bp["norm"],
                                                              cfg.norm_eps), xs)[0]
    if sp is not None:
        x = x + xlstm.slstm_scan(sp["cell"], layers.rms_norm(x, sp["norm"],
                                                             cfg.norm_eps), xs)[0]
    return x


def xlstm_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                  want_cache: bool = False,
                  patch_embeds: torch.Tensor | None = None):
    """``(logits, 0.0, None)``: the recurrent state is built by stepping
    the prompt, as the reference does (``patch_embeds`` as in
    :func:`hybrid_forward`)."""
    x = embed_inputs(params, tokens, cfg, patch_embeds)
    remat = cfg.remat and not want_cache and torch.is_grad_enabled()
    s_blocks = params.get("slstm_blocks")
    for g, mgp in enumerate(params["mlstm_blocks"]):
        sp = s_blocks[g] if s_blocks is not None else None
        x = _remat(_xlstm_group, mgp, sp, x, cfg) if remat else _xlstm_group(
            mgp, sp, x, cfg)
    return project_logits(params, x, cfg), 0.0, None


def xlstm_decode(params: Params, cache: Params, tokens: torch.Tensor, pos,
                 cfg: ModelConfig):
    """One decode step (``pos`` unused: the state is all there is): tokens
    (B, 1) → (logits (B, 1, V), cache); the cache is updated in place."""
    x = embed_inputs(params, tokens, cfg)
    xs = xlstm_spec(cfg)
    mc = cache["mlstm"]
    s_blocks = params.get("slstm_blocks")
    for g, mgp in enumerate(params["mlstm_blocks"]):
        for j, bp in enumerate(mgp):
            state = {n: t[g, j] for n, t in mc.items()}
            mo, new = xlstm.mlstm_block(
                bp["cell"], layers.rms_norm(x, bp["norm"], cfg.norm_eps), xs,
                cache=state, decode=True)
            x = x + mo
            for n, t in state.items():
                t.copy_(new[n])
        if s_blocks is not None:
            sp = s_blocks[g]
            state = tuple(t[g] for t in cache["slstm"])
            so, new = xlstm.slstm_scan(
                sp["cell"], layers.rms_norm(x, sp["norm"], cfg.norm_eps), xs,
                state=state)
            x = x + so
            for t, n in zip(state, new):
                t.copy_(n)
    return project_logits(params, x, cfg), cache


def xlstm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: torch.device) -> Params:
    """Zeroed decode cache: ``mlstm`` (the cell's state stacked (G, n_m,
    ...)) and, with sLSTM blocks, ``slstm`` (its (h, c, n, m) stacked (G,
    ...)); ``max_len`` is unused, the state being O(1) in it."""
    xs = xlstm_spec(cfg)
    n_groups, n_m = _xlstm_layout(cfg)
    one = xlstm.init_mlstm_cache(batch, xs, dtype_of(cfg), device)
    cache = {"mlstm": {n: t.expand((n_groups, n_m) + tuple(t.shape)).clone()
                       for n, t in one.items()}}
    if cfg.slstm_every:
        cache["slstm"] = tuple(t.expand((n_groups,) + tuple(t.shape)).clone()
                               for t in xlstm.init_slstm_cache(batch, xs, device))
    return cache


def xlstm_cache_spec(cfg: ModelConfig) -> Params:
    """Axis roles of :func:`xlstm_init_cache`: mLSTM state stacked under
    (G, n_m), sLSTM state under (G,); all O(1) in sequence length."""
    spec = {"mlstm": cache_mod.shift_axes(xlstm.mlstm_cache_axes(), 2)}
    if cfg.slstm_every:
        spec["slstm"] = cache_mod.shift_axes(xlstm.slstm_cache_axes(), 1)
    return spec
