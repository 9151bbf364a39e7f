"""Attention-family decoder: full-sequence forward and cached decode.

Twin of the ``TransformerLM`` functions of :mod:`repro.models.transformer`
for the dense family with tied embeddings (llama).  Layers are a Python loop
over per-layer parameter dicts — the reference's ``scan_layers=False``
lowering — so every packed projection is one unstacked operand and runs the
fused kernel.  MoE, the hybrid and xLSTM assemblies, the paged paths and the
untied / soft-capped heads are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
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
def attn_block_full(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, window: int | None):
    """Full-sequence block.  Returns (x, (k, v))."""
    spec = attn_spec(cfg)
    h = layers.rms_norm(x, bp["norm1"], cfg.norm_eps)
    q, k, v = attn._project_qkv(bp["attn"], h, spec, positions)
    s = x.shape[1]
    eff_window = None if (window is None or window >= s) else window
    ao = attn.chunked_attention(q, k, v, spec, window=eff_window)
    x = x + sod.apply(ao.reshape(*x.shape[:2], -1), bp["attn"]["wo"])
    h2 = layers.rms_norm(x, bp["norm2"], cfg.norm_eps)
    return x + layers.mlp(bp["mlp"], h2, cfg.act), (k, v)


def attn_block_decode(bp: Params, x: torch.Tensor, cache: Params, pos: int,
                      cfg: ModelConfig, window: int | None):
    """One decode block over this layer's ``{"k", "v"}`` cache slice."""
    h = layers.rms_norm(x, bp["norm1"], cfg.norm_eps)
    ao, cache = attn.decode_attention(bp["attn"], h, cache, pos, attn_spec(cfg),
                                      window=window)
    x = x + ao
    h2 = layers.rms_norm(x, bp["norm2"], cfg.norm_eps)
    return x + layers.mlp(bp["mlp"], h2, cfg.act), cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def project_logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tied LM head: float32 logits over the padded vocabulary, padded ids
    masked to -1e30.

    As the reference's dot with ``preferred_element_type=float32``: operands
    in x's dtype, products summed in float32, and the f32 sums are the
    logits, never rounded to bfloat16 on the way (:func:`ops.dense_matmul`).
    """
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = ops.dense_matmul(x, params["embed"].to(x.dtype).T, torch.float32)
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
