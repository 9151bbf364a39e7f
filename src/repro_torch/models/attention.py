"""GQA attention: chunked (flash-style) prefill + cached decode, plain torch.

Twin of :mod:`repro.models.attention` for the static serving path: the same
online-softmax arithmetic, the same ``NEG_INF`` and the same masks, so the
parity tests compare like with like.  The paged variants (continuous
batching) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import sod
from repro_torch.models import layers

Params = dict[str, Any]

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Shape/behaviour spec for one attention layer: head geometry, RoPE
    base, logit scaling/soft-capping, and the flash-chunk sizes."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    scale: float | None = None      # default 1/sqrt(head_dim)
    softcap: float | None = None
    chunk_q: int = 512
    chunk_k: int = 512

    @property
    def q_scale(self) -> float:
        """Query scaling applied to logits (``scale`` or 1/sqrt(hd))."""
        return self.scale if self.scale is not None else self.head_dim**-0.5


def init_attention(gen: torch.Generator, d_model: int, spec: AttnSpec,
                   dtype: torch.dtype, device: torch.device) -> Params:
    """Initialize the q/k/v/o projection weights for one attention layer."""
    hq, hkv = spec.n_heads * spec.head_dim, spec.n_kv_heads * spec.head_dim
    return {
        "wq": layers.dense_init(gen, d_model, hq, dtype, device),
        "wk": layers.dense_init(gen, d_model, hkv, dtype, device),
        "wv": layers.dense_init(gen, d_model, hkv, dtype, device),
        "wo": layers.dense_init(gen, hq, d_model, dtype, device),
    }


def _project_qkv(params: Params, x: torch.Tensor, spec: AttnSpec,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    q = sod.apply(x, params["wq"]).reshape(b, s, spec.n_heads, spec.head_dim)
    k = sod.apply(x, params["wk"]).reshape(b, s, spec.n_kv_heads, spec.head_dim)
    v = sod.apply(x, params["wv"]).reshape(b, s, spec.n_kv_heads, spec.head_dim)
    q = layers.apply_rope(q, positions, spec.rope_theta)
    k = layers.apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _block_scores(q: torch.Tensor, k: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """q (B,Cq,KV,G,hd) × k (B,Ck,KV,hd) → (B,KV,G,Cq,Ck) float32."""
    s = torch.einsum("bqkgh,bckh->bkgqc", q.float(), k.float())
    s = s * spec.q_scale
    if spec.softcap is not None:
        s = spec.softcap * torch.tanh(s / spec.softcap)
    return s


def _online_block(carry, scores, v_blk, mask):
    """One online-softmax update.  scores (B,KV,G,Cq,Ck) f32."""
    m_prev, l_prev, acc_prev = carry
    scores = torch.where(mask, scores, NEG_INF)
    m_blk = scores.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_blk)
    # guard fully-masked rows
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(mask, p, 0.0)
    corr = torch.exp(torch.where(torch.isfinite(m_prev), m_prev - safe_m, NEG_INF))
    l_new = l_prev * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(v_blk.dtype).float(), v_blk.float())
    acc_new = acc_prev * corr[..., None] + pv
    return m_new, l_new, acc_new


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      spec: AttnSpec, window: int | None = None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, O(S) memory.

    q (B, S, H, hd); k, v (B, S, KV, hd).
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    cq = min(spec.chunk_q, s)
    ck = min(spec.chunk_k, s)
    if s % cq or s % ck:
        raise ValueError(f"seq {s} not divisible by chunks ({cq},{ck})")
    nq, nk = s // cq, s // ck
    qc = q.reshape(b, nq, cq, kvh, g, hd)
    n_rel = (window + cq) // ck + 1 if window is not None else None
    dev = q.device
    outs = []
    for i in range(nq):
        qi = qc[:, i]
        q_pos = i * cq + torch.arange(cq, device=dev)
        carry = (
            torch.full((b, kvh, g, cq), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((b, kvh, g, cq), dtype=torch.float32, device=dev),
            torch.zeros((b, kvh, g, cq, hd), dtype=torch.float32, device=dev),
        )
        for c in range(n_rel if window is not None else nk):
            if window is not None:
                raw = i * cq + cq - (n_rel - c) * ck
                start = min(max(raw, 0), s - ck)
            else:
                raw = start = c * ck
            k_blk = k[:, start:start + ck]
            v_blk = v[:, start:start + ck]
            k_pos = start + torch.arange(ck, device=dev)
            mask = k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask &= k_pos[None, :] > q_pos[:, None] - window
                # clipping can re-slice keys a neighbouring step also covers;
                # only this step's raw range [raw, raw+ck) may contribute
                in_range = (k_pos >= raw) & (k_pos < raw + ck)
                mask &= in_range[None, :]
            carry = _online_block(carry, _block_scores(qi, k_blk, spec), v_blk,
                                  mask[None, None, None])
        _, l, acc = carry
        out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,KV,G,Cq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, cq, h, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------
def _attend_cached(q, k_cache, v_cache, pos: int, spec: AttnSpec,
                   window: int | None):
    """One-token attention over a position-ordered KV cache.

    q (B,1,H,hd); caches (B,L,KV,hd); keys beyond ``pos`` (or outside the
    sliding window) are masked.
    """
    b = q.shape[0]
    s_max = k_cache.shape[1]
    kvh = spec.n_kv_heads
    g = spec.n_heads // kvh
    qh = q.reshape(b, 1, kvh, g, spec.head_dim)
    scores = _block_scores(qh, k_cache, spec)   # (B,KV,G,1,Smax)
    k_pos = torch.arange(s_max, device=q.device)
    mask = k_pos <= pos
    if window is not None:
        mask &= k_pos > pos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, spec.n_heads * spec.head_dim)


def decode_attention(params: Params, x: torch.Tensor, cache: Params, pos: int,
                     spec: AttnSpec, window: int | None = None):
    """One decode step at scalar position ``pos``: write the new K/V into
    ``cache`` (this layer's ``{"k", "v"}`` of shape (B, L, KV, hd), updated
    in place — the reference returns a new cache) and attend to the prefix.
    x (B, 1, D).  Returns (output (B, 1, D), cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, spec, positions)
    cache["k"][:, pos] = k_new[:, 0]
    cache["v"][:, pos] = v_new[:, 0]
    out = _attend_cached(q, cache["k"], cache["v"], pos, spec, window)
    return sod.apply(out.to(x.dtype), params["wo"]), cache
