"""GQA attention: chunked (flash-style) prefill, cached decode and the paged
variants of both, plain torch.

Twin of :mod:`repro.models.attention`: the same online-softmax arithmetic,
the same ``NEG_INF`` and the same masks, so the parity tests compare like
with like.  Decode takes a scalar position (the static serve path) or one
position per row (the continuous-batching engine); the paged functions read
and write a pool of fixed-size KV pages through per-row block tables.

A row's output does not depend on the rows beside it or on the cache's
length at the engine's shapes, which its equality with static serving
needs: masked positions give exact zeros, and on the card torch's
reductions and cuBLAS's einsums keep a row's bits between one row and four
at decode, between a prompt and its page bucket, and between a whole prompt
and its 16-row chunks at prefill (``scripts/serve_probe.py invariance``;
``tests/test_torch_cuda.py`` holds it).  That is a property of the
libraries at those shapes, not of the code.  With one query head a KV
head (multi-head attention, qwen2-moe-a2.7b's 16/16 heads) cuBLAS runs the
einsums at a shape whose rows did change bits (every decode row at batch 4
against batch 1), so the core then computes each query head twice
(:func:`_groups`), the shape of the two-a-group configs, which kept them,
and keeps the first copy.  The speculative verify path
(:func:`paged_verify_attention`) calls the decode core once a window
position, so its rows equal C sequential decode steps by construction.

In a partitioned step (:func:`repro_torch.runtime.spmd.use_partition`)
attention runs on the rank's query heads and the KV heads they read
(:func:`local_heads`): the KV heads' own block where they divide
``model``, else the KV head the rank's query heads share (the columns of
a whole dense ``wk`` / ``wv``; a packed one's whole output narrowed);
where the query heads do not divide ``model`` (or straddle groups) every
rank attends with every head.  The cache keeps the rank's KV heads.  A
decode step whose KV cache splits its sequence over ``model`` (the
reference's ``cache_specs``; :func:`repro_torch.runtime.spmd.seq_block`)
instead scores every head on the rank's block of positions and combines
the softmax across ranks (:func:`_attend_block`): only max and sum
statistics and the float32 partial outputs cross, never the cache.
There, while gradients are recorded, :func:`chunked_attention` keeps each
query chunk's inputs only and runs its forward again in the backward
(a rank that attends with every head would otherwise hold every chunk's
scores at once).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import sod
from repro_torch.models import layers
from repro_torch.runtime import spmd

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
                 positions: torch.Tensor, every_head: bool = False):
    """q, k, v after RoPE, (B, S, heads, hd).  In the partitioned program:
    the rank's query heads and the KV heads they read (:func:`local_heads`),
    as the cache keeps them; with ``every_head`` every head, put together
    over ``model``."""
    b, s, d = x.shape
    part = spmd.active_partition()
    if part is None:
        q = sod.apply(x, params["wq"]).reshape(b, s, spec.n_heads, spec.head_dim)
        k = sod.apply(x, params["wk"]).reshape(b, s, spec.n_kv_heads, spec.head_dim)
        v = sod.apply(x, params["wv"]).reshape(b, s, spec.n_kv_heads, spec.head_dim)
    else:
        hd, heads = spec.head_dim, None if every_head else local_heads(spec)
        q = layers.linear(x, params["wq"], d, spec.n_heads * hd)
        q = layers.to_layout(q, spec.n_heads * hd, heads is not None)
        k, v = (_local_kv(x, params[n], spec, heads, part) for n in ("wk", "wv"))
        q, k, v = (t.reshape(b, s, -1, hd) for t in (q, k, v))
    q = layers.apply_rope(q, positions, spec.rope_theta)
    k = layers.apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _local_kv(x: torch.Tensor, w, spec: AttnSpec, heads, part) -> torch.Tensor:
    """K or V (B, S, heads · hd) of the partitioned program: every KV head
    where the query heads do not split, else the rank's (``heads``, of
    :func:`local_heads`): the weight's own column block where the KV heads
    divide ``model``, else the columns of the KV head the rank's query
    heads share, read from a whole dense weight by
    :func:`~repro_torch.runtime.spmd.take_block` (two ranks' gradients of
    one head summed) or narrowed from a whole packed product's output."""
    d, n = x.shape[-1], spec.n_kv_heads * spec.head_dim
    if heads is None or spec.n_kv_heads % part.tp == 0:
        return layers.to_layout(layers.linear(x, w, d, n), n, heads is not None)
    first, size = heads[1] * spec.head_dim, heads[2] * spec.head_dim
    if isinstance(w, torch.Tensor):
        return layers.linear(x, spmd.take_block(w, part.mesh, "model", 1, first, size), d, n)
    return spmd.take_block(layers.linear(x, w, d, n), part.mesh, "model", -1, first, size)


def local_heads(spec: AttnSpec):
    """In the partitioned program: ``(n_heads, first KV head, n_kv_heads)``
    of the rank's share — ``H / tp`` query heads (block ``part``) and the
    KV heads they read — or None where the query heads do not split (``H``
    does not divide ``model``, or a rank's heads would straddle KV groups);
    outside it, None."""
    part = spmd.active_partition()
    if part is None or part.tp == 1 or spec.n_heads % part.tp:
        return None
    h_l, g = spec.n_heads // part.tp, spec.n_heads // spec.n_kv_heads
    if spec.n_kv_heads % part.tp == 0:
        kv_l = spec.n_kv_heads // part.tp
        return h_l, part.part * kv_l, kv_l
    if g % h_l == 0:             # the rank's heads share one KV head
        return h_l, part.part * h_l // g, 1
    return None


def local_spec(spec: AttnSpec) -> AttnSpec:
    """``spec`` with the rank's head counts (itself outside a partitioned
    step or where the heads do not split)."""
    heads = local_heads(spec)
    if heads is None:
        return spec
    return dataclasses.replace(spec, n_heads=heads[0], n_kv_heads=heads[2])


def _groups(q: torch.Tensor) -> torch.Tensor:
    """Query heads grouped (B, Cq, KV, G, hd), with a lone query head a
    group (G = 1) given twice: the einsums then run as for G = 2, where
    cuBLAS keeps a row's bits whatever the batch and the cache length
    (``scripts/serve_probe.py invariance``); callers keep the first copy
    of the output (``[:, :, :, :G]`` of (B, KV, G, ...) or the G axis).
    In a partitioned step, which no bitwise comparison reads, the lone head
    stays alone (it would double the attention's work and memory)."""
    if q.shape[3] == 1 and spmd.active_partition() is None:
        return q.expand(-1, -1, -1, 2, -1).contiguous()
    return q


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

    q (B, S, H, hd); k, v (B, S, KV, hd).  A causal query chunk reads the
    key chunks up to its own (a later one is wholly masked, and its online
    update would leave the running sums as they are, bit for bit).  In a
    partitioned step that records gradients each query chunk's work is
    checkpointed: only its inputs are kept, and its forward runs again
    before its backward.
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
    recompute = spmd.active_partition() is not None and torch.is_grad_enabled()
    outs = []
    for i in range(nq):
        n_blocks = n_rel if window is not None else min(nk, ((i + 1) * cq - 1) // ck + 1)
        args = (qc[:, i], k, v, spec, window, i, n_blocks)
        outs.append(checkpoint(_query_chunk, *args, use_reentrant=False) if recompute
                    else _query_chunk(*args))
    return torch.cat(outs, dim=1).to(q.dtype)


def _query_chunk(q_i: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec: AttnSpec,
                 window: int | None, i: int, n_blocks: int) -> torch.Tensor:
    """Query chunk ``i`` (B, Cq, KV, G, hd) of :func:`chunked_attention`
    over its ``n_blocks`` key chunks (a window's last ``n_blocks``):
    (B, Cq, H, hd) float32."""
    b, cq, kvh, g, hd = q_i.shape
    s = k.shape[1]
    ck = min(spec.chunk_k, s)
    dev = q_i.device
    qi = _groups(q_i)
    gp = qi.shape[3]
    q_pos = i * cq + torch.arange(cq, device=dev)
    carry = (
        torch.full((b, kvh, gp, cq), NEG_INF, dtype=torch.float32, device=dev),
        torch.zeros((b, kvh, gp, cq), dtype=torch.float32, device=dev),
        torch.zeros((b, kvh, gp, cq, hd), dtype=torch.float32, device=dev),
    )
    for c in range(n_blocks):
        if window is not None:
            raw = i * cq + cq - (n_blocks - c) * ck
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
    out = (acc / torch.clamp(l, min=1e-30)[..., None])[:, :, :g]   # (B,KV,G,Cq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, cq, kvh * g, hd)


def full_attention(params: Params, x: torch.Tensor, spec: AttnSpec,
                   positions: torch.Tensor, window: int | None = None) -> torch.Tensor:
    """Training / prefill self-attention over a full sequence: x (B, S, D)
    → (B, S, D), through ``wo``."""
    q, k, v = _project_qkv(params, x, spec, positions)
    out = chunked_attention(q, k, v, spec, window=window)
    b, s, d = x.shape
    return layers.linear(out.reshape(b, s, -1), params["wo"], spec.n_heads * spec.head_dim, d)


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------
def init_cache(batch: int, max_len: int, spec: AttnSpec, dtype: torch.dtype,
               device: torch.device) -> Params:
    """A zeroed dense KV cache of one layer, ``{"k", "v"}`` of shape
    (B, max_len, KV, hd)."""
    shape = (batch, max_len, spec.n_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_positions(pos, b: int, device: torch.device) -> torch.Tensor:
    """(B, 1) RoPE positions from a scalar or per-row ``pos``."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        return pos.reshape(b, 1)
    return torch.full((b, 1), int(pos), dtype=torch.int64, device=device)


def _attend_cached(q, k_cache, v_cache, pos, spec: AttnSpec,
                   window: int | None):
    """One-token attention over a position-ordered KV cache.

    q (B,1,H,hd); caches (B,L,KV,hd); ``pos`` an int or a (B,) tensor.  Keys
    beyond each row's ``pos`` (or outside its sliding window) are masked.
    """
    b = q.shape[0]
    s_max = k_cache.shape[1]
    kvh = spec.n_kv_heads
    g = spec.n_heads // kvh
    qh = _groups(q.reshape(b, 1, kvh, g, spec.head_dim))
    scores = _block_scores(qh, k_cache, spec)   # (B,KV,G,1,Smax)
    k_pos = torch.arange(s_max, device=q.device)
    if isinstance(pos, torch.Tensor):           # (B,): a mask per row
        mask = k_pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > pos[:, None] - window
        mask = mask[:, None, None, None, :]
    else:
        mask = k_pos <= pos
        if window is not None:
            mask &= k_pos > pos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p.to(v_cache.dtype).float(),
                       v_cache.float())[:, :, :, :g]
    return out.reshape(b, 1, spec.n_heads * spec.head_dim)


def decode_attention(params: Params, x: torch.Tensor, cache: Params, pos,
                     spec: AttnSpec, window: int | None = None):
    """One decode step: write the new K/V into ``cache`` (this layer's
    ``{"k", "v"}`` of shape (B, L, KV, hd), updated in place — the reference
    returns a new cache; in the partitioned program the rank's rows and its
    KV heads where they split) and attend to the prefix.  x (B, 1, D).

    ``pos`` is an int (every row at the same position — the static serve
    path) or a (B,) int64 tensor (ragged continuous batching: each row
    writes its new KV at its own position and gets its own causal / window
    mask).  Returns (output (B, 1, D), cache).

    Where the partitioned step splits the cache's sequence over ``model``
    (:func:`repro_torch.runtime.spmd.seq_block`), ``cache`` holds the
    rank's block of positions of every KV head: the new token's q, k and
    v are put together whole on every rank, the rank that holds ``pos``
    writes k and v, and every head attends on the block
    (:func:`_attend_block`)."""
    b, _, d = x.shape
    block = spmd.seq_block()
    if block is not None:
        q, k_new, v_new = _project_qkv(params, x, spec, _decode_positions(pos, b, x.device),
                                       every_head=True)
        _write_block(cache, k_new, v_new, pos, *block)
        out = _attend_block(q, cache["k"], cache["v"], pos, spec, window, block[0])
        return layers.linear(out.to(x.dtype), params["wo"], spec.n_heads * spec.head_dim,
                             d), cache
    q, k_new, v_new = _project_qkv(params, x, spec,
                                   _decode_positions(pos, b, x.device))
    if isinstance(pos, torch.Tensor):
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, pos] = k_new[:, 0]
        cache["v"][rows, pos] = v_new[:, 0]
    else:
        cache["k"][:, pos] = k_new[:, 0]
        cache["v"][:, pos] = v_new[:, 0]
    out = _attend_cached(q, cache["k"], cache["v"], pos, local_spec(spec), window)
    return layers.linear(out.to(x.dtype), params["wo"], spec.n_heads * spec.head_dim,
                         d), cache


def _write_block(cache: Params, k_new: torch.Tensor, v_new: torch.Tensor, pos,
                 first: int, size: int) -> None:
    """Write the new token's k and v (B, 1, KV, hd) into a rank's block of
    positions ``[first, first + size)``, in place: a row whose ``pos`` (an
    int or (B,)) lies outside the block keeps what the block held."""
    if not isinstance(pos, torch.Tensor):
        if first <= pos < first + size:
            cache["k"][:, pos - first] = k_new[:, 0]
            cache["v"][:, pos - first] = v_new[:, 0]
        return
    local = pos - first
    inside = ((local >= 0) & (local < size))[:, None, None]
    rows, at = torch.arange(pos.shape[0], device=pos.device), local.clamp(0, size - 1)
    for name, new in (("k", k_new), ("v", v_new)):
        t = cache[name]
        t[rows, at] = torch.where(inside, new[:, 0].to(t.dtype), t[rows, at])


def _attend_block(q, k_block, v_block, pos, spec: AttnSpec, window: int | None,
                  first: int) -> torch.Tensor:
    """:func:`_attend_cached` over a cache whose positions split over
    ``model``: q (B, 1, H, hd) every head; the blocks (B, size, KV, hd)
    hold positions ``first + arange(size)``, masked by those global
    positions.  In the reference's rounding order: the scores' max over
    ``model``; ``exp(s - m)`` summed over ``model``; ``p = exp(s - m) /
    l`` in the cache's dtype; the float32 partial ``p · v`` summed over
    ``model``.  A rank whose block is wholly masked adds exactly 0
    (``NEG_INF`` is finite).  Returns (B, 1, H · hd) float32, every head."""
    part = spmd.active_partition()
    b, size = q.shape[0], k_block.shape[1]
    kvh = spec.n_kv_heads
    scores = _block_scores(q.reshape(b, 1, kvh, spec.n_heads // kvh, spec.head_dim),
                           k_block, spec)                       # (B,KV,G,1,size)
    k_pos = first + torch.arange(size, device=q.device)
    at = pos[:, None] if isinstance(pos, torch.Tensor) else pos
    mask = k_pos <= at
    if window is not None:
        mask &= k_pos > at - window
    if isinstance(pos, torch.Tensor):
        mask = mask[:, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m = spmd.pmax(scores.amax(dim=-1, keepdim=True), part.mesh, "model")
    e = torch.exp(scores - m)
    p = e / spmd.all_reduce(e.sum(dim=-1, keepdim=True), part.mesh, "model")
    out = torch.einsum("bkgqc,bckh->bqkgh", p.to(v_block.dtype).float(), v_block.float())
    return spmd.all_reduce(out, part.mesh, "model").reshape(b, 1, spec.n_heads * spec.head_dim)


# ---------------------------------------------------------------------------
# paged KV pool (continuous-batching engine)
# ---------------------------------------------------------------------------
def init_paged_pool(n_pages: int, page_size: int, spec: AttnSpec,
                    dtype: torch.dtype, device: torch.device) -> Params:
    """One layer's pool of fixed-size KV pages, ``{"k", "v"}`` of shape
    (n_pages, page, KV, hd), shared by all running sequences.

    Page 0 is the trash page: inactive engine slots point their whole block
    table at it, so their (ignored) writes never touch a live sequence.  The
    allocator (:class:`repro_torch.serving.pool.PagePool`) never hands it
    out."""
    shape = (n_pages, page_size, spec.n_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _gather_pages(pool: Params, block_tables: torch.Tensor, spec: AttnSpec):
    """Each row's pages in position order: (B, max_pages · page, KV, hd)."""
    b = block_tables.shape[0]
    shape = (b, -1, spec.n_kv_heads, spec.head_dim)
    return pool["k"][block_tables].reshape(shape), pool["v"][block_tables].reshape(shape)


def paged_prefill_attention(params: Params, x: torch.Tensor, pool: Params,
                            block_tables: torch.Tensor, start: int, valid_len: int,
                            spec: AttnSpec, window: int | None = None):
    """Chunked-prefill attention: C prompt positions against the pool.

    x (B, C, D) covers positions ``[start, start + C)``; ``pool`` is this
    layer's ``{"k", "v"}`` (n_pages, page, KV, hd), updated in place;
    ``block_tables`` (B, max_pages) int64.  The chunk's KV is scattered into
    the pages its positions' block-table entries name (positions at or
    beyond ``valid_len`` — final-chunk padding — go to the trash page, so
    they never dirty a live page), then the table is gathered back
    position-ordered and each query row attends under its own causal /
    sliding-window mask in one :func:`_online_block` call: the arithmetic
    of :func:`chunked_attention` for a prompt within one attention chunk,
    where masked positions contribute exact zeros.  Returns (attention
    output (B, C, H·hd) before ``wo``, pool)."""
    b, c, _ = x.shape
    dev = x.device
    idx = start + torch.arange(c, device=dev)                 # (C,)
    q, k_new, v_new = _project_qkv(params, x, spec, idx.expand(b, c))
    page_size = pool["k"].shape[1]
    kvh, hd = spec.n_kv_heads, spec.head_dim
    g = spec.n_heads // kvh

    page = block_tables.gather(1, (idx // page_size).expand(b, c))
    page = torch.where((idx < valid_len)[None, :], page, 0)   # pad → trash
    off = (idx % page_size).expand(b, c)
    pool["k"][page.reshape(-1), off.reshape(-1)] = k_new.reshape(b * c, kvh, hd)
    pool["v"][page.reshape(-1), off.reshape(-1)] = v_new.reshape(b * c, kvh, hd)
    k_cache, v_cache = _gather_pages(pool, block_tables, spec)
    s_max = k_cache.shape[1]

    scores = _block_scores(_groups(q.reshape(b, c, kvh, g, hd)), k_cache, spec)
    gp = scores.shape[2]
    k_pos = torch.arange(s_max, device=dev)
    mask = k_pos[None, :] <= idx[:, None]
    if window is not None:
        mask &= k_pos[None, :] > idx[:, None] - window
    init = (
        torch.full((b, kvh, gp, c), NEG_INF, dtype=torch.float32, device=dev),
        torch.zeros((b, kvh, gp, c), dtype=torch.float32, device=dev),
        torch.zeros((b, kvh, gp, c, hd), dtype=torch.float32, device=dev),
    )
    _, l, acc = _online_block(init, scores, v_cache, mask[None, None, None])
    out = (acc / torch.clamp(l, min=1e-30)[..., None])[:, :, :g]   # (B,KV,G,C,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, c, spec.n_heads * hd)
    return out.to(x.dtype), pool


def paged_decode_attention(params: Params, x: torch.Tensor, pool: Params,
                           block_tables: torch.Tensor, pos: torch.Tensor,
                           spec: AttnSpec, window: int | None = None,
                           valid_len: torch.Tensor | None = None):
    """One decode step against the paged KV pool.

    Row ``b``'s logical position ``p`` lives in page ``block_tables[b, p //
    page]`` at offset ``p % page``; the new token's KV is written there (the
    pool, this layer's (n_pages, page, KV, hd), is updated in place), then
    the row's pages are gathered back into position order and attended with
    the per-row mask of the dense vector-``pos`` path — so paged and dense
    decode are bit-equal for equal cache contents.

    ``pos`` and the optional ``valid_len`` are (B,) int64.  A row whose
    ``pos`` is at or beyond its ``valid_len`` writes to the trash page: the
    engine runs one batched step over decoding and prefilling or idle slots
    (cutoff 0).  Reads are unaffected; the mask scopes each row to ``<= pos``.
    Returns (output (B, 1, D), pool)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, spec, pos.reshape(b, 1))
    page_size = pool["k"].shape[1]
    page = block_tables.gather(1, (pos // page_size)[:, None])[:, 0]
    if valid_len is not None:
        page = torch.where(pos < valid_len, page, 0)          # overflow → trash
    off = pos % page_size
    pool["k"][page, off] = k_new[:, 0]
    pool["v"][page, off] = v_new[:, 0]
    k_cache, v_cache = _gather_pages(pool, block_tables, spec)
    out = _attend_cached(q, k_cache, v_cache, pos, spec, window)
    return sod.apply(out.to(x.dtype), params["wo"]), pool


def paged_verify_attention(params: Params, x: torch.Tensor, pool: Params,
                           block_tables: torch.Tensor, start: torch.Tensor,
                           valid_len: torch.Tensor, spec: AttnSpec,
                           window: int | None = None):
    """Speculative-decoding verification: C window positions a row, each
    with exactly the decode step's attention.

    x (B, C, D); row ``b`` scores positions ``[start[b], start[b] + C)``
    against its pages (``start`` and ``valid_len`` are (B,) int64).  The
    window's KV is scattered as :func:`paged_prefill_attention` scatters a
    chunk (positions at or beyond ``valid_len[b]`` go to the trash page, so
    an over-long window never dirties a live page; the pool, this layer's
    (n_pages, page, KV, hd), is updated in place).  The projections run
    once over all B·C rows (the matmul kernels keep a row's bits whatever
    the row count); the attention core is :func:`_attend_cached` called
    once a window position, at the decode step's shape (B, 1) with that
    position's causal cutoff, so row i equals the i-th of C sequential
    :func:`paged_decode_attention` calls by construction — which the
    engine's accept rule needs.  The reference runs the core once with C
    query rows; on the card that form changed the bits of some rows
    (``scripts/serve_probe.py invariance``).  Returns (output (B, C, D),
    pool)."""
    b, c, _ = x.shape
    idx = start[:, None] + torch.arange(c, device=x.device)[None, :]  # (B, C)
    q, k_new, v_new = _project_qkv(params, x, spec, idx)
    page_size = pool["k"].shape[1]
    kvh, hd = spec.n_kv_heads, spec.head_dim
    page = block_tables.gather(1, idx // page_size)
    page = torch.where(idx < valid_len[:, None], page, 0)    # overflow → trash
    off = idx % page_size
    pool["k"][page.reshape(-1), off.reshape(-1)] = k_new.reshape(b * c, kvh, hd)
    pool["v"][page.reshape(-1), off.reshape(-1)] = v_new.reshape(b * c, kvh, hd)
    k_cache, v_cache = _gather_pages(pool, block_tables, spec)
    out = torch.cat([_attend_cached(q[:, i:i + 1].contiguous(), k_cache, v_cache,
                                    idx[:, i], spec, window) for i in range(c)], 1)
    return sod.apply(out.to(x.dtype), params["wo"]), pool
