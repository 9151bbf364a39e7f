"""Shared building blocks: norms, RoPE, embeddings, MLPs — all SoD-aware.

Twin of :mod:`repro.models.layers`, its loss included.  Every weight
matmul goes through :func:`repro_torch.core.sod.apply`, so a packed leaf
runs the Sparse-on-Dense kernel and a dense leaf bypasses decompression.

Inside a partitioned step (:func:`repro_torch.runtime.spmd.use_partition`)
the same functions run on the rank's rows and its share of the feature
dims, as GSPMD partitions the reference's jitted step: :func:`linear`
takes a weight as it lies (a column block, a K block, or whole) and its
input in the layout that weight reads; :func:`embed` looks up the rank's
vocabulary block and sums over ``model``; :func:`lm_head` leaves the
logits vocab-split; :func:`cross_entropy` reduces max and sum-exp over
``model`` and the mean over the data axes; :func:`split_rms_norm` sums a
norm's statistics over ``model`` where its width is split.  A feature
dim is split in blocks of ``dim / tp``, rank ``part`` holding block
``part``; a tensor's layout is read from its width against the global dim
the caller names.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import sod
from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.kernels import ops
from repro_torch.runtime import spmd

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# initializers (explicit generator and device; values differ from jax.random)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, 1/d_in) weight of shape (d_in, d_out)."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / d_in) ** 0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, 0.02²) embedding table of shape (vocab, d)."""
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def init_rms_norm(d: int, device: torch.device) -> torch.Tensor:
    """RMSNorm gain, stored as ``g`` in ``1 + g`` (zeros, float32)."""
    return torch.zeros((d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# norms, RoPE, activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with the ``1 + gamma`` gain, cast back to x's dtype.

    On the card the mean of the float32 squares is summed in float64 and
    rounded once to float32: a float64 sum of 2048 float32 squares is
    exact, or nearly, in any order, so a row's mean does not depend on how
    torch splits the reduction, which on the card it does by the number of
    rows (summed in float32, 96 of 1024 means of 2048-wide rows differed
    between 4 rows and 1, and now and then a normed row's bits with them;
    H100, torch 2.11, ``scripts/serve_probe.py invariance``).  On the CPU
    the float32 mean, as the reference's."""
    xf = x.float()
    if xf.is_cuda:
        var = torch.mean(xf * xf, dim=-1, keepdim=True, dtype=torch.float64).float()
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + gamma.float())).to(x.dtype)


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """(..., 1): the sum of the float32 squares of each row of ``x`` (of
    one block of its feature dim), in float64 on the card (as
    :func:`rms_norm`'s mean: to be rounded once, after the blocks' sums
    are added), in float32 on the CPU."""
    xf = x.float()
    if xf.is_cuda:
        return torch.sum(xf * xf, dim=-1, keepdim=True, dtype=torch.float64)
    return torch.sum(xf * xf, dim=-1, keepdim=True)


def rms_from_sum(x: torch.Tensor, gamma: torch.Tensor, total: torch.Tensor, width: int,
                 eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` of a block ``x`` of a feature dim ``width`` wide,
    ``total`` (:func:`sum_squares`) summed over every block of the row and
    ``gamma`` the block's gains: the mean rounded once to float32."""
    var = (total / width).float()
    xf = x.float() * torch.rsqrt(var + eps)
    return (xf * (1.0 + gamma.float())).to(x.dtype)


def split_rms_norm(x: torch.Tensor, gamma: torch.Tensor, width: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` over a feature dim of global ``width`` that ``x``
    may hold as the rank's ``model`` block (in the partitioned program:
    Mamba2's and mLSTM's gated norms, whose width spans every rank's
    heads).  A block's row sums its squares (:func:`sum_squares`), the
    sums are added over ``model`` (float64 on the card, so each row's mean
    is rounded once, whatever the batch), and the rank's block of the
    whole gain ``gamma`` scales it.  Whole rows: :func:`rms_norm`."""
    part = spmd.active_partition()
    if part is None or x.shape[-1] == width:
        return rms_norm(x, gamma, eps)
    gamma = to_layout(gamma, width, True, dim=0)
    # the mean feeds only the rank's block: its cotangent is summed back
    total = spmd.grad_sum(spmd.psum(sum_squares(x), part.mesh, "model"), part.mesh, "model")
    return rms_from_sum(x, gamma, total, width, eps)


def einsum_f32(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with float32 out and sums at least as wide, as the
    reference's ``einsum(..., preferred_element_type=float32)``.  On the
    card the operands are widened to float64 and the sums rounded once to
    float32: cuBLAS picks its kernel, and with it the order of a sum, by
    the batch, so a float32 sum of a row could change with the number of
    rows beside it (as RMSNorm's mean did); a float64 sum of float32
    products rounds to the same float32 in any order, or nearly.  On the
    CPU the float32 sums of the reference."""
    if operands[0].is_cuda:
        return torch.einsum(eq, *(o.double() for o in operands)).float()
    return torch.einsum(eq, *(o.float() for o in operands))


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """RoPE inverse frequencies, (head_dim/2,) float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate split halves.  x: (..., S, H, hd); positions: broadcastable to
    (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    angles = angles[..., None, :]                          # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The MLP's activation by name."""
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {kind!r}")


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(x / cap)`` in float32, cast
    back to x's dtype; the identity when ``cap`` is None."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP, embedding
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, device: torch.device) -> Params:
    """SwiGLU projection weights."""
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def mlp(params: Params, x: torch.Tensor, act: str = "silu",
        plans: dict | None = None, d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU MLP through three SoD matmuls.  ``plans`` maps ``w_gate`` /
    ``w_up`` / ``w_down`` to their :class:`repro_torch.core.plan.PackPlan`
    (absent entries fall back to the active plan's layout lookup).  In the
    partitioned program ``d_ff`` (the global width) places gate and up in
    the layout ``w_down`` reads: its K block when its rows are split."""
    pl = (plans or {}).get
    if spmd.active_partition() is None:
        gate = sod.apply(x, params["w_gate"], plan=pl("w_gate"))
        up = sod.apply(x, params["w_up"], plan=pl("w_up"))
        return sod.apply(activate(gate, act) * up, params["w_down"], plan=pl("w_down"))
    d = x.shape[-1]
    d_ff = d_ff or int(params["w_gate"].global_shape[1])
    gate = linear(x, params["w_gate"], d, d_ff, plan=pl("w_gate"))
    up = linear(x, params["w_up"], d, d_ff, plan=pl("w_up"))
    k_block = weight_blocks(params["w_down"], d_ff, d)[0]
    gate, up = (to_layout(t, d_ff, k_block) for t in (gate, up))
    return linear(activate(gate, act) * up, params["w_down"], d_ff, d, plan=pl("w_down"))


# ---------------------------------------------------------------------------
# the partitioned program's layouts
# ---------------------------------------------------------------------------
def _packed(w) -> bool:
    return isinstance(w, (TiledCSC, BlockCSR))


def weight_blocks(w, k: int, n: int) -> tuple[bool, bool]:
    """Whether the partitioned program reads ``w`` (global (k, n)) as its
    ``model`` block along K and along N: a packed leaf's resident block
    where it splits exactly (:func:`repro_torch.runtime.spmd.local_split`),
    a dense leaf's where its shape is less than the global one."""
    part = spmd.active_partition()
    if part is None or part.tp == 1:
        return False, False
    if _packed(w):
        return spmd.local_split(w)
    return w.shape[0] != k, w.shape[1] != n


def to_layout(t: torch.Tensor, n: int, block: bool, dim: int = -1) -> torch.Tensor:
    """``t`` (dim ``dim`` of global width ``n``, whole or the rank's
    ``model`` block) as the rank's block (``block``) or whole: a block of
    a replicated whole by :func:`repro_torch.runtime.spmd.take_block`, the
    whole from the blocks by :func:`~repro_torch.runtime.spmd.gather_rows`
    (each the other's transpose)."""
    part = spmd.active_partition()
    if part is None or part.tp == 1 or (t.shape[dim] != n) == block:
        return t
    if block:
        size = n // part.tp
        return spmd.take_block(t, part.mesh, "model", dim % t.ndim, part.part * size, size)
    return spmd.gather_rows(t, part.mesh, "model", dim % t.ndim)


def linear(x: torch.Tensor, w, k: int, n: int, *, plan=None,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` for a weight of global shape (k, n) through
    :func:`repro_torch.core.sod.apply`.  In the partitioned program ``x``
    goes in the layout ``w`` reads (:func:`weight_blocks`) and ``y`` comes
    out as ``w`` gives it: a column block for a column-split ``w``, whole
    otherwise.  A packed ``w`` takes the local contract; a dense one is a
    column-parallel product (``x`` through
    :func:`~repro_torch.runtime.spmd.grad_sum`), a row-parallel one (the
    float32 partials summed by :func:`~repro_torch.runtime.spmd.psum`),
    or whole."""
    part = spmd.active_partition()
    if part is None:
        return sod.apply(x, w, plan=plan, out_dtype=out_dtype)
    k_block, n_block = weight_blocks(w, k, n)
    x = to_layout(x, k, k_block)
    if _packed(w) or not (k_block or n_block):
        return sod.apply(x, w, plan=plan, out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    if n_block:
        return ops.dense_matmul(spmd.grad_sum(x, part.mesh, "model"), w, out_dtype)
    y = ops.dense_matmul(x, w, torch.float32)
    return spmd.psum(y, part.mesh, "model").to(out_dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor, scale: bool = False,
          vocab: int | None = None) -> torch.Tensor:
    """Row lookup; gemma-style sqrt(d) scale when ``scale``.  In the
    partitioned program a table of fewer rows than ``vocab`` (the padded
    vocabulary) is the rank's vocabulary block: ids outside it look up
    zeros, and the rows are summed over ``model``."""
    part = spmd.active_partition()
    if part is not None and vocab is not None and table.shape[0] != vocab:
        rows = table.shape[0]
        local = tokens - part.part * rows
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
        x = spmd.psum(x, part.mesh, "model")
    else:
        x = table[tokens]
    if scale:
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype, device=x.device)
    return x


def codebook_rows(tables: torch.Tensor, tokens: torch.Tensor, first: int) -> torch.Tensor:
    """(C, ..., d): each codebook stream's ids ``tokens`` (..., C) looked up
    in its table's block of rows [first, first + rows) (``tables`` (C,
    rows, d)), zeros for ids outside it."""
    rows = tables.shape[1]
    local = tokens - first
    inside = ((local >= 0) & (local < rows)).to(tables.dtype)
    local = local.clamp(0, rows - 1)
    return torch.stack([tables[i][local[..., i]] * inside[..., i, None]
                        for i in range(tables.shape[0])])


def embed_codebooks(tables: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The audio model's input: ``tokens`` (..., C) through one table a
    codebook stream (``tables`` (C, vocab, d)), the C embeddings added from
    0 in codebook order, as the reference's ``sum``.  In the partitioned
    program each table holds the rank's vocabulary block (fewer rows than
    ``vocab``): the C lookups of :func:`codebook_rows` are summed over
    ``model`` in one collective before the codebooks are added."""
    part = spmd.active_partition()
    c = tables.shape[0]
    if part is not None and tables.shape[1] != vocab:
        xs = spmd.psum(codebook_rows(tables, tokens, part.part * tables.shape[1]),
                       part.mesh, "model")
    else:
        xs = [tables[i][tokens[..., i]] for i in range(c)]
    return sum(xs[i] for i in range(c))


def codebook_block(cols: int, n_codebooks: int, vocab: int, index: int | None = None):
    """Where an audio head's (…, n_codebooks · vocab) logits are split over
    ``model`` in blocks of ``cols`` (the codebook the slower index):
    ``(first codebook, codebooks, first id, ids)`` of block ``index`` (the
    partitioned program's ``model`` position by default), which is whole
    codebooks where ``cols`` is a multiple of ``vocab`` and part of one
    where it divides it; None where it is neither or the logits are whole
    (or outside a partitioned step, unless ``index`` is given)."""
    if index is None:
        part = spmd.active_partition()
        if part is None:
            return None
        index = part.part
    if cols == n_codebooks * vocab:
        return None
    start = index * cols
    if cols % vocab == 0:
        return start // vocab, cols // vocab, 0, vocab
    if vocab % cols == 0:
        return start // vocab, 1, start % vocab, cols
    return None


def lm_head(x: torch.Tensor, table_or_w, tied: bool, cap: float | None = None,
            plan=None, vocab: int | None = None) -> torch.Tensor:
    """Vocabulary logits in float32, soft-capped by ``cap``.

    Tied: ``x`` against the (vocab, d) embedding table transposed, operands
    in x's dtype and products summed in float32 (the reference's dot with
    ``preferred_element_type=float32``).  Untied: ``x`` through the (d,
    vocab) head weight by :func:`repro_torch.core.sod.apply` with float32
    out, so a packed head runs the Sparse-on-Dense kernel; ``plan`` is its
    :class:`repro_torch.core.plan.PackPlan` (None: the active plan's layout
    lookup).  In the partitioned program (``vocab`` the padded vocabulary)
    the logits are the rank's vocabulary block where the table or head is
    split, whole otherwise."""
    part = spmd.active_partition()
    if not tied:
        logits = linear(x, table_or_w, x.shape[-1], vocab, plan=plan, out_dtype=torch.float32)
    else:
        if part is not None and vocab is not None and table_or_w.shape[0] != vocab:
            x = spmd.grad_sum(x, part.mesh, "model")    # each rank takes its block
        logits = ops.dense_matmul(x, table_or_w.to(x.dtype).T, torch.float32)
    return softcap(logits.float(), cap)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None, vocab: int | None = None,
                  codebooks: int | None = None) -> torch.Tensor:
    """Mean token cross-entropy: logits (..., V) float32, targets (...) int;
    with ``mask``, the mean over the masked-in tokens (at least one).

    In the partitioned program: logits narrower than ``vocab`` are the
    rank's vocabulary block, so the max and the sum of exponentials are
    reduced over ``model`` and the target's logit comes from the rank
    that holds it (float32 throughout); the mean over a batch whose rows
    are split is the sum over the data axes divided by the global count
    of (masked-in) tokens.  An audio model's logits (..., C, V) with
    ``codebooks`` = C may be the rank's block of :func:`codebook_block`
    (..., C_l, V_l): each codebook's max, sum of exponentials and target
    logit then come from the ranks that hold its columns (every other
    rank adds the identity) through one reduction over ``model`` of (...,
    C) statistics."""
    part = spmd.active_partition()
    if part is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        nll = logz - gold
        if mask is None:
            return nll.mean()
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    logits = logits.float()
    if codebooks and tuple(logits.shape[-2:]) != (codebooks, vocab):
        logz, gold = _codebook_stats(logits, targets, part, codebooks, vocab)
    elif vocab is not None and logits.shape[-1] != vocab:
        mesh, cols = part.mesh, logits.shape[-1]
        top = spmd.pmax(logits.amax(dim=-1), mesh, "model")
        sumexp = spmd.psum(torch.exp(logits - top[..., None]).sum(dim=-1), mesh, "model")
        logz = top + torch.log(sumexp)
        local = targets.long() - part.part * cols
        inside = (local >= 0) & (local < cols)
        gold = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])[..., 0]
        gold = spmd.psum(gold * inside, mesh, "model")
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        total = nll.sum()
        count = torch.tensor(float(nll.numel()), device=nll.device)
    else:
        mask = mask.float()
        total, count = (nll * mask).sum(), mask.sum()
    if part.rows:
        total = spmd.psum(total, part.mesh, part.rows)
        count = spmd.psum(count, part.mesh, part.rows)
    return total / count.clamp(min=1.0)


def codebook_max(logits: torch.Tensor, block: tuple, codebooks: int) -> torch.Tensor:
    """(..., C): each codebook's largest logit in the rank's block (..., C_l,
    V_l) of :func:`codebook_block` ``block``, -inf where it holds none of
    the codebook's columns."""
    c0, c_l = block[:2]
    return F.pad(logits.amax(dim=-1), (c0, codebooks - c0 - c_l), value=float("-inf"))


def codebook_sums(logits: torch.Tensor, targets: torch.Tensor, block: tuple, codebooks: int,
                  top: torch.Tensor) -> torch.Tensor:
    """(2, ..., C): the rank's share of each codebook's sum of
    ``exp(logit - top)`` and of its target's logit (targets (..., C)),
    from its block (..., C_l, V_l) of :func:`codebook_block` ``block``; 0
    where it holds none of the codebook's columns."""
    c0, c_l, v0, v_l = block
    sumexp = torch.exp(logits - top[..., c0:c0 + c_l, None]).sum(dim=-1)
    local = targets[..., c0:c0 + c_l].long() - v0
    inside = (local >= 0) & (local < v_l)
    gold = torch.gather(logits, -1, local.clamp(0, v_l - 1)[..., None])[..., 0] * inside
    return F.pad(torch.stack([sumexp, gold]), (c0, codebooks - c0 - c_l))


def _codebook_stats(logits: torch.Tensor, targets: torch.Tensor, part, codebooks: int,
                    vocab: int):
    """``(logz, gold)`` (..., C) of an audio head's logits block (..., C_l,
    V_l) against the targets (..., C), in float32: each codebook's max, then
    its sum of exponentials and target logit, reduced over ``model`` from
    the ranks that hold its columns (:func:`codebook_max`,
    :func:`codebook_sums`: the others add the identity)."""
    block = codebook_block(logits.shape[-2] * logits.shape[-1], codebooks, vocab)
    top = spmd.pmax(codebook_max(logits, block, codebooks), part.mesh, "model")
    sumexp, gold = spmd.psum(codebook_sums(logits, targets, block, codebooks, top),
                             part.mesh, "model")
    return top + torch.log(sumexp), gold
