"""xLSTM blocks: mLSTM (matrix memory, chunked parallel form) and sLSTM.

Twin of :mod:`repro.models.xlstm`.  mLSTM is a gated linear-attention cell
with a matrix state C (dk × dv a head), an exponential input gate and a
sigmoid forget gate, stabilised in log space.  The full-sequence forward
uses the chunkwise form (an intra-chunk masked product and an inter-chunk
state loop, the shape of mamba2's SSD); decode is the same function at
chunk 1 carrying the state.  sLSTM has scalar memory with a
head-block-diagonal recurrence and no parallel form, so it loops over time.

The projections ``w_up``, ``wq``, ``wk``, ``wv`` and ``w_down`` go through
:func:`repro_torch.core.sod.apply` (packed under Sparse-on-Dense); mLSTM's
gate weight ``w_if`` and sLSTM's ``w_gates`` and ``w_out`` stay dense, as in
the reference.  sLSTM's recurrent product goes through
:func:`repro_torch.models.layers.einsum_f32`, float64 on the card: in
float32 cuBLAS changed every row's bits between the engine's batch of 4
and static serving's 1 (fault C8 in ``ROADMAP.md``;
``scripts/serve_probe.py invariance``).

In a partitioned step (:func:`repro_torch.runtime.spmd.use_partition`)
the blocks run on the rank's rows; mLSTM runs on its heads where they
divide ``model`` (:func:`mlstm_block`), sLSTM on every head (``r_gates``
whole, ``w_gates``' column block's product gathered whole) with
``w_out`` row-parallel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.cache import CacheAxes
from repro_torch.models.ssm import _causal_conv, softplus
from repro_torch.runtime import spmd

Params = dict[str, Any]

NEG_INIT = -1e30     # the stabilisers' initial value, float32


@dataclasses.dataclass(frozen=True)
class XLSTMSpec:
    """Shapes of the xLSTM blocks.  ``head_dim`` is the mLSTM's, d_inner /
    n_heads; sLSTM's heads are d_model / n_heads wide."""

    d_model: int
    n_heads: int = 4
    proj_factor: float = 2.0
    conv_width: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(gen: torch.Generator, spec: XLSTMSpec, dtype: torch.dtype,
               device: torch.device) -> Params:
    """The mLSTM cell's weights: the up projection (u and the output gate),
    the causal conv, q/k/v, the float32 gate weight ``w_if`` and bias
    ``b_if`` (input gates 0, forget gates 3), the norm and ``w_down``."""
    d, di, h = spec.d_model, spec.d_inner, spec.n_heads
    p: Params = {"w_up": layers.dense_init(gen, d, 2 * di, dtype, device)}
    conv = torch.randn((spec.conv_width, di), generator=gen, dtype=torch.float32,
                       device=device)
    p["conv_w"] = (conv * 0.1).to(dtype)
    p["conv_b"] = torch.zeros((di,), dtype=dtype, device=device)
    for name in ("wq", "wk", "wv"):
        p[name] = layers.dense_init(gen, di, di, dtype, device)
    p["w_if"] = layers.dense_init(gen, di, 2 * h, torch.float32, device)
    p["b_if"] = torch.cat([torch.zeros((h,), device=device),
                           torch.full((h,), 3.0, device=device)])
    p["norm"] = layers.init_rms_norm(di, device)
    p["w_down"] = layers.dense_init(gen, di, d, dtype, device)
    return p


def _mlstm_gates(u: torch.Tensor, params: Params, h: int):
    """(log input gate, log forget gate ≤ 0), float32 (B, S, H) each."""
    gf = ops.dense_matmul(u, params["w_if"].to(u.dtype), torch.float32) + params["b_if"]
    return gf[..., :h], log_sigmoid(gf[..., h:])


def mlstm_chunked(q, k, v, li, lf, chunk: int, state=None):
    """Chunkwise stabilised mLSTM.  q, k, v (B, S, H, dk/dv); li, lf
    (B, S, H) float32; ``state`` ``(C, n, m)`` or None (zeros, stabiliser
    -1e30).  Returns y (B, S, H, dv) float32 and the final state.  S must
    be a multiple of the chunk (or shorter than one)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    lc = min(chunk, s)
    if s % lc:
        raise ValueError(f"seq {s} not divisible by chunk {lc}")
    nc = s // lc
    q = q.reshape(b, nc, lc, h, dk) * (dk ** -0.5)
    k = k.reshape(b, nc, lc, h, dk)
    v = v.reshape(b, nc, lc, h, dv)
    li = li.reshape(b, nc, lc, h)
    lf = lf.reshape(b, nc, lc, h)
    f_cum = torch.cumsum(lf, dim=2)                        # F_i within a chunk
    # log-weights D_ij = F_i - F_j + li_j (j ≤ i), stabiliser M_i
    d_j = li - f_cum
    m_local = torch.cummax(d_j, dim=2).values              # (B,NC,L,H)

    if state is None:
        c_st = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
        n_st = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
        m_st = torch.full((b, h), NEG_INIT, dtype=torch.float32, device=q.device)
    else:
        c_st, n_st, m_st = state
    ii = torch.arange(lc, device=q.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    ys = []
    for n in range(nc):
        qc, kc, vc = q[:, n], k[:, n], v[:, n]
        lic, fc, ml = li[:, n], f_cum[:, n], m_local[:, n]
        m_i = fc + torch.maximum(ml, m_st[:, None, :])      # (B,L,H)
        # intra-chunk (masked before the exp: the same values, and no 0 · inf
        # in the gradient)
        dmat = fc[:, :, None, :] - fc[:, None, :, :] + lic[:, None, :, :]
        w = torch.exp(torch.where(causal, dmat - m_i[:, :, None, :], -math.inf))
        qk = torch.einsum("blhd,bmhd->blmh", qc.float(), kc.float())
        y_num = torch.einsum("blmh,bmhv->blhv", qk * w, vc.float())
        den = (qk * w).sum(2)
        # inter-chunk
        scale = torch.exp(fc + m_st[:, None, :] - m_i)      # (B,L,H)
        y_num = y_num + torch.einsum("blhd,bhdv->blhv", qc.float(), c_st) * scale[..., None]
        den = den + torch.einsum("blhd,bhd->blh", qc.float(), n_st) * scale
        ys.append(y_num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
        # the state at the chunk's end
        f_l = fc[:, -1, :]                                   # (B,H)
        m_new = f_l + torch.maximum(ml[:, -1, :], m_st)
        w_end = torch.exp(f_l[:, None, :] - fc + lic - m_new[:, None, :])
        carry = torch.exp(f_l + m_st - m_new)
        kw = kc.float() * w_end[..., None]
        c_st = c_st * carry[:, :, None, None] + torch.einsum("blhd,blhv->bhdv", kw,
                                                              vc.float())
        n_st = n_st * carry[:, :, None] + kw.sum(1)
        m_st = m_new
    y = torch.stack(ys, 1).reshape(b, s, h, dv)
    return y, (c_st, n_st, m_st)


def mlstm_block(params: Params, x: torch.Tensor, spec: XLSTMSpec,
                cache: Params | None = None, decode: bool = False):
    """The mLSTM residual branch.  x (B, S, D) → ((B, S, D), new cache with
    ``decode``, else None).

    In the partitioned program: ``up`` whole (its column block mixes u and
    the gate g, and q, k, v contract over the whole u: one all-gather over
    ``model``), the conv on the whole u, then the rank's heads
    (:func:`repro_torch.runtime.spmd.model_block`) of q, k and v (the
    column blocks of ``wq``, ``wk``, ``wv``, or narrowed from a whole
    weight's product), of the
    gates and of g; the norm over the whole ``d_inner`` with its
    statistics summed over ``model``, ``w_down`` row-parallel.  Where the
    heads do not divide ``model`` every rank runs every head."""
    b, s, d = x.shape
    h, hd, di = spec.n_heads, spec.head_dim, spec.d_inner
    heads = spmd.model_block(spec.n_heads)
    block = heads is not None
    up = layers.to_layout(layers.linear(x, params["w_up"], d, 2 * di), 2 * di, False)
    u, g = up[..., :di].contiguous(), up[..., di:]
    conv_state = cache["conv"] if cache is not None else None
    uc, new_conv = _causal_conv(u, params["conv_w"], params["conv_b"], conv_state)
    h_l = heads[1] if block else h
    q, k, v = (layers.to_layout(layers.linear(t, params[n], di, di), di, block
                                ).reshape(b, s, h_l, hd)
               for t, n in ((uc, "wq"), (uc, "wk"), (u, "wv")))
    li, lf = _mlstm_gates(uc, params, h)
    if block:
        mesh = spmd.active_partition().mesh
        li, lf = (spmd.take_block(t, mesh, "model", t.ndim - 1, *heads) for t in (li, lf))
        g = spmd.take_block(g, mesh, "model", g.ndim - 1, heads[0] * hd, h_l * hd)
    if decode:
        y, (c_f, n_f, m_f) = mlstm_chunked(q, k, v, li, lf, chunk=1,
                                           state=(cache["c"], cache["n"], cache["m"]))
        new_cache = {"c": c_f, "n": n_f, "m": m_f, "conv": new_conv}
    else:
        y, _ = mlstm_chunked(q, k, v, li, lf, chunk=spec.chunk)
        new_cache = None
    y = y.reshape(b, s, h_l * hd).to(x.dtype)
    y = layers.split_rms_norm(y, params["norm"], di)
    y = y * F.silu(g.float()).to(x.dtype)
    return layers.linear(y, params["w_down"], di, d), new_cache


def init_mlstm_cache(batch: int, spec: XLSTMSpec, dtype: torch.dtype,
                     device: torch.device) -> Params:
    """Zeroed mLSTM decode state: C, n, the stabiliser m (-1e30) and the
    conv's last W - 1 inputs."""
    h, hd = spec.n_heads, spec.head_dim
    return {
        "c": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), NEG_INIT, dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, spec.conv_width - 1, spec.d_inner), dtype=dtype,
                            device=device),
    }


def mlstm_cache_axes() -> Params:
    """Axis roles of :func:`init_mlstm_cache`'s leaves: batch at axis 0, no
    sequence axis."""
    ax = CacheAxes(batch=0)
    return {"c": ax, "n": ax, "m": ax, "conv": ax}


# ---------------------------------------------------------------------------
# sLSTM: a recurrent loop over time (no parallel form exists)
# ---------------------------------------------------------------------------
def init_slstm(gen: torch.Generator, spec: XLSTMSpec, dtype: torch.dtype,
               device: torch.device) -> Params:
    """The sLSTM cell's weights: float32 input gates ``w_gates`` (z, i, f,
    o), the head-block-diagonal recurrent gates ``r_gates`` (H, hd, 4·hd),
    the gate bias (forget gates 3), the norm and ``w_out``."""
    d, h = spec.d_model, spec.n_heads
    hd = d // h
    p: Params = {"w_gates": layers.dense_init(gen, d, 4 * d, torch.float32, device)}
    r = torch.randn((h, hd, 4 * hd), generator=gen, dtype=torch.float32, device=device)
    p["r_gates"] = r * hd ** -0.5
    p["b_gates"] = torch.cat([torch.zeros((2 * d,), device=device),
                              torch.full((d,), 3.0, device=device),
                              torch.zeros((d,), device=device)])
    p["norm"] = layers.init_rms_norm(d, device)
    p["w_out"] = layers.dense_init(gen, d, d, dtype, device)
    return p


def slstm_scan(params: Params, x: torch.Tensor, spec: XLSTMSpec, state=None):
    """x (B, S, D) → ((B, S, D), state); ``state`` is ``(h, c, n, m)``, each
    (B, H, hd) float32, or None (zeros, n 1e-6, m -1e30)."""
    b, s, d = x.shape
    nh = spec.n_heads
    hd = d // nh
    # (B,S,4D); in the partitioned program w_gates is the reference's column
    # block (its rule for ``w_gate`` matches it), gathered whole: the time
    # loop runs every head on the rank's rows
    wx = layers.to_layout(layers.linear(x, params["w_gates"].to(x.dtype), d, 4 * d,
                                        out_dtype=torch.float32), 4 * d, False)
    if state is None:
        zeros = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros + 1e-6, zeros + NEG_INIT)
    h_prev, c_prev, n_prev, m_prev = state
    bias = params["b_gates"].reshape(4, nh, hd)[None]
    hs = []
    for t in range(s):
        rec = layers.einsum_f32("bhd,hde->bhe", h_prev, params["r_gates"])
        # wx_t (B, 4, H, hd); rec (B, H, 4·hd) → (B, 4, H, hd)
        gates = (wx[:, t].reshape(b, 4, nh, hd)
                 + rec.reshape(b, nh, 4, hd).transpose(1, 2) + bias)
        z, i_raw, f_raw, o_raw = gates.unbind(1)
        z = torch.tanh(z)
        lf = log_sigmoid(f_raw)
        m_new = torch.maximum(lf + m_prev, i_raw)
        i_g = torch.exp(i_raw - m_new)
        f_g = torch.exp(lf + m_prev - m_new)
        c_prev = f_g * c_prev + i_g * z
        n_prev = f_g * n_prev + i_g
        h_prev = torch.sigmoid(o_raw) * c_prev / torch.maximum(
            n_prev, torch.tensor(1e-6, device=x.device))
        m_prev = m_new
        hs.append(h_prev)
    y = torch.stack(hs, 1).reshape(b, s, d).to(x.dtype)
    y = layers.rms_norm(y, params["norm"])
    return layers.linear(y, params["w_out"], d, d), (h_prev, c_prev, n_prev, m_prev)


def init_slstm_cache(batch: int, spec: XLSTMSpec, device: torch.device) -> tuple:
    """Zeroed sLSTM decode state ``(h, c, n, m)``: n 1e-6, m -1e30."""
    hd = spec.d_model // spec.n_heads
    zeros = torch.zeros((batch, spec.n_heads, hd), dtype=torch.float32, device=device)
    return (zeros, zeros.clone(), zeros + 1e-6, zeros + NEG_INIT)


def slstm_cache_axes() -> tuple:
    """Axis roles of :func:`init_slstm_cache`'s leaves (h, c, n, m)."""
    return (CacheAxes(batch=0),) * 4
