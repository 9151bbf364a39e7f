"""Mamba2 (SSD) block — the chunked matmul form and the O(1) decode step.

Twin of :mod:`repro.models.ssm`.  The state-space recurrence per head h
with scalar decay A_h:

    S_t = exp(A_h·dt_t) · S_{t-1} + dt_t · B_t ⊗ x_t         (d_state × headdim)
    y_t = C_t · S_t + D_h · x_t

The full-sequence forward uses the chunked SSD form: intra-chunk
contributions are a masked (L_c × L_c) product, the inter-chunk state is
carried by a loop over chunks.  Decode keeps the recurrent state.

Every projection goes through :func:`repro_torch.core.sod.apply`; ``w_z``,
``w_x`` and ``out_proj`` are packed under Sparse-on-Dense, ``w_b``, ``w_c``
and ``w_dt`` stay dense, as in the reference.  The scan itself is plain
torch, with the reference's float32 sums and its casts to the working dtype
where they are.

In a partitioned step (:func:`repro_torch.runtime.spmd.use_partition`)
the block runs on the rank's rows and, where the heads divide ``model``,
on its Mamba2 heads (:func:`repro_torch.runtime.spmd.model_block`, the
reference's column split of ``w_z`` and ``w_x``): its x channels and
their conv, its heads' SSD and decode state, the gated norm over the
whole ``d_inner`` with its statistics summed over ``model``, and
``out_proj`` row-parallel; ``w_b``, ``w_c`` and ``w_dt`` stay whole.
Where the heads do not divide ``model`` every rank runs every head.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.cache import CacheAxes
from repro_torch.runtime import spmd

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    """Shapes of one Mamba2 block."""

    d_model: int
    d_state: int = 64
    expand: int = 2
    headdim: int = 64
    conv_width: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (torch's
    ``F.softplus`` turns into the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba(gen: torch.Generator, spec: MambaSpec, dtype: torch.dtype,
               device: torch.device) -> Params:
    """The block's weights: separate input projections ``w_z``, ``w_x``,
    ``w_b``, ``w_c``, ``w_dt``, depthwise convs over x, B and C (one per
    part: per-channel convs over the concatenation are the same), the
    decay ``a_log``, skip ``d_skip``, ``dt_bias``, the gated norm and
    ``out_proj``."""
    di, ds, nh = spec.d_inner, spec.d_state, spec.n_heads

    def conv_init(c):
        w = torch.randn((spec.conv_width, c), generator=gen, dtype=torch.float32,
                        device=device)
        return (w * 0.1).to(dtype)

    p: Params = {
        "w_z": layers.dense_init(gen, spec.d_model, di, dtype, device),
        "w_x": layers.dense_init(gen, spec.d_model, di, dtype, device),
        "w_b": layers.dense_init(gen, spec.d_model, ds, dtype, device),
        "w_c": layers.dense_init(gen, spec.d_model, ds, dtype, device),
        "w_dt": layers.dense_init(gen, spec.d_model, nh, dtype, device),
        "conv_x": conv_init(di),
        "conv_x_b": torch.zeros((di,), dtype=dtype, device=device),
        "conv_b": conv_init(ds),
        "conv_b_b": torch.zeros((ds,), dtype=dtype, device=device),
        "conv_c": conv_init(ds),
        "conv_c_b": torch.zeros((ds,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=device)),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=device),
    }
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=device)
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))
    p["norm"] = layers.init_rms_norm(di, device)
    p["out_proj"] = layers.dense_init(gen, di, spec.d_model, dtype, device)
    return p


_CONV_PARTS = ("x", "b", "c")
_HEAD_LEAVES = ("dt_bias", "a_log", "d_skip")


def _head_params(params: Params, spec: MambaSpec) -> Params:
    """The per-head and per-channel leaves the rank's heads read: the whole
    leaves, or in the partitioned program the blocks of the rank's heads
    (:func:`repro_torch.runtime.spmd.model_block`) of ``dt_bias``,
    ``a_log``, ``d_skip`` and of the x channels' ``conv_x`` /
    ``conv_x_b``, each through
    :func:`~repro_torch.runtime.spmd.take_block` (its gradient summed over
    ``model``, so every rank holds the whole leaf's)."""
    names = _HEAD_LEAVES + ("conv_x", "conv_x_b")
    heads = spmd.model_block(spec.n_heads)
    if heads is None:
        return {k: params[k] for k in names}
    mesh, (first, n), hd = spmd.active_partition().mesh, heads, spec.headdim
    out = {k: spmd.take_block(params[k], mesh, "model", 0, first, n) for k in _HEAD_LEAVES}
    out["conv_x"] = spmd.take_block(params["conv_x"], mesh, "model", 1, first * hd, n * hd)
    out["conv_x_b"] = spmd.take_block(params["conv_x_b"], mesh, "model", 0, first * hd,
                                      n * hd)
    return out


def _project(params: Params, x: torch.Tensor, conv_states: Params | None,
             spec: MambaSpec, hp: Params):
    """``(z, xh, b, c, dt_raw, new conv states)``.  The three depthwise
    convs (over x, B and C) run as one over their concatenated channels:
    every op is per channel, so each part's values are the reference's
    per-part conv's, in a third of the operator calls; the widths come
    from the parts.  In the partitioned program ``z``, ``xh`` and ``dt``
    are the rank's heads (``hp``: :func:`_head_params`): the column
    blocks of ``w_z`` and ``w_x`` as :func:`repro_torch.models.layers.
    to_layout` lays their products (whole where the heads do not split),
    ``dt`` narrowed from the whole ``w_dt``'s; ``b`` and ``c`` are whole,
    from the whole ``w_b`` and ``w_c``, and float32 (the values the scan
    reads), their cotangents (each the rank's heads' share) summed over
    ``model``."""
    part = spmd.active_partition()
    d, di, ds, nh = x.shape[-1], spec.d_inner, spec.d_state, spec.n_heads
    heads = spmd.model_block(spec.n_heads)
    z = layers.to_layout(layers.linear(x, params["w_z"], d, di), di, heads is not None)
    parts = [layers.to_layout(layers.linear(x, params["w_x"], d, di), di, heads is not None),
             layers.linear(x, params["w_b"], d, ds), layers.linear(x, params["w_c"], d, ds)]
    dt = layers.linear(x, params["w_dt"], d, nh)
    if heads is not None:
        dt = spmd.take_block(dt, part.mesh, "model", dt.ndim - 1, *heads)
    widths = [t.shape[-1] for t in parts]
    state = (None if conv_states is None else
             torch.cat([conv_states[k] for k in _CONV_PARTS], -1))
    y, new = _causal_conv(
        torch.cat(parts, -1),
        torch.cat([hp["conv_x"], params["conv_b"], params["conv_c"]], -1),
        torch.cat([hp["conv_x_b"], params["conv_b_b"], params["conv_c_b"]], -1), state)
    xh, b, c = y.split(widths, -1)
    if heads is not None:       # float32: each rank's share summed before one rounding
        b, c = (spmd.grad_sum(t.float(), part.mesh, "model") for t in (b, c))
    return z, xh, b, c, dt, dict(zip(_CONV_PARTS, new.split(widths, -1)))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv along S: u (B, S, C), w (W, C), the last W - 1
    inputs of the previous call in ``state`` (zeros when None).  Returns
    ``(silu(conv + b) in u's dtype, new state)``."""
    width = w.shape[0]
    pad = (u.new_zeros((u.shape[0], width - 1, u.shape[2])) if state is None
           else state)
    up = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    y = up[:, :s] * w[0]                      # the reference's sum from 0, in order
    for i in range(1, width):
        y = y + up[:, i:i + s] * w[i]
    y = F.silu((y + b).float()).to(u.dtype)
    new_state = up[:, up.shape[1] - (width - 1):] if width > 1 else pad
    return y, new_state


def mamba_forward(params: Params, x: torch.Tensor, spec: MambaSpec) -> torch.Tensor:
    """Full-sequence chunked SSD.  x (B, S, D) → (B, S, D); S must be a
    multiple of the chunk (or shorter than one)."""
    bsz, s, _ = x.shape
    lc = min(spec.chunk, s)
    if s % lc:
        raise ValueError(f"seq {s} not divisible by chunk {lc}")
    nc = s // lc
    hd, ds = spec.headdim, spec.d_state

    hp = _head_params(params, spec)
    z, xh, b, c, dt, _ = _project(params, x, None, spec, hp)
    nh = xh.shape[-1] // hd                                       # the rank's heads
    xh = xh.reshape(bsz, nc, lc, nh, hd)
    b = b.reshape(bsz, nc, lc, ds)
    c = c.reshape(bsz, nc, lc, ds)
    dt = softplus(dt.float() + hp["dt_bias"][None, None, :]
                  ).reshape(bsz, nc, lc, nh)                     # (B,NC,L,H)
    a = -torch.exp(hp["a_log"])                                   # (H,)
    adt = a[None, None, None, :] * dt                             # decay logs ≤ 0
    alpha = torch.cumsum(adt, dim=2)                              # (B,NC,L,H)

    # intra-chunk: masked (L × L) product per head
    cb = torch.einsum("bnis,bnjs->bnij", c.float(), b.float())       # (B,NC,L,L)
    decay = alpha[:, :, :, None, :] - alpha[:, :, None, :, :]     # (B,NC,L,L,H)
    ii = torch.arange(lc, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # masked before the exp (the reference masks after): the same values,
    # and no 0 · inf in the gradient where an upper-triangle decay overflows
    m = torch.exp(torch.where(causal, decay, -math.inf)) * cb[..., None]
    m = m * dt[:, :, None, :, :]                                  # × dt_j
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", m.to(xh.dtype).float(), xh.float())

    # chunk-final states and the inter-chunk loop
    seg = torch.exp(alpha[:, :, -1:, :] - alpha)                  # exp(α_L - α_j)
    bx = torch.einsum("bnjs,bnjhp->bnhsp", b.float(),
                      (xh * (dt * seg)[..., None].to(xh.dtype)).float())  # (B,NC,H,S,P)
    chunk_decay = torch.exp(alpha[:, :, -1, :])                   # (B,NC,H)
    state = torch.zeros((bsz, nh, ds, hd), dtype=torch.float32, device=x.device)
    y_inter = []
    for n in range(nc):
        y_inter.append(torch.einsum("bis,bhsp->bihp", c[:, n].float(), state)
                       * torch.exp(alpha[:, n])[..., None])
        state = state * chunk_decay[:, n, :, None, None] + bx[:, n]
    y = y_intra + torch.stack(y_inter, 1)                         # (B,NC,L,H,P)
    y = y + hp["d_skip"][None, None, None, :, None] * xh.float()
    return _gated_out(params, y.reshape(bsz, s, nh * hd).to(x.dtype), z, spec)


def _gated_out(params: Params, y: torch.Tensor, z: torch.Tensor,
               spec: MambaSpec) -> torch.Tensor:
    """``out_proj(norm(y · silu(z)))``: in the partitioned program ``y``
    and ``z`` the rank's heads, the gated norm's statistics summed over
    ``model`` (:func:`repro_torch.models.layers.split_rms_norm`) and
    ``out_proj`` row-parallel (its float32 partials summed)."""
    y = y * F.silu(z.float()).to(y.dtype)
    y = layers.split_rms_norm(y, params["norm"], spec.d_inner)
    return layers.linear(y, params["out_proj"], spec.d_inner, spec.d_model)


# ---------------------------------------------------------------------------
# decode (O(1) state)
# ---------------------------------------------------------------------------
def init_mamba_cache(batch: int, spec: MambaSpec, dtype: torch.dtype,
                     device: torch.device) -> Params:
    """Zeroed decode state of one block: the float32 SSM state and the
    convs' last W - 1 inputs."""
    w = spec.conv_width - 1
    return {
        "ssm": torch.zeros((batch, spec.n_heads, spec.d_state, spec.headdim),
                           dtype=torch.float32, device=device),
        "conv": {
            "x": torch.zeros((batch, w, spec.d_inner), dtype=dtype, device=device),
            "b": torch.zeros((batch, w, spec.d_state), dtype=dtype, device=device),
            "c": torch.zeros((batch, w, spec.d_state), dtype=dtype, device=device),
        },
    }


def mamba_cache_axes() -> Params:
    """Axis roles of :func:`init_mamba_cache`'s leaves: batch at axis 0, no
    sequence axis anywhere (the state is O(1) in sequence length)."""
    ax = CacheAxes(batch=0)
    return {"ssm": ax, "conv": {"x": ax, "b": ax, "c": ax}}


def mamba_decode_step(params: Params, x: torch.Tensor, cache: Params,
                      spec: MambaSpec):
    """x (B, 1, D) → ((B, 1, D), new state ``{"ssm", "conv"}``)."""
    bsz = x.shape[0]
    hd, ds = spec.headdim, spec.d_state
    hp = _head_params(params, spec)
    z, xh, b, c, dt, conv_state = _project(params, x, cache["conv"], spec, hp)
    nh = xh.shape[-1] // hd                                       # the rank's heads
    xh = xh.reshape(bsz, nh, hd)
    b = b.reshape(bsz, ds)
    c = c.reshape(bsz, ds)
    dt = softplus(dt[:, 0].float() + hp["dt_bias"])               # (B,H)
    decay = torch.exp(-torch.exp(hp["a_log"]) * dt)                # (B,H)
    update = (b.float()[:, None, :, None] * xh.float()[:, :, None, :]
              * dt[:, :, None, None])                              # (B,H,S,P)
    state = cache["ssm"] * decay[:, :, None, None] + update
    y = torch.einsum("bs,bhsp->bhp", c.float(), state)
    y = y + hp["d_skip"][:, None] * xh.float()
    y = _gated_out(params, y.reshape(bsz, 1, nh * hd).to(x.dtype), z, spec)
    return y, {"ssm": state, "conv": conv_state}
