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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import sod
from repro_torch.models import layers
from repro_torch.models.cache import CacheAxes

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


def _project(params: Params, x: torch.Tensor, conv_states: Params | None):
    """``(z, xh, b, c, dt_raw, new conv states)``.  The three depthwise
    convs (over x, B and C) run as one over their concatenated channels:
    every op is per channel, so each part's values are the reference's
    per-part conv's, in a third of the operator calls."""
    z = sod.apply(x, params["w_z"])
    parts = [sod.apply(x, params["w_x"]), sod.apply(x, params["w_b"]),
             sod.apply(x, params["w_c"])]
    dt = sod.apply(x, params["w_dt"])
    widths = [t.shape[-1] for t in parts]
    state = (None if conv_states is None else
             torch.cat([conv_states[k] for k in _CONV_PARTS], -1))
    y, new = _causal_conv(
        torch.cat(parts, -1),
        torch.cat([params[f"conv_{k}"] for k in _CONV_PARTS], -1),
        torch.cat([params[f"conv_{k}_b"] for k in _CONV_PARTS], -1), state)
    xh, b, c = y.split(widths, -1)
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
    nh, hd, ds = spec.n_heads, spec.headdim, spec.d_state

    z, xh, b, c, dt, _ = _project(params, x, None)
    xh = xh.reshape(bsz, nc, lc, nh, hd)
    b = b.reshape(bsz, nc, lc, ds)
    c = c.reshape(bsz, nc, lc, ds)
    dt = softplus(dt.float() + params["dt_bias"][None, None, :]
                  ).reshape(bsz, nc, lc, nh)                     # (B,NC,L,H)
    a = -torch.exp(params["a_log"])                               # (H,)
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
    y = y + params["d_skip"][None, None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, spec.d_inner).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = layers.rms_norm(y, params["norm"])
    return sod.apply(y, params["out_proj"])


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
    nh, hd, ds = spec.n_heads, spec.headdim, spec.d_state
    z, xh, b, c, dt, conv_state = _project(params, x, cache["conv"])
    xh = xh.reshape(bsz, nh, hd)
    b = b.reshape(bsz, ds)
    c = c.reshape(bsz, ds)
    dt = softplus(dt[:, 0].float() + params["dt_bias"])           # (B,H)
    decay = torch.exp(-torch.exp(params["a_log"]) * dt)            # (B,H)
    update = (b.float()[:, None, :, None] * xh.float()[:, :, None, :]
              * dt[:, :, None, None])                              # (B,H,S,P)
    state = cache["ssm"] * decay[:, :, None, None] + update
    y = torch.einsum("bs,bhsp->bhp", c.float(), state)
    y = y + params["d_skip"][:, None] * xh.float()
    y = y.reshape(bsz, 1, spec.d_inner).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = layers.rms_norm(y, params["norm"])
    return sod.apply(y, params["out_proj"]), {"ssm": state, "conv": conv_state}
