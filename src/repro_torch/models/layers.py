"""Shared building blocks: norms, RoPE, embeddings, MLPs — all SoD-aware.

Twin of :mod:`repro.models.layers`.  Every weight matmul goes through
:func:`repro_torch.core.sod.apply`, so a packed leaf runs the Sparse-on-Dense
kernel and a dense leaf bypasses decompression.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import sod

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
    """RMSNorm in float32 with the ``1 + gamma`` gain, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + gamma.float())).to(x.dtype)


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
        plans: dict | None = None) -> torch.Tensor:
    """SwiGLU MLP through three SoD matmuls.  ``plans`` maps ``w_gate`` /
    ``w_up`` / ``w_down`` to their :class:`repro_torch.core.plan.PackPlan`
    (absent entries fall back to the active plan's layout lookup)."""
    pl = (plans or {}).get
    gate = sod.apply(x, params["w_gate"], plan=pl("w_gate"))
    up = sod.apply(x, params["w_up"], plan=pl("w_up"))
    return sod.apply(activate(gate, act) * up, params["w_down"], plan=pl("w_down"))


def embed(table: torch.Tensor, tokens: torch.Tensor, scale: bool = False) -> torch.Tensor:
    """Row lookup; gemma-style sqrt(d) scale when ``scale``."""
    x = table[tokens]
    if scale:
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype, device=x.device)
    return x
