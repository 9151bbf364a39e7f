"""Shared building blocks: norms, RoPE, embeddings, MLPs — all SoD-aware.

Twin of :mod:`repro.models.layers`, its loss included.  Every weight
matmul goes through :func:`repro_torch.core.sod.apply`, so a packed leaf
runs the Sparse-on-Dense kernel and a dense leaf bypasses decompression.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import sod
from repro_torch.kernels import ops

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


def lm_head(x: torch.Tensor, table_or_w, tied: bool, cap: float | None = None,
            plan=None) -> torch.Tensor:
    """Vocabulary logits in float32, soft-capped by ``cap``.

    Tied: ``x`` against the (vocab, d) embedding table transposed, operands
    in x's dtype and products summed in float32 (the reference's dot with
    ``preferred_element_type=float32``).  Untied: ``x`` through the (d,
    vocab) head weight by :func:`repro_torch.core.sod.apply` with float32
    out, so a packed head runs the Sparse-on-Dense kernel; ``plan`` is its
    :class:`repro_torch.core.plan.PackPlan` (None: the active plan's layout
    lookup)."""
    if tied:
        logits = ops.dense_matmul(x, table_or_w.to(x.dtype).T, torch.float32)
    else:
        logits = sod.apply(x, table_or_w, out_dtype=torch.float32, plan=plan)
    return softcap(logits.float(), cap)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy: logits (..., V) float32, targets (...) int;
    with ``mask``, the mean over the masked-in tokens (at least one)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
