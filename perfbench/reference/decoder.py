"""Plain float32 reference of the dense decoder the cells serve.

Written from the published description of a llama-style decoder
(InternLM2, Yi): token embedding; per layer RMSNorm with the gain ``1 + g``,
q, k, v projections, rotary position embedding on split halves, causal
grouped-query attention (query head ``h`` reads key/value head ``h //
(heads / kv_heads)``), the output projection and the residual, RMSNorm, a
SwiGLU MLP and the residual; a final RMSNorm and the untied LM head.  It
computes every sequence in full, layer by layer, with no cache, no batching
and no kernel.  Matmuls run in float32 with TF32 off (``strict_float32``);
``matmul`` may be replaced, as the control does (a lower precision).

Imports nothing of the program: the weights come from a callable the caller
gives (the benchmark's own draw and this package's pruning).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes of one configuration, read from its file (the names of the
    model's published ``config.json``)."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float

    @property
    def padded_vocab(self) -> int:
        """Rows of the embedding and columns of the head: the vocabulary
        rounded up to 128, the program's layout (equal to ``vocab`` for
        every configuration here)."""
        return (self.vocab + 127) // 128 * 128

    @classmethod
    def from_config(cls, cfg: dict) -> "Dims":
        heads = cfg["num_attention_heads"]
        return cls(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
                   n_heads=heads, n_kv_heads=cfg["num_key_value_heads"],
                   head_dim=cfg.get("head_dim", cfg["hidden_size"] // heads),
                   d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                   rope_theta=float(cfg["rope_theta"]),
                   norm_eps=float(cfg["rms_norm_eps"]))


def strict_float32() -> None:
    """float32 matmuls in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + g)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (S, heads, hd) at positions 0..S-1, split halves;
    angles in float64, then float32."""
    s, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA: q (S, H, hd), k and v (S, KV, hd) -> (S, H * hd)."""
    s, h, hd = q.shape
    kvh = k.shape[1]
    qg = q.reshape(s, kvh, h // kvh, hd).permute(1, 2, 0, 3)         # KV, G, S, hd
    scores = torch.einsum("kgsd,ktd->kgst", qg, k.permute(1, 0, 2)) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("kgst,ktd->kgsd", p, v.permute(1, 0, 2))       # KV, G, S, hd
    return out.permute(2, 0, 1, 3).reshape(s, h * hd)


def layer(x: torch.Tensor, w: dict, d: Dims, mm: Matmul) -> torch.Tensor:
    """One decoder layer on one sequence's (S, d_model) float32 stream."""
    s = x.shape[0]
    h = rms_norm(x, w["norm1"], d.norm_eps)
    q = rope(mm(h, w["attn"]["wq"]).view(s, d.n_heads, d.head_dim), d.rope_theta)
    k = rope(mm(h, w["attn"]["wk"]).view(s, d.n_kv_heads, d.head_dim), d.rope_theta)
    v = mm(h, w["attn"]["wv"]).view(s, d.n_kv_heads, d.head_dim)
    x = x + mm(attention(q, k, v), w["attn"]["wo"])
    h = rms_norm(x, w["norm2"], d.norm_eps)
    m = mm(F.silu(mm(h, w["mlp"]["w_gate"])) * mm(h, w["mlp"]["w_up"]), w["mlp"]["w_down"])
    return x + m


def logits_at(seqs: list[torch.Tensor], rows: list[torch.Tensor],
              layer_weights: Callable[[int], dict], top: dict, d: Dims,
              mm: Matmul = torch.matmul) -> list[torch.Tensor]:
    """float32 logits (len(rows[i]), vocab) of sequence ``seqs[i]`` (token
    ids) at positions ``rows[i]``.  ``layer_weights(l)`` gives layer ``l``'s
    float32 weights (asked for once, in order, so a caller may draw them
    then); ``top`` holds ``embed``, ``final_norm`` and ``head``."""
    xs = [top["embed"][ids].float() for ids in seqs]
    for i in range(d.n_layers):
        w = layer_weights(i)
        xs = [layer(x, w, d, mm) for x in xs]
        del w
    return [mm(rms_norm(x[r], top["final_norm"], d.norm_eps), top["head"])[:, : d.vocab]
            for x, r in zip(xs, rows)]
