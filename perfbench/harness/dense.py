"""The llama-style dense decoder's side of a run, for the architecture
modules that serve it (``arch/<architectures>.py``).

An architecture module gives the harness, by these names:

* ``port_config(cfg)``: the port's ``ModelConfig`` of the configuration;
* ``draw_params(cfg, seed, device)``: the raw weights in the port's
  parameter tree, drawn on the device from the seed, in the served dtype;
* ``Reference(cfg, seed, device)``: the reference's side after the window:
  ``logits(seqs, rows, mm)`` (float32 logits at the given positions, the
  products through ``mm``), then ``matrices()`` and ``model()`` (what the
  yardstick counts: every packed projection's stored values).

Here the tree is ``{"embed", "final_norm", "head", "layers": [{"norm1",
"norm2", "attn": {wq, wk, wv, wo}, "mlp": {w_gate, w_up, w_down}}]}``.
Each layer's matrices come from one call on the device (one flat draw, cut
into views and scaled by ``1/sqrt(d_in)``), so set-up makes them in a few
large calls.  RMSNorm gains are drawn too (``1 + g``, ``g ~ N(0, 0.1^2)``,
float32), so the comparison covers them.  The reference draws the same
tensors again, layer by layer, and prunes them by its own rule.

A configuration that states what this decoder does not compute (tied
embeddings, biases, an activation other than SiLU, rope scaling) is
refused, not served as something else.
"""
from __future__ import annotations

import torch

from perfbench.harness import yardstick
from perfbench.harness.weights import generator
from perfbench.reference import decoder, prune
from perfbench.reference.decoder import Dims

NORM_STD = 0.1
EMBED_STD = 0.02
_ABSENT = {"tie_word_embeddings": False, "bias": False, "attention_bias": False,
           "mlp_bias": False, "rope_scaling": None}


def dims(cfg: dict) -> Dims:
    """The configuration's sizes, once it is shown to be this decoder."""
    for key, plain in _ABSENT.items():
        if cfg.get(key, plain) not in (plain, None, False):
            raise ValueError(f"{cfg.get('name', 'configuration')}: {key}={cfg[key]!r} is not "
                             "computed by the dense decoder; give it an architecture module")
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {cfg['hidden_act']!r}: the dense decoder runs SwiGLU")
    return Dims.from_config(cfg)


def port_config(cfg: dict):
    """The port's ``ModelConfig``: its architecture ``port_arch`` with every
    size, the norm epsilon, the dtype and the SoD packing the file states."""
    from repro_torch import configs
    from repro_torch.core.sod import SoDConfig

    d = dims(cfg)
    s = cfg["sod"]
    sod = SoDConfig(mode=s["mode"], density=s["density"], prune_method=s["prune_method"],
                    tile=tuple(s["tile"]), br=s["br"], min_dim=s["min_dim"])
    return configs.get_config(cfg["port_arch"]).with_(
        name=cfg["name"], n_layers=d.n_layers, d_model=d.d_model, n_heads=d.n_heads,
        n_kv_heads=d.n_kv_heads, head_dim=d.head_dim, d_ff=d.d_ff, vocab=d.vocab,
        rope_theta=d.rope_theta, norm_eps=d.norm_eps, tie_embeddings=False,
        dtype=cfg["torch_dtype"], sod=sod)


def layer_matrices(d: Dims) -> list[tuple[str, str, int, int]]:
    """``(group, name, K, N)`` of one layer's projections, in draw order."""
    q, kv = d.n_heads * d.head_dim, d.n_kv_heads * d.head_dim
    return [("attn", "wq", d.d_model, q), ("attn", "wk", d.d_model, kv),
            ("attn", "wv", d.d_model, kv), ("attn", "wo", q, d.d_model),
            ("mlp", "w_gate", d.d_model, d.d_ff), ("mlp", "w_up", d.d_model, d.d_ff),
            ("mlp", "w_down", d.d_ff, d.d_model)]


def draw_layer(d: Dims, seed: int, layer: int, device, dtype=torch.bfloat16) -> dict:
    """Layer ``layer``'s raw weights in the port's layout."""
    mats = layer_matrices(d)
    g = generator(seed, device, 1, layer)
    flat = torch.randn(sum(k * n for _, _, k, n in mats), generator=g,
                       dtype=dtype, device=device)
    norms = torch.randn(2 * d.d_model, generator=g, dtype=torch.float32,
                        device=device) * NORM_STD
    out: dict = {"norm1": norms[:d.d_model].clone(), "norm2": norms[d.d_model:].clone(),
                 "attn": {}, "mlp": {}}
    at = 0
    for group, name, k, n in mats:
        w = flat[at:at + k * n].view(k, n)
        w.mul_(k ** -0.5)
        out[group][name] = w
        at += k * n
    return out


def draw_embed_head(d: Dims, seed: int, device, dtype=torch.bfloat16) -> dict:
    """``embed`` (padded vocab, d), ``final_norm`` and the untied ``head``
    (d, padded vocab)."""
    g = generator(seed, device, 2)
    v = d.padded_vocab
    embed = torch.randn((v, d.d_model), generator=g, dtype=dtype, device=device)
    embed.mul_(EMBED_STD)
    head = torch.randn((d.d_model, v), generator=g, dtype=dtype, device=device)
    head.mul_(d.d_model ** -0.5)
    final_norm = torch.randn(d.d_model, generator=g, dtype=torch.float32,
                             device=device) * NORM_STD
    return {"embed": embed, "final_norm": final_norm, "head": head}


def draw_params(cfg: dict, seed: int, device) -> dict:
    """Every raw weight of the run, in the port's parameter tree."""
    d, dtype = dims(cfg), getattr(torch, cfg["torch_dtype"])
    return {**draw_embed_head(d, seed, device, dtype),
            "layers": [draw_layer(d, seed, i, device, dtype) for i in range(d.n_layers)]}


class Reference:
    """The reference's float32 weights, drawn again from the seed and
    pruned by the reference's rule; counts what the format stores of each."""

    def __init__(self, cfg: dict, seed: int, device):
        self.d, self.sod, self.seed, self.device = dims(cfg), cfg["sod"], seed, device
        self.dtype = getattr(torch, cfg["torch_dtype"])
        self.stored: dict[str, int] = {}

    def _pruned(self, key: str, w: torch.Tensor) -> torch.Tensor:
        p = prune.prune(w, self.sod)
        self.stored[key] = prune.stored(p, self.sod)
        return p.float()

    def layer(self, i: int) -> dict:
        raw = draw_layer(self.d, self.seed, i, self.device, self.dtype)
        out = {"norm1": raw["norm1"], "norm2": raw["norm2"], "attn": {}, "mlp": {}}
        for group, name, _, _ in layer_matrices(self.d):
            out[group][name] = self._pruned(f"{i}.{name}", raw[group][name])
        return out

    def top(self) -> dict:
        raw = draw_embed_head(self.d, self.seed, self.device, self.dtype)
        return {"embed": raw["embed"].float(), "final_norm": raw["final_norm"],
                "head": self._pruned("head", raw["head"])}

    def logits(self, seqs: list, rows: list, mm=torch.matmul) -> list[torch.Tensor]:
        """float32 logits of ``seqs[i]`` at positions ``rows[i]``."""
        return decoder.logits_at(seqs, rows, self.layer, self.top(), self.d, mm=mm)

    def matrices(self) -> list[yardstick.Matrix]:
        """Every packed projection with its stored count (after a pass)."""
        mats = [yardstick.Matrix(f"{i}.{name}", k, n, self.stored[f"{i}.{name}"])
                for i in range(self.d.n_layers)
                for _, name, k, n in layer_matrices(self.d)]
        return mats + [yardstick.Matrix("head", self.d.d_model, self.d.padded_vocab,
                                        self.stored["head"], out_bytes=4)]

    def model(self) -> yardstick.Model:
        mats = self.matrices()
        return yardstick.Model(layer_stored=sum(m.stored for m in mats[:-1]),
                               head_stored=mats[-1].stored, n_layers=self.d.n_layers,
                               n_heads=self.d.n_heads, head_dim=self.d.head_dim)
