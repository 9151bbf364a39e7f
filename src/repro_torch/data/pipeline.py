"""Deterministic synthetic token data — twin of :mod:`repro.data.pipeline`.

The successor table is the reference's (``np.random.default_rng(seed)``),
so both packages walk the same bigram chain.  The walk itself draws from
numpy where the reference draws from ``jax.random``, which torch cannot
reproduce: the two give different tokens for one seed, and parity tests feed
the reference's tokens to both.  The batches' shapes are the reference's: a
VLM's text is ``seq_len - n_patches`` tokens (none at ``seq_len ==
n_patches``) beside ``patch_embeds`` (B, n_patches, frontend_dim), standard
normal from the batch's generator, kept in float32 (numpy has no bfloat16;
the model rounds them to its working dtype where it uses them); an audio
batch walks one chain a codebook, tokens and targets (B, S, n_codebooks).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticLMData:
    """Batches are a pure function of (seed, step): a random bigram walk."""

    cfg: ModelConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    branching: int = 4     # out-degree of the bigram chain

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.cfg.vocab
        # each token has `branching` likely successors
        self._succ = rng.integers(0, v, size=(v, self.branching))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """``{"tokens", "targets"}``, int32 (B, S) each; a VLM's text is S -
        n_patches long and ``"patch_embeds"`` (B, n_patches, frontend_dim)
        float32 go with it; audio's are (B, S, n_codebooks)."""
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        b, s, cfg = self.batch_size, self.seq_len, self.cfg
        if cfg.family == "vlm":
            # the reference walks s - n_patches + 1 tokens: at s == n_patches
            # (and n_patches - 1) the text is (B, 0); below, its walk of a
            # negative length raises a TypeError
            n_walk = s - cfg.n_patches + 1
            if n_walk < 0:
                raise TypeError(f"seq_len {s} is below the {cfg.n_patches} patches "
                                f"less one: a walk of {n_walk} text tokens")
            toks = self._chain(rng, b, n_walk)
            patches = rng.standard_normal((b, cfg.n_patches, cfg.frontend_dim),
                                          dtype=np.float32)
            return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                    "patch_embeds": patches}
        if cfg.family == "audio":
            toks = np.stack([self._chain(rng, b, s + 1)
                             for _ in range(cfg.n_codebooks)], axis=-1)
            return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        toks = self._chain(rng, b, s + 1)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def host_slice(self, batch: dict, host_id: int, n_hosts: int) -> dict:
        """Host ``host_id``'s rows of a batch split evenly over ``n_hosts``."""
        per = self.batch_size // n_hosts
        return {k: v[host_id * per:(host_id + 1) * per] for k, v in batch.items()}

    def batches(self, start_step: int = 0):
        """``(step, batch)`` from ``start_step`` on, without end."""
        step = start_step
        while True:
            yield step, self.batch(step)
            step += 1

    def _chain(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        tok = rng.integers(0, self.cfg.vocab, size=(b,))
        choices = rng.integers(0, self.branching, size=(b, s))
        out = np.empty((b, s), np.int32)
        for t in range(s):
            tok = self._succ[tok, choices[:, t]]
            out[:, t] = tok
        return out


def to_device(batch: dict[str, np.ndarray],
              device: torch.device | str) -> dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: ids as int64, floats (a VLM's
    ``patch_embeds``) as they are."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if v.dtype.kind == "f"
                else torch.from_numpy(np.ascontiguousarray(v)).long()).to(device)
            for k, v in batch.items()}
