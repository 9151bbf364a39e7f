"""Deterministic synthetic token data — twin of :mod:`repro.data.pipeline`.

The successor table is the reference's (``np.random.default_rng(seed)``),
so both packages walk the same bigram chain.  The walk itself draws from
numpy where the reference draws from ``jax.random``, which torch cannot
reproduce: the two give different tokens for one seed, and parity tests feed
the reference's tokens to both.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
        if self.cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"family {self.cfg.family!r}: only token-only batches are "
                "ported")
        rng = np.random.default_rng(self.seed)
        v = self.cfg.vocab
        # each token has `branching` likely successors
        self._succ = rng.integers(0, v, size=(v, self.branching))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """``{"tokens", "targets"}``, int32 (B, S) each."""
        toks = self._chain(np.random.default_rng(self.seed * 1_000_003 + step),
                           self.batch_size, self.seq_len + 1)
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
