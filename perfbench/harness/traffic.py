"""What every traffic generator shares: a request, log-normal lengths at
fixed quantiles, and prompt ids drawn from the run's seed.

A mix (``traffic/<mix>.json``) names its ``kind``; the module
``traffic/<kind>.py`` turns the mix's parameters into the run's requests
and drives the engine with them (``closed_loop.py``).  Lengths are
log-normal (``median``, ``sigma``), rounded and clamped to ``[min, max]``.

Every seed runs the same work, so that a run's spread is the system's and
not the sample's: a generator takes lengths (and any arrival times) at the
distributions' quantiles, in one fixed arrangement drawn once from
``ARRANGEMENT_SEED``, and lets the run's seed draw every prompt's token ids
(no two prompts share a prefix) and the order in which the arrangement is
dealt.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

from perfbench.harness.weights import stream_seed

ARRANGEMENT_SEED = 20240301      # the mixes' one arrangement of lengths and arrivals


@dataclasses.dataclass(frozen=True)
class Req:
    """One request: its index in the run, prompt and output lengths, and
    the client that sends it (-1: none)."""

    idx: int
    prompt_len: int
    max_new: int
    client: int = -1


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the log-normal's quantiles ``(i + 0.5) / n``,
    rounded and clamped, ascending."""
    nd = NormalDist()
    vals = [spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf((i + 0.5) / n))
            for i in range(n)]
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def residual_lengths(lengths: np.ndarray, n: int) -> np.ndarray:
    """``n`` quantiles of the remaining output of a request in progress at a
    random moment: a request of length L is caught with odds in proportion
    to L, at each of its L tokens alike, so P(R = r) = #{L >= r} / sum(L)."""
    top = int(lengths.max())
    counts = np.bincount(lengths, minlength=top + 1)
    at_least = counts[::-1].cumsum()[::-1][1:]             # #{L >= r}, r = 1..top
    cdf = np.cumsum(at_least) / lengths.sum()
    qs = (np.arange(n) + 0.5) / n
    return (np.searchsorted(cdf, qs) + 1).astype(np.int64)


def prompt_tokens(seed: int, req: Req, vocab: int) -> np.ndarray:
    """Request ``req``'s prompt ids, drawn from the seed and its index."""
    rng = np.random.default_rng(stream_seed(seed, 11, req.idx))
    return rng.integers(0, vocab, req.prompt_len, dtype=np.int64)
