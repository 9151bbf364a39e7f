"""Synthetic request traces for the serving engine.

Copy of :mod:`repro.serving.trace` (stdlib and numpy only), so the port imports
nothing of the reference package.

Arrivals follow a Poisson process on the engine's *step* clock (exponential
inter-arrival times at ``rate`` requests/step, accumulated and floored), so
a trace replays deterministically for a given seed regardless of wall-clock
speed — the property the engine-vs-static equality gates rely on.  Prompt
and generation lengths are drawn uniformly from ``[max//2, max]``, giving
the ragged mix (staggered arrivals, mixed lengths) continuous batching
exists to serve.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.scheduler import Request


def poisson_trace(
    n_requests: int,
    rate: float,
    max_prompt: int,
    max_new: int,
    vocab: int,
    seed: int = 0,
) -> list[Request]:
    """``n_requests`` requests with Poisson(``rate``/step) arrivals."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    arrivals = np.floor(np.cumsum(rng.exponential(1.0 / rate, n_requests))
                        ).astype(int)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(max(1, max_prompt // 2), max_prompt + 1))
        gen = int(rng.integers(max(1, max_new // 2), max_new + 1))
        reqs.append(Request(
            rid=i,
            tokens=rng.integers(0, vocab, plen, dtype=np.int32),
            max_new=gen,
            arrival=int(arrivals[i]),
        ))
    return reqs


def shared_prefix_trace(
    n_requests: int,
    prefix_len: int,
    max_prompt: int,
    max_new: int,
    vocab: int,
    seed: int = 0,
    arrival_gap: int = 1,
) -> list[Request]:
    """Requests sharing one common prompt prefix — the few-shot-template
    workload prefix sharing exists for.

    Every prompt is the same ``prefix_len`` tokens followed by a
    per-request random suffix (lengths drawn from
    ``[max(prefix_len + 1, max_prompt // 2), max_prompt]``); arrivals are
    spaced ``arrival_gap`` engine steps apart, so earlier requests'
    prefix pages are prefilled (and trie-registered) before later ones
    look them up.  Deterministic for a given seed.
    """
    if not 0 < prefix_len < max_prompt:
        raise ValueError(
            f"need 0 < prefix_len < max_prompt, got {prefix_len} / "
            f"{max_prompt}")
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len, dtype=np.int32)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(max(prefix_len + 1, max_prompt // 2),
                                max_prompt + 1))
        suffix = rng.integers(0, vocab, plen - prefix_len, dtype=np.int32)
        gen = int(rng.integers(max(1, max_new // 2), max_new + 1))
        reqs.append(Request(
            rid=i,
            tokens=np.concatenate([prefix, suffix]),
            max_new=gen,
            arrival=i * arrival_gap,
        ))
    return reqs


def repeated_prompt_trace(
    n_requests: int,
    prefix_len: int,
    suffix_len: int,
    max_new: int,
    vocab: int,
    page_size: int,
    seed: int = 0,
    arrival_gap: int = 1,
    rid_base: int = 0,
) -> list[Request]:
    """One epoch of the prefix-cache workload: page-aligned prompts that
    repeat *verbatim* across epochs.

    Every prompt is the same ``prefix_len``-token system prompt plus a
    per-request ``suffix_len``-token suffix, with the total forced to a
    multiple of ``page_size``.  Page alignment is what lets a repeated
    prompt resolve entirely from cached pages on its second epoch: a
    prompt's unaligned tail page is never trie-registered, so it would
    re-prefill every time.  Calling twice with the same seed and a
    different ``rid_base`` yields two identical epochs with fresh request
    ids — the workload behind the second-epoch zero-fresh-prefill gate
    (``docs/caching.md``).  Deterministic for a given seed.
    """
    if prefix_len < 1 or suffix_len < 1:
        raise ValueError(
            f"need prefix_len >= 1 and suffix_len >= 1, got {prefix_len} / "
            f"{suffix_len}")
    if (prefix_len + suffix_len) % page_size:
        raise ValueError(
            f"prompt length {prefix_len + suffix_len} must be a multiple of "
            f"page_size={page_size} — unaligned tail pages never register "
            "in the trie, so the repeated epoch could not hit the cache")
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len, dtype=np.int32)
    reqs = []
    for i in range(n_requests):
        suffix = rng.integers(0, vocab, suffix_len, dtype=np.int32)
        reqs.append(Request(
            rid=rid_base + i,
            tokens=np.concatenate([prefix, suffix]),
            max_new=max_new,
            arrival=i * arrival_gap,
        ))
    return reqs


def stress_spec_trace(
    n_requests: int,
    prefix_len: int,
    max_prompt: int,
    max_new: int,
    vocab: int,
    seed: int = 0,
    burst: int = 2,
    rate: float = 0.5,
) -> list[Request]:
    """High-pressure trace for the fully composed engine: shared prompt
    prefixes + bursty Poisson arrivals + mixed prompt lengths.

    Requests land in bursts of ``burst`` simultaneous arrivals, with
    Poisson(``rate``/step) gaps *between* bursts — bursts pile admission
    pressure onto a small pool (forcing preemption mid-window) while the
    shared ``prefix_len``-token prefix exercises the trie under
    speculative rollback.  Prompt lengths are drawn uniformly from
    ``[prefix_len + 1, max_prompt]`` (full mix, not the ``max//2`` floor
    of :func:`poisson_trace` — short and long prompts must coexist in one
    chunked-prefill schedule).  Deterministic for a given seed.
    """
    if not 0 < prefix_len < max_prompt:
        raise ValueError(
            f"need 0 < prefix_len < max_prompt, got {prefix_len} / "
            f"{max_prompt}")
    if burst < 1 or rate <= 0:
        raise ValueError(f"need burst >= 1 and rate > 0, got {burst} / "
                         f"{rate}")
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len, dtype=np.int32)
    reqs = []
    arrival = 0
    for i in range(n_requests):
        if i and i % burst == 0:
            arrival += max(1, int(rng.exponential(1.0 / rate)))
        plen = int(rng.integers(prefix_len + 1, max_prompt + 1))
        suffix = rng.integers(0, vocab, plen - prefix_len, dtype=np.int32)
        gen = int(rng.integers(max(1, max_new // 2), max_new + 1))
        reqs.append(Request(
            rid=i,
            tokens=np.concatenate([prefix, suffix]),
            max_new=gen,
            arrival=arrival,
        ))
    return reqs
