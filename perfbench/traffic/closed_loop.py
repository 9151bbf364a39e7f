"""closed_loop: ``clients`` callers, each sending its next request as soon
as its last one completes, with no think time: an offline batch job that
keeps a fixed number of requests in flight.

A kind module gives the harness two things, found by the mix's ``kind``:

* ``Plan(mix, seed, seconds, vocab)``: the run's requests, with
  ``prompt_lengths()`` (every prompt length the run can send: the shapes
  set-up warms) and ``tokens(req)`` (a prompt's ids);
* ``drive(served)``: the set-up the traffic needs, then the window, through
  :class:`perfbench.harness.serve.Served`'s ``send``, ``step``,
  ``open_window``, ``in_window`` and ``mark``.

The mix's parameters: ``clients``; ``prompt_len`` and ``output_len``
(log-normal: ``median``, ``sigma``, ``min``, ``max``); ``cycle``.  Client
``c``'s first request has a prompt at the log-normal's quantile and an
output at the quantile of the length-biased residual (completions are
staggered from the start); its later requests cycle through a row of
``cycle`` (prompt, output) pairs, the quantiles of ``clients x cycle``
draws.  The seed deals the clients their rows and draws the token ids, so
every seed's engine does the same steps, prefills and completions.

Set-up sends every client's first request and steps the engine until each
has its first token (the fill); the window starts then.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.harness.traffic import (ARRANGEMENT_SEED, Req, prompt_tokens,
                                       quantile_lengths, residual_lengths)
from perfbench.harness.weights import stream_seed


class Plan:
    """The requests of one run of a closed-loop mix, from ``seed``."""

    def __init__(self, mix: dict, seed: int, seconds: float, vocab: int):
        self.seed, self.vocab = int(seed), vocab
        p, o = mix["prompt_len"], mix["output_len"]
        c, cyc = mix["clients"], mix["cycle"]
        fixed = np.random.default_rng(ARRANGEMENT_SEED)
        first_p = fixed.permutation(quantile_lengths(p, c))
        first_o = fixed.permutation(residual_lengths(quantile_lengths(o, c * cyc), c))
        rows_p = fixed.permutation(quantile_lengths(p, c * cyc)).reshape(c, cyc)
        rows_o = fixed.permutation(quantile_lengths(o, c * cyc)).reshape(c, cyc)
        deal = np.random.default_rng(stream_seed(seed, 10)).permutation(c)
        self.first = [Req(i, int(first_p[deal[i]]), int(first_o[deal[i]]), i)
                      for i in range(c)]
        self._rows = [list(zip(rows_p[deal[i]].tolist(), rows_o[deal[i]].tolist()))
                      for i in range(c)]
        self._sent = [0] * c
        self._next_idx = c

    def next_closed(self, client: int) -> Req:
        """Client ``client``'s next request after its first (its row, cycled)."""
        row = self._rows[client]
        plen, new = row[self._sent[client] % len(row)]
        self._sent[client] += 1
        self._next_idx += 1
        return Req(self._next_idx - 1, plen, new, client)

    def prompt_lengths(self) -> set[int]:
        """Every prompt length this run can send (the shapes to warm)."""
        return {r.prompt_len for r in self.first} | {a for row in self._rows for a, _ in row}

    def tokens(self, req: Req) -> np.ndarray:
        return prompt_tokens(self.seed, req, self.vocab)


def _step(served) -> None:
    """One engine step; each client whose request completed sends its next."""
    done = served.step()
    with served.mark("pb:harness"):
        for rid in done:
            served.send(served.plan.next_closed(served.tracks[rid].req.client))


def drive(served) -> None:
    t = time.perf_counter()
    for r in served.plan.first:
        served.send(r)
    first = [served.tracks[r.idx] for r in served.plan.first]
    while any(not tr.times for tr in first):
        _step(served)
    served.split["fill_s"] = time.perf_counter() - t
    served.open_window()
    while served.in_window():
        _step(served)
