"""Request scheduler: admission queue + slot assignment + preemption.

Copy of :mod:`repro.serving.scheduler` (stdlib and numpy only), so the port imports
nothing of the reference package.

The scheduler owns the *who runs where* state of the engine: a FIFO
admission queue ordered by arrival step, the map of engine slots to
running sequences, the free-slot list, and the queue of sequences
preempted to host memory (swapped out) awaiting resume.  It is
deliberately free of any device state — the engine asks it what to admit,
tells it what completed or got evicted, and keeps the page pool / cache
arrays itself.

Admission capacity is likewise the engine's call: with the persistent
prefix cache enabled, the engine's admission rule counts cache-retained
pages whose only holder is the cache as *reclaimable* — head-of-line
order stays strict, but a queue head blocked only by cold cached pages
admits by demoting them (see ``docs/caching.md``).
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
import time
from typing import Any

import numpy as np

from repro_torch import obs


class SeqPhase(enum.Enum):
    """Lifecycle of a sequence after admission — the single source of
    truth the engine's phase pipeline branches on.

    ``PREFILLING``: chunked prefill in flight, no first token yet — the
    slot takes no decode/draft steps (its write cutoff is 0) and is
    excluded from speculative windows.  ``DECODING``: emitting tokens;
    eligible for decode steps, draft windows, and preemption.
    ``SWAPPED``: preempted to host memory, queued for resume.  ``DONE``:
    released (generation budget exhausted).
    """

    PREFILLING = "prefilling"
    DECODING = "decoding"
    SWAPPED = "swapped"
    DONE = "done"


@dataclasses.dataclass
class Request:
    """One inference request: a prompt and a generation budget.

    ``arrival`` is in engine *steps* (virtual time) — the trace generator
    produces Poisson arrivals on this clock and the engine admits a
    request once its arrival step is reached and a slot + pages are free.
    """

    rid: int
    tokens: np.ndarray            # (S,) int prompt token ids
    max_new: int                  # generation budget (incl. prefill token)
    arrival: int = 0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")

    @property
    def priority(self) -> tuple[int, int]:
        """FIFO priority: earlier arrival (then lower rid) ranks higher.
        Preemption evicts the *lowest*-priority running sequence, i.e. the
        max of this key — the youngest arrival backs off first, so the
        oldest requests always make progress."""
        return (self.arrival, self.rid)


@dataclasses.dataclass
class SeqState:
    """Book-keeping for one running sequence in an engine slot."""

    req: Request
    slot: int
    pos: int                      # next decode cache position to write
    generated: list[int]
    pages: list[int]              # paged families: allocated page ids
    prefilled: int = 0            # prompt tokens whose KV is resident
    phase: SeqPhase = SeqPhase.DECODING
    host_kv: Any = None           # swapped-out KV snapshot (host arrays)
    ready_wall: float = 0.0       # wall clock when first admissible
    admitted_wall: float = 0.0    # wall clock when placed into a slot
    first_token_wall: float = 0.0  # wall clock when the first token exists
    done_wall: float = 0.0
    spec_proposed: int = 0        # draft tokens proposed for this sequence
    spec_accepted: int = 0        # draft tokens that became emitted tokens
    cached_prompt_pages: int = 0  # prompt pages served by the prefix cache
    #                               (HBM holds + host/disk promotions)

    @property
    def remaining(self) -> int:
        """Generation budget left (``max_new`` minus tokens emitted)."""
        return self.req.max_new - len(self.generated)

    @property
    def is_prefilling(self) -> bool:
        """Chunked prefill in flight: no first token yet, so the slot must
        not decode (its per-row write cutoff is 0)."""
        return self.phase is SeqPhase.PREFILLING


class Scheduler:
    """FIFO admission + slot assignment over ``max_slots`` engine slots.

    Head-of-line order is strict: if the oldest admissible request does
    not fit (no slot, or the engine reports no pages), nothing younger
    jumps it — keeps engine-vs-static token equality trivially auditable.
    Sequences preempted under pool pressure queue in ``swapped`` and
    resume ahead of any pending newcomer (they were admitted first).
    """

    def __init__(self, max_slots: int, tracer=None):
        self.max_slots = int(max_slots)
        self.tracer = tracer if tracer is not None else obs.get_tracer()
        self._pending: list[Request] = []      # sorted by (arrival, rid)
        self.active: dict[int, SeqState] = {}  # slot -> running sequence
        self._swapped: list[SeqState] = []     # sorted by priority
        self._free_slots: list[int] = list(range(max_slots))[::-1]

    def set_phase(self, seq: SeqState, phase: SeqPhase) -> None:
        """Move ``seq`` to ``phase``, emitting the transition as an
        instant event on the ``lifecycle`` trace track."""
        seq.phase = phase
        self.tracer.instant(f"rid{seq.req.rid}:{phase.value}",
                            track="lifecycle", cat="phase",
                            rid=seq.req.rid, slot=seq.slot)

    # -- admission queue ------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request for admission, keeping arrival order."""
        bisect.insort(self._pending, req, key=lambda r: r.priority)

    @property
    def pending(self) -> tuple[Request, ...]:
        """Requests awaiting admission, in (arrival, rid) order."""
        return tuple(self._pending)

    @property
    def swapped(self) -> tuple[SeqState, ...]:
        """Preempted sequences awaiting resume, in priority order."""
        return tuple(self._swapped)

    def peek_ready(self, now_step: int) -> Request | None:
        """Oldest request whose arrival step has been reached."""
        if self._pending and self._pending[0].arrival <= now_step:
            return self._pending[0]
        return None

    def has_free_slot(self) -> bool:
        """Whether an engine slot is free for admission/resume."""
        return bool(self._free_slots)

    def place(self, req: Request, *, pos: int, pages: list[int],
              ready_wall: float, first_token: int | None = None,
              prefilled: int = 0) -> SeqState:
        """Admit the queue head into a free slot.  ``first_token=None``
        places the sequence in the prefilling phase (chunked prefill will
        deliver the first token later)."""
        assert self._pending and self._pending[0].rid == req.rid
        self._pending.pop(0)
        slot = self._free_slots.pop()
        seq = SeqState(req=req, slot=slot, pos=pos,
                       generated=[] if first_token is None
                       else [first_token],
                       pages=pages, prefilled=prefilled,
                       phase=(SeqPhase.PREFILLING if first_token is None
                              else SeqPhase.DECODING),
                       ready_wall=ready_wall)
        seq.admitted_wall = time.perf_counter()
        self.active[slot] = seq
        self.tracer.begin(f"req{req.rid}", track=f"slot{slot}",
                          cat="request", rid=req.rid)
        self.set_phase(seq, seq.phase)
        return seq

    def release(self, slot: int) -> SeqState:
        """Eviction on completion: free the slot, hand back the state."""
        seq = self.active.pop(slot)
        self.tracer.end(f"req{seq.req.rid}", track=f"slot{slot}",
                        cat="request")
        self.set_phase(seq, SeqPhase.DONE)
        self._free_slots.append(slot)
        return seq

    # -- preemption -----------------------------------------------------------
    def preemption_victim(self) -> SeqState | None:
        """Lowest-priority *decoding* sequence (youngest arrival, ties by
        rid).  Prefilling sequences are not preempted — their state is
        cheap to hold and they are about to produce their first token."""
        victims = [s for s in self.active.values()
                   if s.phase is SeqPhase.DECODING]
        if not victims:
            return None
        return max(victims, key=lambda s: s.req.priority)

    def preempt(self, slot: int) -> SeqState:
        """Evict a running sequence to the swapped queue; its slot frees
        immediately.  The engine swaps the KV pages to host around this."""
        seq = self.active.pop(slot)
        self.tracer.end(f"req{seq.req.rid}", track=f"slot{slot}",
                        cat="request")
        self.set_phase(seq, SeqPhase.SWAPPED)
        self._free_slots.append(slot)
        bisect.insort(self._swapped, seq, key=lambda s: s.req.priority)
        return seq

    def peek_swapped(self) -> SeqState | None:
        """Highest-priority preempted sequence awaiting resume."""
        return self._swapped[0] if self._swapped else None

    def place_swapped(self, seq: SeqState) -> SeqState:
        """Resume a swapped sequence into a free slot."""
        self._swapped.remove(seq)
        seq.slot = self._free_slots.pop()
        self.active[seq.slot] = seq
        self.tracer.begin(f"req{seq.req.rid}", track=f"slot{seq.slot}",
                          cat="request", rid=seq.req.rid, resumed=True)
        self.set_phase(seq, SeqPhase.DECODING)
        return seq

    @property
    def done(self) -> bool:
        """True when no work remains anywhere (pending/active/swapped)."""
        return (not self._pending and not self.active
                and not self._swapped)
