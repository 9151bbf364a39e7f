"""Continuous-batching inference engine over Sparse-on-Dense weights.

Twin of :mod:`repro.serving.engine` for the attention family, stages 1 and
half of 2 of its port: paged decode with FIFO admission (the prompt prefilled
in one fused forward at admission) and chunked prefill (``prefill_chunk=C``).

One :class:`Engine` owns a fixed number of *slots* (rows of the batched
decode step) and admits and evicts requests every step, so sequences of
different lengths join and leave the running batch continuously — the
regime where compressed weights pay off most, since decode is bound by the
weight bytes and every slot shares the one packed copy.

The KV cache is a pool of fixed-size pages per layer
(:func:`repro_torch.models.transformer.transformer_init_paged_pool`, updated
in place) with a host-side refcounted allocator
(:class:`repro_torch.serving.pool.PagePool`) and one block table per slot.
With chunked prefill, admission places a sequence in the *prefilling* state
and one C-token chunk of its prompt runs per engine step, interleaved with
the running batch's decode steps; its write cutoff stays 0 (every decode
write of its row goes to the trash page) until its final chunk delivers the
first token.

:meth:`Engine.step` is a phase pipeline: admission → prefill (chunk ticks)
→ capacity (page growth) → decode.  Admission reserves every running
sequence's worst-case page growth, so decode never finds the pool empty.

Greedy tokens equal per-request static serving (:func:`static_generate`):
padded or masked positions contribute exact zeros, the matmul kernels take
their K splits from one M block whatever M is, and on the card torch's
reductions and einsums in RMSNorm and attention keep a row's bits at the
shapes compared here (one row against ``max_slots`` at decode, a prompt
against its page bucket or its chunks at prefill), which
``tests/test_torch_cuda.py`` holds.  That last part is the libraries'
behaviour at those shapes, not a guarantee of the code; on the CPU, float32
decode attention over a longer cache may differ in the last bits.  The tied
LM head is one cuBLAS GEMM, at one row in static serving and ``max_slots``
rows here, and is not held row-invariant either, so two logits within a
rounding of each other can break an argmax tie the other way.

Tensors live on the device of the model's parameters.  Block tables,
positions, tokens and write cutoffs are kept in numpy on the host and go up
as one int64 tensor a decode step.  The reference's ``jax.jit`` objects are
plain callables here; :meth:`Engine.warmup` runs each step shape once (which
builds the kernels and their launch plans) and is timed apart from steady
state.

Not ported yet (each raises ``NotImplementedError`` naming its stage):
preemption with page swapping and copy-on-write prefix sharing (stage 2),
speculative decoding (stage 3), the persistent prefix cache (stage 4).
"""
from __future__ import annotations

import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import LM
from repro_torch.serving.pool import PagePool, PoolExhausted
from repro_torch.serving.scheduler import Request, Scheduler, SeqPhase, SeqState

Params = dict[str, Any]


def bucket_len(plen: int, page_size: int, chunk: int | None = None) -> int:
    """Page-aligned prefill bucket for a prompt of ``plen`` tokens.

    Rounds up to the page size so prompt KV fills whole pages; prompts
    longer than the attention chunk additionally round to a multiple of
    the chunk (``chunked_attention`` requires divisibility there).
    """
    b = -(-plen // page_size) * page_size
    if chunk and b > chunk:
        lcm = math.lcm(page_size, chunk)
        b = -(-plen // lcm) * lcm
    return b


def _pool_write_pages(pool: Params, cache: Params, page_ids: torch.Tensor) -> None:
    """Scatter a whole prefill's KV into pages ``page_ids`` of every layer's
    pool, in place, in one shot: page j of the bucketed prompt (positions
    [j·page, (j+1)·page)) lands in pool page ``page_ids[j]``.  ``cache`` is
    the prefill's (L, 1, S, KV, hd) with S = len(page_ids)·page."""
    for name in ("k", "v"):
        pl, cl = pool[name], cache[name]
        pl[:, page_ids] = cl[:, 0].reshape(cl.shape[0], -1, pl.shape[2],
                                           *cl.shape[-2:])


def _param_device(params: Params) -> torch.device:
    return params["embed"].device


_UNPORTED = {
    "preemption": "stage 2 (preemption with page swapping)",
    "prefix_sharing": "stage 2 (copy-on-write prefix sharing)",
    "spec_k": "stage 3 (speculative decoding)",
    "draft_params": "stage 3 (speculative decoding)",
    "prefix_cache_budget": "stage 4 (the persistent prefix cache)",
    "prefix_cache_dir": "stage 4 (the persistent prefix cache)",
}


class Engine:
    """Continuous-batching engine: paged KV pool + request scheduler +
    ragged batched decode over one shared (optionally SoD-packed) model."""

    def __init__(self, model: LM, params: Params, *, max_slots: int = 4,
                 page_size: int = 16, max_len: int = 256,
                 n_pages: int | None = None, prefill_chunk: int | None = None,
                 preemption: bool = False, prefix_sharing: bool = False,
                 spec_k: int = 0, draft_params: Params | None = None,
                 prefix_cache_budget: int = 0,
                 prefix_cache_dir: str | None = None):
        asked = {"preemption": preemption, "prefix_sharing": prefix_sharing,
                 "spec_k": spec_k, "draft_params": draft_params is not None,
                 "prefix_cache_budget": prefix_cache_budget,
                 "prefix_cache_dir": prefix_cache_dir}
        for flag, on in asked.items():
            if on:
                raise NotImplementedError(
                    f"engine {flag}: not ported yet — engine "
                    f"{_UNPORTED[flag]} is still open in ROADMAP.md, queue A "
                    "item 2")
        self.model = model
        self.params = params
        self.device = _param_device(params)
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        self.tracer = obs.get_tracer()
        self.metrics = obs.Metrics()
        self.sched = Scheduler(max_slots, tracer=self.tracer)
        self._step_idx = 0
        self._submitted: list[Request] = []
        self._first_seen: dict[int, float] = {}
        self._finished: dict[int, SeqState] = {}
        self._step_s: list[float] = []
        # a dict-compatible view of the metrics registry's counter table
        self.stats = self.metrics.stats_view()
        self.stats.update({"warmup_s": 0.0, "prefill_chunks": 0,
                           "prompt_pages_total": 0})
        self._finite = torch.ones((), dtype=torch.bool, device=self.device)
        self._pos = np.zeros(self.max_slots, np.int64)
        self._tok = np.zeros((self.max_slots, 1), np.int64)

        self.page_size = int(page_size)
        self._chunk = model.cfg.attn_chunk
        self.max_pages = -(-self.max_len // self.page_size)
        if n_pages is None:
            n_pages = 1 + self.max_slots * self.max_pages
        self.page_pool = PagePool(n_pages, self.page_size)
        self.pool = model.init_paged_pool(n_pages, self.page_size, self.device)
        self.block_tables = np.full((self.max_slots, self.max_pages),
                                    PagePool.TRASH_PAGE, np.int64)
        self._decode = steps_mod.make_paged_decode_step(model)
        self._prefill = steps_mod.make_prefill_full(model)
        if self.prefill_chunk:
            self._chunk_prefill = steps_mod.make_chunked_prefill_step(model)

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """A host int array as an int64 tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(self.device)

    # -- admission ------------------------------------------------------------
    def _bucket(self, plen: int) -> int:
        return bucket_len(plen, self.page_size, self._chunk)

    def _need(self, req: Request) -> int:
        """Cache positions the request holds pages for over its lifetime:
        its prefill bucket (or bare prompt, chunked) and its last write."""
        plen = len(req.tokens)
        end = plen + req.max_new - 1
        return end if self.prefill_chunk else max(self._bucket(plen), end)

    def submit(self, req: Request) -> None:
        """Queue a request, validating it can ever fit this engine
        (prompt + generation budget within ``max_len`` and the page
        pool); admission happens later, when a slot and pages free up."""
        plen = len(req.tokens)
        if self.prefill_chunk and self._chunk and plen > self._chunk:
            raise ValueError(
                f"request {req.rid}: prompt of {plen} tokens exceeds "
                f"attn_chunk={self._chunk}; chunked prefill's single-block "
                "attention is only bit-identical to the fused reference for "
                "prompts within one attention chunk")
        need = self._need(req)
        pages = self.page_pool.pages_for(need)
        if need > self.max_len or pages > self.page_pool.n_pages - 1:
            raise ValueError(
                f"request {req.rid}: needs {need} positions / {pages} pages; "
                f"engine max_len={self.max_len}, pool={self.page_pool.n_pages}")
        self._submitted.append(req)
        self.sched.submit(req)

    @staticmethod
    def _seq_end(seq: SeqState) -> int:
        """Last cache position the sequence will ever write, + 1."""
        return len(seq.req.tokens) + seq.req.max_new - 1

    def _reserved_pages(self) -> int:
        """Pages the running sequences may still claim via growth;
        admission holds these back so mid-decode growth never finds the
        pool empty."""
        return sum(max(0, self.page_pool.pages_for(self._seq_end(seq))
                       - len(seq.pages))
                   for seq in self.sched.active.values())

    def _can_admit(self, req: Request) -> bool:
        """Reservation rule: the pool must cover this request's lifetime
        pages and every running sequence's worst-case growth."""
        budget = self.page_pool.free_count - self._reserved_pages()
        return self.page_pool.pages_for(self._need(req)) <= budget

    def _place(self, req: Request, pages: list[int], **kw) -> SeqState:
        seq = self.sched.place(req, pos=len(req.tokens), pages=pages,
                               ready_wall=self._first_seen[req.rid], **kw)
        self.block_tables[seq.slot, :] = PagePool.TRASH_PAGE
        self.block_tables[seq.slot, :len(pages)] = pages
        return seq

    def _admit_paged(self, req: Request) -> list[tuple[int, int]]:
        """Fused admission: prefill the bucketed prompt in one forward,
        write its KV into fresh pages, emit the first token."""
        plen = len(req.tokens)
        bucket = self._bucket(plen)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = req.tokens
        logits, cache = self._prefill(self.params, self._up(padded))
        self._check_finite(logits[0, :plen])
        first = int(logits[0, plen - 1].argmax())
        n = self.page_pool.pages_for(bucket)
        pages = self.page_pool.alloc(n)
        _pool_write_pages(self.pool, cache, self._up(np.asarray(pages)))
        seq = self._place(req, pages, first_token=first)
        self.stats["prompt_pages_total"] += n
        return self._post_admit(seq)

    def _admit_chunked(self, req: Request) -> list[tuple[int, int]]:
        """Admit into the prefilling state with the prompt's pages;
        :meth:`_prefill_tick` advances one chunk per step and no token is
        emitted until the final chunk."""
        total = self.page_pool.pages_for(len(req.tokens))
        self._place(req, self.page_pool.alloc(total), prefilled=0)
        self.stats["prompt_pages_total"] += total
        return []

    def _post_admit(self, seq: SeqState) -> list[tuple[int, int]]:
        seq.first_token_wall = time.perf_counter()
        self._pos[seq.slot] = seq.pos
        self._tok[seq.slot, 0] = seq.generated[-1]
        events = [(seq.req.rid, seq.generated[-1])]
        if seq.remaining == 0:               # max_new == 1: done at prefill
            self._complete(seq.slot)
        return events

    def _complete(self, slot: int) -> None:
        seq = self.sched.release(slot)
        seq.done_wall = time.perf_counter()
        self.metrics.observe("queue_wait_s", seq.admitted_wall - seq.ready_wall)
        self.metrics.observe("ttft_s", seq.first_token_wall - seq.ready_wall)
        self.metrics.observe("tpot_s", (seq.done_wall - seq.first_token_wall)
                             / max(len(seq.generated) - 1, 1))
        self.page_pool.free(seq.pages)
        self.block_tables[slot, :] = PagePool.TRASH_PAGE
        self._pos[slot] = 0
        self._tok[slot, 0] = 0
        self._finished[seq.req.rid] = seq

    # -- chunked prefill ------------------------------------------------------
    def _prefill_tick(self, seq: SeqState) -> list[tuple[int, int]]:
        """Advance one C-token chunk of a prefilling sequence; the final
        chunk (zero-padded past the prompt) yields the first token."""
        c = self.prefill_chunk
        req = seq.req
        plen = len(req.tokens)
        start = seq.prefilled
        end = min(start + c, plen)
        chunk = np.zeros((1, c), np.int64)
        chunk[0, :end - start] = req.tokens[start:end]
        logits, self.pool = self._chunk_prefill(
            self.params, self.pool, self._up(self.block_tables[seq.slot][None]),
            self._up(chunk), start, plen)
        seq.prefilled = end
        self.stats["prefill_chunks"] += 1
        self._check_finite(logits[0, :end - start])
        if end < plen:
            return []
        seq.generated.append(int(logits[0, plen - 1 - start].argmax()))
        seq.pos = plen
        self.sched.set_phase(seq, SeqPhase.DECODING)
        return self._post_admit(seq)

    # -- capacity / decode ----------------------------------------------------
    def _phase_capacity(self) -> None:
        """Grow every decoding sequence's pages out to position ``pos``,
        the one the coming step writes.  The admission reservation makes
        pressure here an invariant violation."""
        for slot, seq in sorted(self.sched.active.items()):
            if seq.phase is not SeqPhase.DECODING:
                continue
            need = self.page_pool.pages_for(min(seq.pos + 1, self._seq_end(seq)))
            if need <= len(seq.pages):
                continue
            if not self.page_pool.can_alloc(need - len(seq.pages)):
                raise PoolExhausted(
                    "invariant violation: admission reserved too few pages "
                    "for decode growth")
            while len(seq.pages) < need:
                (pg,) = self.page_pool.alloc(1)
                seq.pages.append(pg)
                self.block_tables[slot, len(seq.pages) - 1] = pg

    def _valid_lens(self) -> np.ndarray:
        """Per-slot write cutoffs: a decoding slot may write up to its
        ``seq_end``; prefilling and idle slots get 0 (every write goes to
        the trash page), so one batched step spans a partially prefilled
        batch without masking block tables on the host."""
        valid = np.zeros(self.max_slots, np.int64)
        for slot, seq in self.sched.active.items():
            if seq.phase is SeqPhase.DECODING:
                valid[slot] = self._seq_end(seq)
        return valid

    def _decode_inputs(self, valid: np.ndarray):
        """(block tables, tokens, pos, valid_len) on the device, from one
        upload of one (slots, 3 + max_pages) int64 array."""
        state = self._up(np.concatenate(
            [self._tok, self._pos[:, None], valid[:, None], self.block_tables], 1))
        return state[:, 3:], state[:, 0:1], state[:, 1], state[:, 2]

    def _phase_decode(self, decoding: dict[int, SeqState]) -> list[tuple[int, int]]:
        """One ragged batched decode step; every decoding slot commits one
        token.  Prefilling and idle rows ride along with write cutoff 0."""
        bt, tok, pos, valid = self._decode_inputs(self._valid_lens())
        nxt, logits, self.pool = self._decode(self.params, self.pool, bt, tok, pos,
                                              valid)
        self._check_finite(logits[list(decoding)])
        nxt = nxt.reshape(self.max_slots).cpu().numpy()
        events: list[tuple[int, int]] = []
        for slot, seq in list(decoding.items()):
            t = int(nxt[slot])
            seq.generated.append(t)
            seq.pos += 1
            self._pos[slot] = seq.pos
            self._tok[slot, 0] = t
            events.append((seq.req.rid, t))
            if seq.remaining == 0:
                self._complete(slot)
        return events

    def _check_finite(self, logits: torch.Tensor) -> None:
        """Fold whether these real rows' logits are all finite into one
        flag on the device (read once, at the end of :meth:`run`)."""
        self._finite &= torch.isfinite(logits).all()

    # -- stepping: the per-step phase pipeline --------------------------------
    def _phase_admission(self, now: int) -> list[tuple[int, int]]:
        """Admit queue heads, in arrival order, while a slot and pages are
        free.  Fused admission emits the first token now; chunked admission
        leaves the slot prefilling for :meth:`_phase_prefill`."""
        now_wall = time.perf_counter()
        # the latency clock starts when a request becomes admissible, not
        # when it reaches the queue head
        for r in self.sched.pending:
            if r.arrival > now:
                break                        # pending is arrival-sorted
            self._first_seen.setdefault(r.rid, now_wall)
        events: list[tuple[int, int]] = []
        while self.sched.has_free_slot():
            req = self.sched.peek_ready(now)
            if req is None or not self._can_admit(req):
                break
            events += (self._admit_chunked(req) if self.prefill_chunk
                       else self._admit_paged(req))
        return events

    def _phase_prefill(self) -> list[tuple[int, int]]:
        """Advance one chunk for every prefilling slot."""
        events: list[tuple[int, int]] = []
        for seq in list(self.sched.active.values()):
            if seq.phase is SeqPhase.PREFILLING:
                events += self._prefill_tick(seq)
        return events

    def step(self) -> list[tuple[int, int]]:
        """Advance virtual time one step: admission → prefill (chunk
        ticks) → capacity (page growth) → decode.  Returns (rid, token)
        emissions."""
        tr = self.tracer
        t0 = time.perf_counter()
        with tr.span("step", track="engine", step=self._step_idx):
            with tr.span("admission", track="engine"):
                events = self._phase_admission(self._step_idx)
            if self.prefill_chunk:
                with tr.span("prefill", track="engine"):
                    events += self._phase_prefill()
            with tr.span("capacity", track="engine"):
                self._phase_capacity()
            decoding = {slot: seq for slot, seq in self.sched.active.items()
                        if seq.phase is SeqPhase.DECODING}
            if decoding:
                with tr.span("decode", track="engine"):
                    events += self._phase_decode(decoding)
            self._sample_pool()
        self._step_s.append(time.perf_counter() - t0)
        self._step_idx += 1
        return events

    def _sample_pool(self) -> None:
        """Record page-pool occupancy as gauges and, when tracing, one
        sample on the ``pool`` counter track."""
        occ = self.page_pool.occupancy()
        self.metrics.gauge("pool_free_pages", occ["free"])
        self.metrics.gauge("pool_live_pages", occ["live"])
        if self.tracer.enabled:
            self.tracer.counter("pool_pages", {"free": occ["free"],
                                               "live": occ["live"]},
                                track="pool")

    # -- warmup / run ---------------------------------------------------------
    def warmup(self) -> float:
        """Run every step shape the queued trace reaches once — the prefill
        buckets (or the chunk shape) with their page writes, and the batched
        decode with every row cut off — so the kernels and their launch
        plans are built before steady state is timed.  Only the trash page
        is written; no other engine state changes."""
        with self.tracer.span("warmup", track="engine"):
            t0 = time.perf_counter()
            if self.prefill_chunk:
                trash_row = np.full((1, self.max_pages), PagePool.TRASH_PAGE)
                self._chunk_prefill(self.params, self.pool, self._up(trash_row),
                                    self._up(np.zeros((1, self.prefill_chunk))),
                                    0, 0)
            else:
                for b in sorted({self._bucket(len(r.tokens))
                                 for r in self.sched.pending}):
                    _, cache = self._prefill(self.params, self._up(np.zeros((1, b))))
                    trash = np.full(b // self.page_size, PagePool.TRASH_PAGE)
                    _pool_write_pages(self.pool, cache, self._up(trash))
            out = self._decode(self.params, self.pool,
                               *self._decode_inputs(np.zeros(self.max_slots, np.int64)))
            out[0].cpu()
            dt = time.perf_counter() - t0
        self.stats["warmup_s"] += dt
        return dt

    def run(self, requests: list[Request] | None = None) -> dict:
        """Drive the engine until every submitted request completes.

        Returns ``{"tokens": {rid: [...]}, "stats": {...}}`` with warmup time
        reported apart from steady-state throughput (tokens a second over
        the post-warmup serving loop) and the wall time of a step.
        """
        for r in requests or []:
            self.submit(r)
        self.warmup()
        max_steps = (max((r.arrival for r in self._submitted), default=0)
                     + sum(r.max_new for r in self._submitted) + self.max_slots + 16)
        if self.prefill_chunk:
            max_steps += sum(-(-len(r.tokens) // self.prefill_chunk) + 1
                             for r in self._submitted)
        t0 = time.perf_counter()
        n_tok = 0
        start = self._step_idx
        first_step = len(self._step_s)
        while not self.sched.done:
            if self._step_idx - start > max_steps:
                raise RuntimeError(
                    f"engine stalled: {len(self.sched.pending)} pending / "
                    f"{len(self.sched.active)} active after {max_steps} steps")
            n_tok += len(self.step())
        steady_s = time.perf_counter() - t0
        fin = list(self._finished.values())
        lat = [s.done_wall - s.ready_wall for s in fin]
        queue = [s.admitted_wall - s.ready_wall for s in fin]
        ttft = [s.first_token_wall - s.ready_wall for s in fin]
        tpot = [(s.done_wall - s.first_token_wall) / max(len(s.generated) - 1, 1)
                for s in fin]
        step_ms = [1e3 * s for s in self._step_s[first_step:]]

        def _pct(vals: list[float], q: float, digits: int = 6) -> float:
            return round(float(np.percentile(vals, q)), digits) if vals else 0.0

        self.stats.update({
            "steps": self._step_idx - start,
            "completed": len(self._finished),
            "generated_tokens": n_tok,
            "tokens_per_step": round(n_tok / max(self._step_idx - start, 1), 4),
            "steady_s": round(steady_s, 4),
            "steady_tok_per_s": round(n_tok / max(steady_s, 1e-9), 2),
            "p50_latency_s": _pct(lat, 50, 4),
            "p99_latency_s": _pct(lat, 99, 4),
            "queue_wait_p50_s": _pct(queue, 50),
            "queue_wait_p99_s": _pct(queue, 99),
            "ttft_p50_s": _pct(ttft, 50),
            "ttft_p99_s": _pct(ttft, 99),
            "tpot_p50_s": _pct(tpot, 50),
            "tpot_p99_s": _pct(tpot, 99),
            "logits_finite": bool(self._finite),
            "step_ms_p50": _pct(step_ms, 50, 3),
            "step_ms_p99": _pct(step_ms, 99, 3),
        })
        return {"tokens": {rid: list(s.generated)
                           for rid, s in sorted(self._finished.items())},
                "stats": dict(self.stats)}


# ---------------------------------------------------------------------------
# static-batch reference
# ---------------------------------------------------------------------------
def static_generate(model: LM, params: Params, req: Request) -> list[int]:
    """Per-request static greedy generation — the reference the engine must
    match token for token: the static serve path at batch 1 (fused prefill
    of the bare prompt, the cache grown to prompt + ``max_new`` positions,
    scalar-position decode steps)."""
    device = _param_device(params)
    prompt = torch.as_tensor(np.asarray(req.tokens, np.int64), device=device)[None]
    plen = prompt.shape[1]
    prefill = steps_mod.make_prefill_step(model)
    decode = steps_mod.make_decode_step(model)
    nxt, cache = prefill(params, prompt)
    cache = model.grow_cache(cache, plen + req.max_new)
    out = [int(nxt.reshape(-1)[0])]
    tok = nxt.reshape(1, 1)
    for t in range(req.max_new - 1):
        nxt, _, cache = decode(params, cache, tok, plen + t)
        out.append(int(nxt.reshape(-1)[0]))
        tok = nxt.reshape(1, 1)
    return out
