"""Continuous-batching inference engine over Sparse-on-Dense weights.

Twin of :mod:`repro.serving.engine`, every stage: for the attention
families paged decode with FIFO admission, chunked prefill, preemption
with page swapping, copy-on-write prefix sharing, speculative decoding and
the persistent prefix cache; for the recurrent families (``hybrid``,
``ssm``) the slot-state regime.

One :class:`Engine` owns a fixed number of *slots* (rows of the batched
decode step) and admits and evicts requests every step, so sequences of
different lengths join and leave the running batch continuously — the
regime where compressed weights pay off most, since decode is bound by the
weight bytes and every slot shares the one packed copy.

The KV cache is a pool of fixed-size pages per layer
(:func:`repro_torch.models.transformer.transformer_init_paged_pool`, updated
in place) with a host-side refcounted allocator
(:class:`repro_torch.serving.pool.PagePool`) and one block table per slot.
The recurrent families keep O(1) state a sequence instead: one batched
decode cache of ``max_slots`` rows (``model.init_cache``), admission
replays the prompt through the batch-1 decode step from a zeroed cache and
writes that state into the sequence's slot
(:func:`repro_torch.models.cache.write_slot`), and the batched decode step
runs every slot at its own position; idle and finished rows ride along
with whatever state their slot holds, which the next admission
overwrites.  Chunked prefill, preemption, prefix sharing, the prefix cache
and speculative decoding are paged-KV features, which the engine refuses
for these families, as the reference does.  For the attention families
every feature is off by default and composes with every other:

* **chunked prefill** (``prefill_chunk=C``): admission places a sequence in
  the *prefilling* state and one C-token chunk of its prompt runs per
  engine step, interleaved with the running batch's decode steps; its
  write cutoff stays 0 (every decode write of its row goes to the trash
  page) until its final chunk delivers the first token;
* **preemption with page swapping** (``preemption=True``): admission needs
  only the prompt's pages, and under pool pressure the youngest decoding
  sequence's pages are copied to host memory (torch CPU tensors) and freed;
  swapped sequences resume ahead of any newcomer, their KV written back
  byte for byte at fresh page ids;
* **prefix sharing** (``prefix_sharing=True``, needs chunked prefill): a
  trie over page-sized prompt chunks (:class:`~repro_torch.serving.pool.
  PrefixTrie`) maps shared prefixes to refcounted pages, admission maps
  them into the block table and prefill skips their positions; a write
  into a shared page copy-on-write forks it first;
* **speculative decoding** (``spec_k=k`` with ``draft_params``, a second,
  sparser pack of the same weights): every decoding slot drafts k tokens
  with the cheap tier (its KV in a parallel pool addressed by the same
  page ids), one batched verify pass scores the k + 1 window with the
  target weights, the longest matching draft prefix plus one target token
  is committed and pages past the new position roll back.  Emitted tokens
  are always the target's argmax; a preempted slot's speculative pages
  are trimmed, never swapped, and its draft KV is dropped;
* **the persistent prefix cache** (``prefix_cache_budget`` /
  ``prefix_cache_dir``, needs prefix sharing): completed prompts'
  trie-held pages stay resident under an LRU byte budget, demote to host
  memory and optionally disk (:class:`~repro_torch.serving.prefix_cache.
  PrefixCache`), and are promoted back at admission instead of prefilled.

:meth:`Engine.step` is a phase pipeline: admission (resume swapped, admit
what fits) → prefill (chunk ticks) → capacity (page growth, preempting under
pressure) → draft window and verify, or decode → commit and rollback.

Greedy tokens equal per-request static serving (:func:`static_generate`):
padded or masked positions contribute exact zeros, shared pages hold the
bytes the sharer's own prefill would write, swapped and cached pages come
back byte for byte, the matmul kernels take their K splits from one M block
whatever M is, and on the card torch's reductions and einsums in RMSNorm
and attention keep a row's bits at the shapes compared here (one row
against ``max_slots`` at decode, ``max_slots × (k + 1)`` rows at verify, a
prompt against its page bucket or its chunks at prefill), which
``tests/test_torch_cuda.py`` holds.  That last part is the libraries'
behaviour at those shapes, not a guarantee of the code; on the CPU, float32
decode attention over a longer cache may differ in the last bits.  A tied
LM head is one cuBLAS GEMM, at one row in static serving and ``max_slots``
(or ``max_slots × (k + 1)``) rows here, and is not held row-invariant
either, so two logits within a rounding of each other can break an argmax
tie the other way.  An untied head is a packed operand like any projection:
it runs the SoD kernel, whose rows are equal across M by design (the K
splits come from one M block; fault C3 in ``ROADMAP.md``).  The MoE
family's router and shared gate are dense cuBLAS GEMMs held row-invariant
at these shapes the same way (``scripts/serve_probe.py invariance``).  One
exception is the reference's own: MoE routing is batch-global, so when an
expert's capacity (at least 128 slots a forward) overflows, an engine
batch can drop other tokens than a batch-1 run, and the engine can then
differ from :func:`static_generate`.  A forward of at most 128 tokens
drops none: an expert takes at most one assignment a token.

Tensors live on the device of the model's parameters.  Block tables,
positions, tokens and write cutoffs are kept in numpy on the host and go up
as one int64 tensor a step; a draft window keeps its proposals on the
device and reads them back once, with the verify pass's tokens.  The
reference's ``jax.jit`` objects are plain callables here;
:meth:`Engine.warmup` runs each step shape once (which builds the kernels
and their launch plans) and is timed apart from steady state.
"""
from __future__ import annotations

import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.launch import steps as steps_mod
from repro_torch.models import cache as cache_mod
from repro_torch.models.model import LM, RECURRENT
from repro_torch.serving.pool import PagePool, PoolExhausted, PrefixTrie
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import Request, Scheduler, SeqPhase, SeqState

Params = dict[str, Any]
_SIDES = ("k", "v")


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


# The page movers work in place on the port's (L, n_pages, page, KV, hd)
# pool, whose page axis is 1 (the reference's is 2 of (G, P, n_pages, ...)).
def _pool_write_pages(pool: Params, cache: Params, page_ids: torch.Tensor) -> None:
    """Scatter a whole prefill's KV into pages ``page_ids`` of every layer's
    pool, in one shot: page j of the bucketed prompt (positions
    [j·page, (j+1)·page)) lands in pool page ``page_ids[j]``.  ``cache`` is
    the prefill's (L, 1, S, KV, hd) with S = len(page_ids)·page."""
    for name in _SIDES:
        pl, cl = pool[name], cache[name]
        pl[:, page_ids] = cl[:, 0].reshape(cl.shape[0], -1, pl.shape[2],
                                           *cl.shape[-2:])


def _pool_copy_page(pool: Params, src: int, dst: int) -> None:
    """Copy-on-write fork: duplicate page ``src`` into ``dst`` across every
    layer's pool."""
    for name in _SIDES:
        pool[name][:, dst] = pool[name][:, src]


def _pool_gather_pages(pool: Params, page_ids: torch.Tensor) -> Params:
    """Swap-out: a copy of pages ``page_ids`` of every layer's pool,
    (L, n_ids, page, KV, hd) a side."""
    return {name: pool[name][:, page_ids] for name in _SIDES}


def _pool_scatter_pages(pool: Params, kv: Params, page_ids: torch.Tensor) -> None:
    """Swap-in: write a gathered snapshot back at (fresh) page ids."""
    for name in _SIDES:
        pool[name][:, page_ids] = kv[name]


def _pool_get_page(pool: Params, page_id: int) -> Params:
    """Cache demotion: one page of every layer's pool, (L, page, KV, hd) a
    side — views into the pool, which the prefix cache copies to the host."""
    return {name: pool[name][:, page_id] for name in _SIDES}


def _pool_set_page(pool: Params, kv: Params, page_id: int) -> None:
    """Cache promotion: write one host-restored page's KV into a freshly
    allocated page of every layer's pool."""
    for name in _SIDES:
        pool[name][:, page_id] = kv[name]


def _param_device(params: Params) -> torch.device:
    return params["embed"].device


class Engine:
    """Continuous-batching engine: paged KV pool + request scheduler +
    ragged batched decode over one shared (optionally SoD-packed) model.

    With ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) every step runs
    under it, so each packed product runs as this rank's local problem
    (:mod:`repro_torch.runtime.spmd`); every rank of the mesh runs the
    engine on the same requests, with ``params`` whole or placed
    (:func:`repro_torch.runtime.sharding.place`), and gets the same
    tokens."""

    def __init__(self, model: LM, params: Params, *, max_slots: int = 4,
                 page_size: int = 16, max_len: int = 256,
                 n_pages: int | None = None, plan=None, mesh=None,
                 prefill_chunk: int | None = None,
                 preemption: bool = False, prefix_sharing: bool = False,
                 spec_k: int = 0, draft_params: Params | None = None,
                 draft_plan=None, prefix_cache_budget: int = 0,
                 prefix_cache_dir: str | None = None, tracer=None):
        family = model.cfg.family
        if family in ("vlm", "audio"):
            raise NotImplementedError(
                f"engine serves token-in/token-out families; {family!r} "
                "needs frontend plumbing (prefix embeds / codebook stacks)")
        self.paged = family not in RECURRENT
        if not self.paged and (prefill_chunk or preemption or prefix_sharing
                               or prefix_cache_budget or prefix_cache_dir):
            raise ValueError(
                f"family {family!r} keeps O(1) recurrent state per slot; "
                "chunked prefill / preemption / prefix sharing / the prefix "
                "cache are paged-KV scheduler features")
        if prefix_sharing and not prefill_chunk:
            raise ValueError(
                "prefix sharing needs chunked prefill (prefill_chunk=...): "
                "admission skips shared positions, so prefill must be able "
                "to start mid-prompt")
        if (prefix_cache_budget or prefix_cache_dir) and not prefix_sharing:
            raise ValueError(
                "the prefix cache retains trie-held prompt pages: pass "
                "prefix_sharing=True (and prefill_chunk=...) to enable it")
        self.spec_k = int(spec_k or 0)
        if self.spec_k and not self.paged:
            raise ValueError(
                f"family {family!r} keeps O(1) recurrent state per slot; "
                "speculative decoding verifies windows against the paged KV "
                "cache")
        if self.spec_k and draft_params is None:
            raise ValueError(
                "spec_k > 0 needs draft_params — a second (aggressively "
                "compressed) pack of the same weights")
        self.model = model
        self.params = params
        self.plan = plan
        self.mesh = mesh
        self.draft_params = draft_params
        self.draft_plan = draft_plan
        self.device = _param_device(params)
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        self.preemption = bool(preemption)
        self.prefix_sharing = bool(prefix_sharing)
        self.tracer = tracer if tracer is not None else obs.get_tracer()
        self.metrics = obs.Metrics()
        self.sched = Scheduler(max_slots, tracer=self.tracer)
        self._step_idx = 0
        self._submitted: list[Request] = []
        self._first_seen: dict[int, float] = {}
        self._finished: dict[int, SeqState] = {}
        self._step_s: list[float] = []
        self.preempt_log: list[int] = []      # rids in eviction order
        # a dict-compatible view of the metrics registry's counter table
        self.stats = self.metrics.stats_view()
        self.stats.update({
            "warmup_s": 0.0, "prefill_chunks": 0, "preemptions": 0,
            "swapped_out_pages": 0, "swapped_in_pages": 0, "cow_forks": 0,
            "shared_prompt_pages": 0, "prompt_pages_total": 0,
            "prompt_pages_fresh": 0, "spec_windows": 0,
            "draft_proposed": 0, "draft_accepted": 0,
            "spec_rollbacks": 0, "spec_rollback_pages": 0,
            "spec_window_preemptions": 0,
            "prefix_hits": 0, "prefix_misses": 0, "prefix_hbm_hits": 0,
            "prefix_host_hits": 0, "prefix_disk_hits": 0,
            "prefix_restored_pages": 0, "prefix_demotions_host": 0,
            "prefix_demotions_disk": 0, "reprefill_tokens_saved": 0,
            "prefix_bytes_hbm": 0, "prefix_bytes_host": 0,
            "prefix_bytes_disk": 0,
        })
        self._finite = torch.ones((), dtype=torch.bool, device=self.device)
        self._pos = np.zeros(self.max_slots, np.int64)
        self._tok = np.zeros((self.max_slots, 1), np.int64)
        self.prefix_cache: PrefixCache | None = None
        self.page_size = int(page_size)
        if not self.paged:
            # one batched slot cache; admission writes a replayed prompt's
            # state into its slot
            self.cache = model.init_cache(self.max_slots, self.max_len, self.device)
            self._cache_spec = model.cache_spec()
            self._decode = steps_mod.make_decode_step(model, mesh=mesh, plan=plan,
                                                      partition=False)
            return

        self._chunk = model.cfg.attn_chunk
        # a draft window probes up to spec_k positions past a sequence's
        # lifetime; the wider block tables keep those (trash-redirected)
        # lookups in bounds
        self.max_pages = -(-(self.max_len + self.spec_k) // self.page_size)
        if n_pages is None:
            n_pages = 1 + self.max_slots * self.max_pages
        self.page_pool = PagePool(n_pages, self.page_size)
        self.trie = PrefixTrie(self.page_size) if prefix_sharing else None
        self.pool = model.init_paged_pool(n_pages, self.page_size, self.device)
        if prefix_cache_budget or prefix_cache_dir:
            k = self.pool["k"]
            page_nbytes = 2 * (k.numel() // k.shape[1]) * k.element_size()
            self.prefix_cache = PrefixCache(
                self.page_pool, page_nbytes,
                budget_bytes=int(prefix_cache_budget or 0),
                cache_dir=prefix_cache_dir, gather=self._gather_page_host,
                on_page_freed=self.trie.drop)
        self.block_tables = np.full((self.max_slots, self.max_pages),
                                    PagePool.TRASH_PAGE, np.int64)
        # each tier's steps dispatch under its own pack plan
        self._decode = steps_mod.make_paged_decode_step(model, mesh=mesh, plan=plan)
        self._prefill = steps_mod.make_prefill_full(model, mesh=mesh, plan=plan)
        if self.prefill_chunk:
            self._chunk_prefill = steps_mod.make_chunked_prefill_step(model, mesh=mesh,
                                                                      plan=plan)
        if self.spec_k:
            # the draft tier runs the same steps on its own weights; its KV
            # lives in a parallel pool addressed by the same page ids
            self.draft_pool = model.init_paged_pool(n_pages, self.page_size,
                                                    self.device)
            self._verify = steps_mod.make_verify_step(model, mesh=mesh, plan=plan)
            self._draft_decode = steps_mod.make_paged_decode_step(model, mesh=mesh,
                                                                  plan=draft_plan)
            self._draft_prefill = steps_mod.make_prefill_full(model, mesh=mesh,
                                                              plan=draft_plan)
            if self.prefill_chunk:
                self._draft_chunk_prefill = steps_mod.make_chunked_prefill_step(
                    model, mesh=mesh, plan=draft_plan)

    def _up(self, a) -> torch.Tensor:
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
        if not self.paged:
            end = plen + req.max_new - 1
            if end > self.max_len:
                raise ValueError(f"request {req.rid}: needs {end} positions; "
                                 f"engine max_len={self.max_len}")
            self._submitted.append(req)
            self.sched.submit(req)
            return
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
        """Pages the running sequences may still claim via growth (and
        admitted copy-on-write forks).  Without preemption, admission holds
        these back so mid-decode growth never finds the pool empty."""
        r = self._pending_forks()
        for seq in self.sched.active.values():
            r += max(0, self.page_pool.pages_for(self._seq_end(seq))
                     - len(seq.pages))
        return r

    def _pending_forks(self) -> int:
        """Copy-on-write forks admitted but not yet taken: a prefilling
        sequence whose next write lands in a page it still shares will
        claim one fresh page at its next tick."""
        n = 0
        for seq in self.sched.active.values():
            if seq.is_prefilling and seq.pages:
                j = seq.prefilled // self.page_size
                if (j < len(seq.pages)
                        and self.page_pool.ref_count(seq.pages[j]) > 1):
                    n += 1
        return n

    def _share_plan(self, req: Request) -> tuple[list[int], list[str], int, int]:
        """Prefix-trie + cache lookup for a prompt: (shared page ids,
        lower-tier restore keys, prefill start position, fresh pages needed
        now).  The trie walk finds HBM-resident prefix pages; with a prefix
        cache the walk continues through the host and disk tiers, each
        further page-aligned chunk whose token-prefix key is cached being
        promoted at admission instead of prefilled (its page still counts
        as fresh).  A fully shared page-aligned prompt still recomputes its
        last token (the engine needs its logits): when that last page is
        trie-shared the write forks it (one more page), while a restored
        last page is private and is written in place."""
        plen = len(req.tokens)
        shared = self.trie.match(req.tokens) if self.trie is not None else []
        restore: list[str] = []
        if self.prefix_cache is not None:
            ps = self.page_size
            j = len(shared)
            while (j + 1) * ps <= plen:
                key = PrefixCache.key(req.tokens[:(j + 1) * ps])
                if self.prefix_cache.peek(key) is None:
                    break
                restore.append(key)
                j += 1
        start = (len(shared) + len(restore)) * self.page_size
        fresh = self.page_pool.pages_for(plen) - len(shared)
        if start >= plen:                 # fully covered, aligned prompt
            start = plen - 1
            if not restore:
                fresh += 1                # COW fork of the last page
        return shared, restore, start, fresh

    def _can_admit(self, req: Request, share) -> bool:
        """Preemption rule: the prompt's pages fit now (with the forks
        admitted prefills will still take); decode growth later recovers
        pages by preempting.  Reservation rule (no preemption): the pool
        must also cover this request's growth and every running sequence's
        worst-case growth.  ``share`` is the prompt's :meth:`_share_plan`
        with chunked prefill, else None."""
        plen = len(req.tokens)
        end = plen + req.max_new - 1
        if self.prefill_chunk:
            fresh = share[3]
            growth = (self.page_pool.pages_for(end)
                      - self.page_pool.pages_for(plen))
        else:
            fresh = self.page_pool.pages_for(self._bucket(plen))
            growth = self.page_pool.pages_for(self._need(req)) - fresh
        if self.preemption:
            return fresh + self._pending_forks() <= self._headroom()
        return fresh + growth <= self._headroom() - self._reserved_pages()

    # -- cache-aware allocation -----------------------------------------------
    def _headroom(self) -> int:
        """Pages allocatable now plus cache-retained pages whose only holder
        is the cache: those demote on demand, so admission counts them."""
        free = self.page_pool.free_count
        if self.prefix_cache is not None:
            free += self.prefix_cache.reclaimable()
        return free

    def _provide(self, n: int) -> bool:
        """Make ``n`` pages allocatable without preempting anyone, by
        demoting reclaimable cache entries LRU-first.  Returns whether an
        allocation of ``n`` would now succeed."""
        if self.page_pool.can_alloc(n):
            return True
        if self.prefix_cache is not None:
            self.prefix_cache.reclaim(n - self.page_pool.free_count)
        return self.page_pool.can_alloc(n)

    def _alloc_pages(self, n: int) -> list[int]:
        """Allocate ``n`` pages, demoting cache entries under pressure."""
        if n and not self.page_pool.can_alloc(n):
            self._provide(n)
        return self.page_pool.alloc(n)

    def _place(self, req: Request, pages: list[int], **kw) -> SeqState:
        seq = self.sched.place(req, pos=len(req.tokens), pages=pages,
                               ready_wall=self._first_seen[req.rid], **kw)
        self._set_table(seq)
        return seq

    def _set_table(self, seq: SeqState) -> None:
        self.block_tables[seq.slot, :] = PagePool.TRASH_PAGE
        self.block_tables[seq.slot, :len(seq.pages)] = seq.pages

    def _admit_paged(self, req: Request) -> list[tuple[int, int]]:
        """Fused admission: prefill the bucketed prompt in one forward,
        write its KV into fresh pages, emit the first token.  With a draft
        tier its own prefill writes the draft pool's same pages (its logits
        are unused: the first token is the target's)."""
        plen = len(req.tokens)
        bucket = self._bucket(plen)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = req.tokens
        tokens = self._up(padded)
        logits, cache = self._prefill(self.params, tokens)
        self._check_finite(logits[0, :plen])
        first = int(logits[0, plen - 1].argmax())
        n = self.page_pool.pages_for(bucket)
        pages = self.page_pool.alloc(n)
        ids = self._up(pages)
        _pool_write_pages(self.pool, cache, ids)
        if self.spec_k:
            _, dcache = self._draft_prefill(self.draft_params, tokens)
            _pool_write_pages(self.draft_pool, dcache, ids)
        seq = self._place(req, pages, first_token=first)
        self.stats["prompt_pages_total"] += n
        self.stats["prompt_pages_fresh"] += n
        return self._post_admit(seq)

    def _admit_state(self, req: Request) -> list[tuple[int, int]]:
        """Recurrent admission: replay the prompt through the batch-1
        decode step from a zeroed cache (as :func:`static_generate` does),
        emit the first token, and write the state into the slot."""
        prompt = self._up(np.asarray(req.tokens)[None])
        sub = self.model.init_cache(1, self.max_len, self.device)
        for t in range(prompt.shape[1]):
            nxt, logits, sub = self._decode(self.params, sub, prompt[:, t:t + 1], t)
        self._check_finite(logits)
        seq = self.sched.place(req, pos=prompt.shape[1],
                               first_token=int(nxt.reshape(-1)[0]), pages=[],
                               ready_wall=self._first_seen[req.rid])
        cache_mod.write_slot(self.cache, sub, self._cache_spec, seq.slot)
        return self._post_admit(seq)

    def _gather_page_host(self, page: int) -> Params:
        """One page's KV for the prefix cache's demotion (views on the
        device; the cache copies them to the host)."""
        return _pool_get_page(self.pool, page)

    def _restore_prefix(self, keys: list[str]) -> list[int]:
        """Promote cached chunks back into the pool: one fresh page a key
        (demoting colder cache entries under pressure), the host or disk
        bytes written in.  Stops at the first miss, or at a snapshot whose
        shape or dtype is not this pool's (a cache dir written for another
        model); the remaining chunks prefill normally."""
        k = self.pool["k"]
        expect = k.shape[:1] + k.shape[2:]
        pages: list[int] = []
        for key in keys:
            got = self.prefix_cache.fetch(key)
            if got is None:
                break
            kv, tier = got
            if any(kv[n].shape != expect or kv[n].dtype != k.dtype for n in _SIDES):
                break
            (pg,) = self._alloc_pages(1)
            _pool_set_page(self.pool, {n: kv[n].to(self.device) for n in _SIDES}, pg)
            self.stats["prefix_host_hits" if tier == "host"
                       else "prefix_disk_hits"] += 1
            self.stats["prefix_restored_pages"] += 1
            pages.append(pg)
        return pages

    def _admit_chunked(self, req: Request, share) -> list[tuple[int, int]]:
        """Admit into the prefilling state: map shared prefix pages, promote
        lower-tier cached chunks, allocate the rest; :meth:`_prefill_tick`
        advances one chunk per step and no token is emitted until the final
        chunk.  Restored pages hold complete KV, so they register in the
        trie at once and never count as fresh prompt pages.  ``share`` is the
        prompt's :meth:`_share_plan`."""
        plen = len(req.tokens)
        shared, restore, _, _ = share
        total = self.page_pool.pages_for(plen)
        if shared:
            # retain before any cache reclaim runs: a shared page now has a
            # sequence's reference, so demotions cannot free it
            self.page_pool.retain(shared)
        hbm_hits = 0
        if self.prefix_cache is not None:
            hbm_hits = sum(1 for p in shared if self.prefix_cache.held(p))
            # leaf-first LRU touch keeps parents younger than children
            for p in reversed(shared):
                self.prefix_cache.touch(p)
        restored = (self._restore_prefix(restore)
                    if self.prefix_cache is not None and restore else [])
        # coverage from what promoted (a corrupt disk file ends the chain)
        start = min((len(shared) + len(restored)) * self.page_size, plen - 1)
        fresh = self._alloc_pages(total - len(shared) - len(restored))
        pages = list(shared) + restored + fresh
        seq = self._place(req, pages, prefilled=start)
        if restored:
            self.trie.register(req.tokens, pages, len(shared) + len(restored))
        self.stats["shared_prompt_pages"] += len(shared)
        self.stats["prompt_pages_total"] += total
        self.stats["prompt_pages_fresh"] += total - len(shared) - len(restored)
        if self.prefix_cache is not None:
            seq.cached_prompt_pages = hbm_hits + len(restored)
            if seq.cached_prompt_pages:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_hbm_hits"] += hbm_hits
                self.stats["reprefill_tokens_saved"] += (
                    self.page_size * seq.cached_prompt_pages)
            else:
                self.stats["prefix_misses"] += 1
        return []

    def _post_admit(self, seq: SeqState) -> list[tuple[int, int]]:
        seq.first_token_wall = time.perf_counter()
        self._pos[seq.slot] = seq.pos
        self._tok[seq.slot, 0] = seq.generated[-1]
        events = [(seq.req.rid, seq.generated[-1])]
        if seq.remaining == 0:               # max_new == 1: done at prefill
            self._complete(seq.slot)
        return events

    def _drop_from_trie(self, freed: list[int]) -> None:
        if self.trie is not None:
            for p in freed:
                self.trie.drop(p)

    def _complete(self, slot: int) -> None:
        seq = self.sched.release(slot)
        seq.done_wall = time.perf_counter()
        self.metrics.observe("queue_wait_s", seq.admitted_wall - seq.ready_wall)
        self.metrics.observe("ttft_s", seq.first_token_wall - seq.ready_wall)
        self.metrics.observe("tpot_s", (seq.done_wall - seq.first_token_wall)
                             / max(len(seq.generated) - 1, 1))
        if self.paged:
            if self.prefix_cache is not None:
                self._cache_hold(seq)
            self._drop_from_trie(self.page_pool.free(seq.pages))
            self.block_tables[slot, :] = PagePool.TRASH_PAGE
        self._pos[slot] = 0
        self._tok[slot, 0] = 0
        self._finished[seq.req.rid] = seq

    def _cache_hold(self, seq: SeqState) -> None:
        """Retain the completed sequence's trie-resident prompt chain in the
        cache, leaf-first, so every parent ends more recently used than its
        children and LRU demotions peel chains leaf-first.  The chain is the
        canonical trie pages, keyed by the full token prefix through each
        chunk."""
        tokens = seq.req.tokens
        matched = self.trie.match(tokens)
        ps = self.page_size
        for j in range(len(matched) - 1, -1, -1):
            self.prefix_cache.hold(PrefixCache.key(tokens[:(j + 1) * ps]),
                                   matched[j])

    # -- chunked prefill ------------------------------------------------------
    def _try_capacity(self, n: int) -> bool:
        """Make ``n`` pages allocatable, demoting cache entries first and
        then preempting youngest-first when allowed.  Returns False when no
        victim is left (one holding only shared pages frees nothing).
        Without preemption, pressure here is an invariant violation: the
        reservation rule of admission is supposed to make it impossible."""
        while not self._provide(n):
            if not self.preemption:
                raise PoolExhausted(
                    "invariant violation: admission reserved too few pages "
                    "(decode growth or copy-on-write fork)")
            victim = self.sched.preemption_victim()
            if victim is None:
                return False
            self._preempt(victim)
        return True

    def _ensure_exclusive(self, seq: SeqState, lo: int, hi: int) -> bool:
        """Copy-on-write: before writing cache positions [lo, hi), fork any
        page in that range the sequence shares.  Returns False when a fork
        cannot get a page even after preemption (the caller waits a step)."""
        for j in range(lo // self.page_size, (hi - 1) // self.page_size + 1):
            pid = seq.pages[j]
            if self.page_pool.ref_count(pid) > 1:
                if not self._try_capacity(1):
                    return False
                if self.page_pool.ref_count(pid) == 1:
                    # making room preempted the only other sharer: the page
                    # is private now, write in place
                    continue
                new = self.page_pool.fork(pid)
                _pool_copy_page(self.pool, pid, new)
                if self.spec_k:
                    # the draft tier addresses the same page ids
                    _pool_copy_page(self.draft_pool, pid, new)
                seq.pages[j] = new
                self.block_tables[seq.slot, j] = new
                self.stats["cow_forks"] += 1
        return True

    def _prefill_tick(self, seq: SeqState) -> list[tuple[int, int]]:
        """Advance one C-token chunk of a prefilling sequence; the final
        chunk (zero-padded past the prompt) yields the first token.  With a
        draft tier the same chunk also prefills the draft pool (its logits
        are unused)."""
        c = self.prefill_chunk
        req = seq.req
        plen = len(req.tokens)
        start = seq.prefilled
        end = min(start + c, plen)
        if not self._ensure_exclusive(seq, start, end):
            return []                  # no page for the fork yet: wait
        chunk = np.zeros((1, c), np.int64)
        chunk[0, :end - start] = req.tokens[start:end]
        row, chunk = self._up(self.block_tables[seq.slot][None]), self._up(chunk)
        logits, self.pool = self._chunk_prefill(self.params, self.pool, row,
                                                chunk, start, plen)
        if self.spec_k:
            _, self.draft_pool = self._draft_chunk_prefill(
                self.draft_params, self.draft_pool, row, chunk, start, plen)
        seq.prefilled = end
        self.stats["prefill_chunks"] += 1
        self._check_finite(logits[0, :end - start])
        if self.trie is not None:
            self.trie.register(req.tokens, seq.pages, end // self.page_size)
        if end < plen:
            return []
        seq.generated.append(int(logits[0, plen - 1 - start].argmax()))
        seq.pos = plen
        self.sched.set_phase(seq, SeqPhase.DECODING)
        return self._post_admit(seq)

    # -- preemption / swapping ------------------------------------------------
    def _trim(self, seq: SeqState) -> list[int] | None:
        """Return the pages past the committed prefix ``[0, pos)`` to the
        pool (refcounted, so a page the trie or a sharer still maps stays).
        Returns the pages that freed, or None when the sequence held none
        past its prefix."""
        keep = self.page_pool.pages_for(seq.pos)
        if len(seq.pages) <= keep:
            return None
        freed = self.page_pool.trim(seq.pages[keep:])
        self._drop_from_trie(freed)
        del seq.pages[keep:]
        self.block_tables[seq.slot, keep:] = PagePool.TRASH_PAGE
        return freed

    def _preempt(self, seq: SeqState) -> None:
        """Copy the sequence's pages to host memory and free them; the
        scheduler queues it for resume ahead of pending newcomers.

        Speculative pages (grown past the committed prefix for a draft
        window) are trimmed first, never swapped: their KV is uncommitted.
        The draft pool's KV of the swapped pages is dropped with them; after
        resume the draft re-builds it as decode goes on, which can lower
        acceptance but never changes a token."""
        if self.spec_k and seq.phase is SeqPhase.DECODING:
            freed = self._trim(seq)
            if freed is not None:
                self.stats["spec_window_preemptions"] += 1
                self.stats["spec_rollback_pages"] += len(freed)
        n = len(seq.pages)
        host = {name: t.cpu() for name, t in
                _pool_gather_pages(self.pool, self._up(seq.pages)).items()}
        seq.host_kv = (host, n)
        freed = self.page_pool.swap_out(seq.pages)
        self._drop_from_trie(freed)
        slot = seq.slot
        seq.pages = []
        self.block_tables[slot, :] = PagePool.TRASH_PAGE
        self._pos[slot] = 0
        self._tok[slot, 0] = 0
        self.sched.preempt(slot)
        self.preempt_log.append(seq.req.rid)
        self.stats["preemptions"] += 1
        # pages that left the device: a shared prefix page another sequence
        # still maps stays resident
        self.stats["swapped_out_pages"] += len(freed)

    def _swap_in(self, seq: SeqState) -> None:
        """Restore a preempted sequence: fresh pages, its KV bytes exact."""
        host, n = seq.host_kv
        pages = self.page_pool.swap_in(n)
        _pool_scatter_pages(self.pool, {name: t.to(self.device)
                                        for name, t in host.items()},
                            self._up(pages))
        seq.host_kv = None
        seq.pages = pages
        self.sched.place_swapped(seq)
        self._set_table(seq)
        self._pos[seq.slot] = seq.pos
        self._tok[seq.slot, 0] = seq.generated[-1]
        self.stats["swapped_in_pages"] += n

    # -- capacity -------------------------------------------------------------
    def _phase_capacity(self) -> None:
        """Grow every decoding sequence's pages out to the span the coming
        step writes: position ``pos`` for decode, ``[pos, min(pos + spec_k,
        seq_end - 1)]`` for a draft window (positions past ``seq_end`` go to
        the trash page).  Under pressure, preemption evicts the youngest
        decoding sequence (possibly the needy one itself, re-checked per
        slot); without preemption, pressure is an invariant violation."""
        for slot in sorted(self.sched.active):
            seq = self.sched.active.get(slot)
            if seq is None or seq.phase is not SeqPhase.DECODING:
                continue
            need = self.page_pool.pages_for(
                min(seq.pos + self.spec_k + 1, self._seq_end(seq)))
            if need <= len(seq.pages):
                # an in-place write must be exclusive: only complete prompt
                # pages are shared, and decode writes land past them
                page = seq.pages[seq.pos // self.page_size]
                assert self.page_pool.ref_count(page) == 1, (
                    f"decode write into shared page {page}")
                continue
            ok = self._try_capacity(need - len(seq.pages))
            if self.sched.active.get(slot) is not seq:
                continue                     # the hunt preempted seq itself
            if not ok:
                raise PoolExhausted(
                    "pool exhausted with no preemptible sequence — the pool "
                    "cannot hold even one request")
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

    # -- decode / speculative window -----------------------------------------
    def _phase_decode(self, decoding: dict[int, SeqState]) -> list[tuple[int, int]]:
        """One ragged batched decode step; every decoding slot commits one
        token.  Prefilling and idle rows ride along with write cutoff 0
        (paged) or with whatever state their slot holds (recurrent)."""
        if self.paged:
            bt, tok, pos, valid = self._decode_inputs(self._valid_lens())
            nxt, logits, self.pool = self._decode(self.params, self.pool, bt, tok,
                                                  pos, valid)
        else:
            state = self._up(np.concatenate([self._tok, self._pos[:, None]], 1))
            nxt, logits, self.cache = self._decode(self.params, self.cache,
                                                   state[:, 0:1], state[:, 1])
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

    def _trim_spec_pages(self, seq: SeqState) -> None:
        """Roll back the pages of rejected window positions (see
        :meth:`_trim`).  Stale KV past ``pos`` needs no scrubbing: the next
        window writes each position before any row attends to it."""
        freed = self._trim(seq)
        if freed is not None:
            self.stats["spec_rollbacks"] += 1
            self.stats["spec_rollback_pages"] += len(freed)

    def _spec_window(self, decoding: dict[int, SeqState]) -> list[tuple[int, int]]:
        """One propose / verify / accept window for every decoding slot.

        The draft tier runs ``spec_k`` batched decode steps ahead (its KV
        in the draft pool) and one more that only lays down the draft KV of
        position ``pos + k``, which a full acceptance commits; then one
        batched verify pass scores ``[committed token, d_1, ..., d_k]`` with
        the target weights.  Per slot the longest draft prefix matching the
        target's greedy tokens is accepted plus one target token, so every
        emission is the target's argmax; rejected positions' pages roll
        back.  Prefilling slots ride along with write cutoff 0.  The
        proposals stay on the device; drafts and the target's tokens are
        read back once."""
        k = self.spec_k
        bt, tok, pos, valid = self._decode_inputs(self._valid_lens())
        d_tok, cols = tok, []
        with self.tracer.span("draft", track="spec", k=k, slots=len(decoding)):
            for j in range(k + 1):
                nxt, _, self.draft_pool = self._draft_decode(
                    self.draft_params, self.draft_pool, bt, d_tok, pos + j, valid)
                d_tok = nxt.reshape(self.max_slots, 1)
                cols.append(d_tok)
        with self.tracer.span("verify", track="spec", k=k, slots=len(decoding)):
            drafts = torch.cat(cols[:k], 1)
            nxt, logits, self.pool = self._verify(
                self.params, self.pool, bt, torch.cat([tok, drafts], 1), pos,
                valid)
            self._check_finite(logits[list(decoding)])
            both = torch.cat([drafts, nxt.reshape(self.max_slots, k + 1)], 1)
            both = both.cpu().numpy()
        drafts, target = both[:, :k], both[:, k:]

        events: list[tuple[int, int]] = []
        for slot, seq in list(decoding.items()):
            m = 0
            while m < k and drafts[slot, m] == target[slot, m]:
                m += 1
            e = min(m + 1, seq.remaining)
            emitted = [int(target[slot, i]) for i in range(e)]
            seq.generated.extend(emitted)
            seq.pos += e
            seq.spec_proposed += k
            seq.spec_accepted += min(m, e)
            self.stats["spec_windows"] += 1
            self.stats["draft_proposed"] += k
            self.stats["draft_accepted"] += min(m, e)
            self._pos[slot] = seq.pos
            self._tok[slot, 0] = emitted[-1]
            events += [(seq.req.rid, t) for t in emitted]
            if seq.remaining == 0:
                self._complete(slot)
            else:
                self._trim_spec_pages(seq)
        return events

    def _check_finite(self, logits: torch.Tensor) -> None:
        """Fold whether these real rows' logits are all finite into one
        flag on the device (read once, at the end of :meth:`run`)."""
        self._finite &= torch.isfinite(logits).all()

    # -- stepping: the per-step phase pipeline --------------------------------
    def _phase_admission(self, now: int) -> list[tuple[int, int]]:
        """Resume swapped sequences first (they were admitted before anyone
        still pending), then admit queue heads, in arrival order, while a
        slot and pages are free.  Fused admission emits the first token now;
        chunked admission leaves the slot prefilling."""
        now_wall = time.perf_counter()
        # the latency clock starts when a request becomes admissible, not
        # when it reaches the queue head
        for r in self.sched.pending:
            if r.arrival > now:
                break                        # pending is arrival-sorted
            self._first_seen.setdefault(r.rid, now_wall)
        while self.paged and self.sched.swapped and self.sched.has_free_slot():
            seq = self.sched.peek_swapped()
            if not self._provide(seq.host_kv[1]):
                break
            self._swap_in(seq)
        events: list[tuple[int, int]] = []
        while self.sched.has_free_slot() and not self.sched.swapped:
            req = self.sched.peek_ready(now)
            if req is None:
                break
            if not self.paged:
                events += self._admit_state(req)
                continue
            # one trie walk per attempt, shared by the check and the admission
            share = self._share_plan(req) if self.prefill_chunk else None
            if not self._can_admit(req, share):
                break
            events += (self._admit_chunked(req, share) if self.prefill_chunk
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
        """Advance virtual time one step: admission → prefill (chunk ticks)
        → capacity (page growth, preempting under pressure) → draft window
        and verify, or decode.  Returns (rid, token) emissions."""
        tr = self.tracer
        t0 = time.perf_counter()
        with tr.span("step", track="engine", step=self._step_idx):
            with tr.span("admission", track="engine"):
                events = self._phase_admission(self._step_idx)
            if self.prefill_chunk:
                with tr.span("prefill", track="engine"):
                    events += self._phase_prefill()
            if self.paged:
                with tr.span("capacity", track="engine"):
                    self._phase_capacity()
            decoding = {slot: seq for slot, seq in self.sched.active.items()
                        if seq.phase is SeqPhase.DECODING}
            if decoding and self.spec_k:
                with tr.span("spec_window", track="engine"):
                    events += self._spec_window(decoding)
            elif decoding:
                with tr.span("decode", track="engine"):
                    events += self._phase_decode(decoding)
            if self.paged:
                self._sample_pool()
        self._step_s.append(time.perf_counter() - t0)
        self._step_idx += 1
        return events

    def _sample_pool(self) -> None:
        """Record page-pool occupancy (free / live / swapped) as gauges and,
        when tracing, one sample on the ``pool`` counter track."""
        occ = self.page_pool.occupancy()
        swapped = sum(s.host_kv[1] for s in self.sched.swapped
                      if s.host_kv is not None)
        self.metrics.gauge("pool_free_pages", occ["free"])
        self.metrics.gauge("pool_live_pages", occ["live"])
        self.metrics.gauge("pool_swapped_pages", swapped)
        if self.prefix_cache is not None:
            self.metrics.gauge("pool_cached_pages",
                               len(self.prefix_cache.held_pages))
            self._sync_cache_stats()
        if self.tracer.enabled:
            self.tracer.counter("pool_pages", {"free": occ["free"],
                                               "live": occ["live"],
                                               "swapped": swapped},
                                track="pool")

    def _sync_cache_stats(self) -> None:
        """Mirror the cache's tier accounting into the stats."""
        c = self.prefix_cache
        tiers = c.bytes_by_tier()
        self.stats["prefix_bytes_hbm"] = tiers["hbm"]
        self.stats["prefix_bytes_host"] = tiers["host"]
        self.stats["prefix_bytes_disk"] = tiers["disk"]
        self.stats["prefix_demotions_host"] = c.demotions_host
        self.stats["prefix_demotions_disk"] = c.demotions_disk

    def flush_prefix_cache(self) -> None:
        """Demote every resident cache entry (the drain path).  On an idle
        engine this leaves the pool fully free and the trie empty; host and
        disk copies persist, so the same prompts later (or in a fresh engine
        on the same cache dir) still promote instead of prefilling."""
        if self.prefix_cache is not None:
            self.prefix_cache.flush()
            self._sync_cache_stats()

    # -- warmup / run ---------------------------------------------------------
    def warmup(self) -> float:
        """Run every step shape the queued trace and the feature set reach
        once — the prefill buckets (or the chunk shape) with their page
        writes, on both tiers; the batched decode with every row cut off;
        the draft decode and the verify window; a copy-on-write page copy,
        a swap gather and scatter and a cache page get and set — so the
        kernels and their launch plans are built before steady state is
        timed.  Only the trash page is written; no other engine state
        changes.  A recurrent engine runs the batch-1 step on a cache of its
        own and the batched step on a copy of the slot cache."""
        with self.tracer.span("warmup", track="engine"):
            t0 = time.perf_counter()
            if not self.paged:
                tok = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
                sub = self.model.init_cache(1, self.max_len, self.device)
                self._decode(self.params, sub, tok, 0)
                scratch = cache_mod.write_slot(
                    self.model.init_cache(self.max_slots, self.max_len, self.device),
                    sub, self._cache_spec, 0)
                state = self._up(np.concatenate([self._tok, self._pos[:, None]], 1))
                self._decode(self.params, scratch, state[:, 0:1], state[:, 1])[0].cpu()
                dt = time.perf_counter() - t0
                self.stats["warmup_s"] += dt
                return dt
            tiers = [(self.params, self.pool, "")]
            if self.spec_k:
                tiers.append((self.draft_params, self.draft_pool, "_draft"))
            for params, pool, tier in tiers:
                if self.prefill_chunk:
                    trash_row = np.full((1, self.max_pages), PagePool.TRASH_PAGE)
                    getattr(self, f"{tier}_chunk_prefill")(
                        params, pool, self._up(trash_row),
                        self._up(np.zeros((1, self.prefill_chunk))), 0, 0)
                else:
                    prefill = getattr(self, f"{tier}_prefill")
                    for b in sorted({self._bucket(len(r.tokens))
                                     for r in self.sched.pending}):
                        _, cache = prefill(params, self._up(np.zeros((1, b))))
                        trash = np.full(b // self.page_size, PagePool.TRASH_PAGE)
                        _pool_write_pages(pool, cache, self._up(trash))
            trash = PagePool.TRASH_PAGE
            if self.prefix_sharing:
                _pool_copy_page(self.pool, trash, trash)
            if self.prefix_cache is not None:
                _pool_set_page(self.pool, _pool_get_page(self.pool, trash), trash)
            if self.preemption:
                ids = self._up(np.full(self.max_pages, trash))
                snap = {n: t.cpu() for n, t in
                        _pool_gather_pages(self.pool, ids).items()}
                _pool_scatter_pages(self.pool, {n: t.to(self.device)
                                                for n, t in snap.items()}, ids)
            inputs = self._decode_inputs(np.zeros(self.max_slots, np.int64))
            out = self._decode(self.params, self.pool, *inputs)
            if self.spec_k:
                bt, tok, pos, valid = inputs
                self._draft_decode(self.draft_params, self.draft_pool, *inputs)
                window = torch.zeros((self.max_slots, self.spec_k + 1),
                                     dtype=torch.int64, device=self.device)
                out = self._verify(self.params, self.pool, bt, window, pos, valid)
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
        if self.preemption:
            max_steps *= 2               # slack for swap cycles
        t0 = time.perf_counter()
        n_tok = 0
        start = self._step_idx
        first_step = len(self._step_s)
        while not self.sched.done:
            if self._step_idx - start > max_steps:
                raise RuntimeError(
                    f"engine stalled: {len(self.sched.pending)} pending / "
                    f"{len(self.sched.active)} active / "
                    f"{len(self.sched.swapped)} swapped after {max_steps} steps")
            n_tok += len(self.step())
        if self.prefix_cache is not None:
            # the last completions' demotions ran inside the last step
            self._sync_cache_stats()
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
            "acceptance_rate": round(self.stats["draft_accepted"]
                                     / max(self.stats["draft_proposed"], 1), 4),
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
def static_generate(model: LM, params: Params, req: Request,
                    plan=None) -> list[int]:
    """Per-request static greedy generation — the reference the engine must
    match token for token: the static serve path at batch 1 (fused prefill
    of the bare prompt and the cache grown to prompt + ``max_new``
    positions, or for a recurrent family the prompt replayed through the
    decode step from a zeroed cache; then scalar-position decode steps),
    dispatched under ``plan``."""
    return _static_generate(model, params, req, plan=plan)


def mesh_static_generate(model: LM, params: Params, req: Request, mesh) -> list[int]:
    """:func:`static_generate` through the steps of ``mesh`` (the rank's
    placed ``params``): the reference ``Engine(mesh=)`` must match token
    for token, so the steps run whole rows as the engine's do
    (``partition=False``).  :func:`static_generate` keeps the reference's
    signature, which has no mesh."""
    return _static_generate(model, params, req, mesh=mesh)


def _static_generate(model: LM, params: Params, req: Request, plan=None,
                     mesh=None) -> list[int]:
    device = _param_device(params)
    prompt = torch.as_tensor(np.asarray(req.tokens, np.int64), device=device)[None]
    plen = prompt.shape[1]
    decode = steps_mod.make_decode_step(model, mesh=mesh, plan=plan, partition=False)
    if model.cfg.family in RECURRENT:
        cache = model.init_cache(1, plen + req.max_new, device)
        for t in range(plen):
            nxt, _, cache = decode(params, cache, prompt[:, t:t + 1], t)
    else:
        nxt, cache = steps_mod.make_prefill_step(model, mesh=mesh, plan=plan,
                                                 partition=False)(params, prompt)
        cache = model.grow_cache(cache, plen + req.max_new)
    out = [int(nxt.reshape(-1)[0])]
    tok = nxt.reshape(1, 1)
    for t in range(req.max_new - 1):
        nxt, _, cache = decode(params, cache, tok, plen + t)
        out.append(int(nxt.reshape(-1)[0]))
        tok = nxt.reshape(1, 1)
    return out
