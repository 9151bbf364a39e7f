"""Host-side page accounting for the paged KV cache.

Copy of :mod:`repro.serving.pool` (stdlib and numpy only), so the port imports
nothing of the reference package.

The device half of the paged cache is a plain pytree of page arrays
(:func:`repro_torch.models.attention.init_paged_pool` stacked per layer); this
module owns the *allocation* half: a free list of page ids plus the
invariants the engine's tests gate on — a page is never handed to two
sequences at once unless both hold an explicit reference, and every page
whose last reference is dropped returns to the pool.

Four capabilities layered on the free list:

* **refcounts** — prefix sharing maps one physical page into several
  sequences' block tables; :meth:`PagePool.retain` adds a reference and
  :meth:`PagePool.free` only recycles a page when its count hits zero.
* **copy-on-write forks** — a sequence about to *write* into a page it
  shares calls :meth:`PagePool.fork`: it gets a fresh private page id and
  drops its reference on the shared one (the engine copies the page's
  device bytes alongside).
* **swap accounting** — preemption moves a sequence's pages to host
  memory: :meth:`PagePool.swap_out` releases the ids (tallying how many
  actually left the device) and :meth:`PagePool.swap_in` re-allocates on
  resume.  The byte movement itself is the engine's job; the pool keeps
  the id bookkeeping and the counters CI gates on.
* **cache-tier retention** — the persistent prefix cache
  (:class:`repro_torch.serving.prefix_cache.PrefixCache`) keeps completed
  prompt pages alive past sequence completion by holding one extra
  reference per retained page.  To the pool it is just another sharer:
  demotions go through :meth:`PagePool.free` (so a page shared with a
  live sequence stays resident), and the partition invariant
  ``free + live == n_pages - 1`` is untouched.  Retained pages whose
  only holder is the cache are *reclaimable* — admission counts them as
  free-able capacity and demotes them on demand (``docs/caching.md``).

Page 0 is reserved as the trash page: inactive engine slots point their
whole block table at it so their (ignored) per-step writes can never touch
a live sequence.  The allocator never hands it out.
"""
from __future__ import annotations

import collections
import dataclasses


class PoolExhausted(RuntimeError):
    """No free pages left — the trace needs a bigger pool (or admission
    should back off / preempt, which the engine's scheduler does)."""


class PagePool:
    """Refcounted free-list allocator over ``n_pages`` fixed-size KV pages."""

    TRASH_PAGE = 0

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: collections.deque[int] = collections.deque(
            range(1, n_pages))
        self._refs: dict[int, int] = {}
        self.swapped_out_pages = 0
        self.swapped_in_pages = 0
        self.forks = 0
        self.trimmed_pages = 0

    @property
    def free_count(self) -> int:
        """Pages currently available to :meth:`alloc`."""
        return len(self._free)

    @property
    def allocated(self) -> frozenset[int]:
        """Ids of every page currently held (refcount >= 1)."""
        return frozenset(self._refs)

    def ref_count(self, page: int) -> int:
        """Holders of ``page`` (0 = free); >1 means prefix-shared."""
        return self._refs.get(page, 0)

    def occupancy(self) -> dict[str, int]:
        """Free vs live (refcount >= 1) page counts — one gauge sample.

        The engine records this each step onto the ``pool`` counter track
        and the ``pool_free_pages`` / ``pool_live_pages`` gauges.
        """
        return {"free": len(self._free), "live": len(self._refs)}

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache positions."""
        return -(-int(n_tokens) // self.page_size)

    def can_alloc(self, n: int) -> bool:
        """Whether :meth:`alloc` of ``n`` pages would succeed right now."""
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` pages off the free list.  All-or-nothing."""
        if n > len(self._free):
            raise PoolExhausted(
                f"asked for {n} pages, {len(self._free)} free "
                f"(pool of {self.n_pages})")
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            assert p not in self._refs, f"page {p} double-allocated"
            self._refs[p] = 1
        return pages

    def retain(self, pages: list[int]) -> None:
        """Add one reference per page (prefix sharing: a second sequence
        maps an already-live page into its block table)."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"retaining unallocated page {p}")
            self._refs[p] += 1

    def free(self, pages: list[int]) -> list[int]:
        """Drop one reference per page; pages whose count hits zero return
        to the free list and are reported back (so the engine can drop
        their prefix-trie entries).  Freeing a page that is not currently
        allocated (double free, or the reserved trash page) raises."""
        freed = []
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"freeing unallocated page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
                freed.append(p)
        return freed

    def trim(self, pages: list[int]) -> list[int]:
        """Roll back speculatively grown pages (rejected draft-window
        positions, or draft state dropped on preemption).  Identical to
        :meth:`free` — refcounted, so trimming a sharer's reference on a
        prefix page another sequence (or the trie) still maps never
        recycles it — but tallied separately so the serving bench can
        gate that rollbacks actually happened."""
        freed = self.free(pages)
        self.trimmed_pages += len(freed)
        return freed

    def fork(self, page: int) -> int:
        """Copy-on-write fork: exchange the caller's reference on a shared
        ``page`` for a fresh private page id.  The caller must copy the
        device bytes itself before writing.  Forking a page the caller
        holds exclusively is a bug (just write in place)."""
        if self.ref_count(page) < 2:
            raise ValueError(
                f"fork of page {page} with refcount {self.ref_count(page)} "
                "— copy-on-write only applies to shared pages")
        (new,) = self.alloc(1)
        self._refs[page] -= 1
        self.forks += 1
        return new

    # -- preemption / swapping ------------------------------------------------
    def swap_out(self, pages: list[int]) -> list[int]:
        """Release a preempted sequence's pages.  Returns the ids that
        actually left the device (refcount hit zero) — shared prefix pages
        another sequence still references stay resident."""
        freed = self.free(pages)
        self.swapped_out_pages += len(freed)
        return freed

    def swap_in(self, n: int) -> list[int]:
        """Re-allocate ``n`` pages for a sequence resuming from host
        memory."""
        pages = self.alloc(n)
        self.swapped_in_pages += len(pages)
        return pages


# ---------------------------------------------------------------------------
# prefix sharing
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _TrieNode:
    tokens: tuple[int, ...]
    page: int
    parent: "_TrieNode | None"
    children: dict[tuple[int, ...], "_TrieNode"] = dataclasses.field(
        default_factory=dict)


class PrefixTrie:
    """Trie over page-sized prompt token chunks → live KV page ids.

    Each node keys one full page worth of tokens (children are hashed by
    the token tuple, so lookup is exact — no collision risk) and records
    the page holding that chunk's KV.  A chain root→node therefore names a
    shared prompt prefix whose KV is entirely resident; admission walks
    the new prompt down the trie and maps every matched page straight into
    the block table (:meth:`PagePool.retain`).

    The trie holds **no references of its own**: a node exists only while
    its page is allocated to at least one holder, and the engine calls
    :meth:`drop` for every page the pool reports as actually freed.
    Because every sharer references its *whole* prefix chain, a parent's
    refcount never falls below a child's — drops cascade leaf-first and a
    dangling interior node is unreachable by construction.

    The prefix cache preserves that ordering: it touches each completed
    chain leaf-first so a parent is always more recently used than every
    child, and its LRU demotions therefore also drop leaf-first (see
    ``docs/caching.md``).
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._root = _TrieNode(tokens=(), page=PagePool.TRASH_PAGE,
                               parent=None)
        self._by_page: dict[int, _TrieNode] = {}

    def __len__(self) -> int:
        return len(self._by_page)

    def _chunks(self, tokens) -> list[tuple[int, ...]]:
        ps = self.page_size
        n_full = len(tokens) // ps
        return [tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
                for j in range(n_full)]

    def match(self, tokens) -> list[int]:
        """Longest registered prefix of ``tokens`` at whole-page
        granularity; returns the matched page ids in chain order."""
        node, out = self._root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            out.append(child.page)
            node = child
        return out

    def register(self, tokens, pages: list[int], upto_page: int) -> None:
        """Record that ``pages[:upto_page]`` hold the KV of the first
        ``upto_page`` full pages of ``tokens`` (i.e. their prefill is
        complete).  Existing nodes win — if another sequence already
        registered a chunk, its page stays the canonical shared copy."""
        node = self._root
        for j, chunk in enumerate(self._chunks(tokens)[:upto_page]):
            child = node.children.get(chunk)
            if child is None:
                page = pages[j]
                if page in self._by_page:      # page already names a chunk
                    break
                child = _TrieNode(tokens=chunk, page=page, parent=node)
                node.children[chunk] = child
                self._by_page[page] = child
            node = child

    def drop(self, page: int) -> None:
        """Forget a freed page's node (no-op for unregistered pages)."""
        node = self._by_page.pop(page, None)
        if node is not None and node.parent is not None:
            if node.parent.children.get(node.tokens) is node:
                del node.parent.children[node.tokens]
