"""Persistent multi-tier prefix cache: HBM -> host memory -> disk.

Copy of :mod:`repro.serving.prefix_cache` with one change: host and disk
pages are kept as raw bits, without ``ml_dtypes``.  The ``gather`` callback
returns torch tensors; the cache stores each as numpy integers of the same
width (``tensor.view(torch.int16)`` for bf16, ``view(torch.uint8)`` for
fp8) beside the torch dtype's name, and :meth:`PrefixCache.fetch` views the
bits back, so a page round-trips byte for byte.  The disk format is the
port's own; the reference never reads it.

``PrefixTrie`` alone drops a prompt prefix the moment its last
sequence completes, so a popular system prompt re-prefills on every
arrival gap even though the page-swap machinery to keep it is already
built.  :class:`PrefixCache` keeps those trie-held pages alive past
sequence completion and tiers them down a memory hierarchy under an LRU
byte budget:

* **HBM** - the page stays resident in the device pool *and* in the
  trie; the cache holds one pool reference on it, so admission hits it
  through the ordinary trie walk with zero byte movement.  An LRU byte
  budget (``budget_bytes``) bounds this tier.
* **host** - when the budget overflows, the least-recently-used entry is
  *demoted*: its page bytes are gathered to host memory (the same
  per-page snapshot path preemption uses), the cache's pool reference is
  dropped (freeing the page when no live sequence still shares it), and
  the trie forgets the chunk.  A later hit re-allocates a page and
  scatters the bytes back - a *promotion* - skipping the re-prefill.
* **disk** - demotions write through to ``cache_dir/<sha256>.npz`` keyed
  by the *token-prefix content* (not page ids), so a freshly constructed
  engine pointed at the same directory resolves the same prompts with
  zero prefill compute: the cache survives restarts.

The cache owns policy and host/disk storage only.  Device byte movement
is delegated to the ``gather`` callback (the engine's per-page gather),
and page-id bookkeeping stays in ``PagePool`` - the cache is
just another reference holder, so every pool invariant the test suite
gates on (free + live partition, refcount conservation) is unchanged.

Keys cover the *entire* token prefix up to and including a page-sized
chunk, so two prompts sharing a chunk's tokens but differing earlier can
never alias: the KV bytes of chunk *j* depend on all tokens ``< (j+1) *
page_size`` through attention, and the key hashes exactly those tokens.

The reference's ``docs/caching.md`` has the tier diagram, the LRU/touch
ordering rationale, and the counter glossary.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Callable

import numpy as np
import torch

__all__ = ["PrefixCache"]

# the integer type a page's bits are kept in, by element size
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _to_bits(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor's bits on the host, as numpy integers of its element width,
    and the name of its torch dtype.  Always a copy: a CPU tensor may be a
    view into the pool, whose page is about to be reused."""
    t = t.detach().to("cpu", copy=True).contiguous()
    return (t.view(_BITS[t.element_size()]).numpy(),
            str(t.dtype).removeprefix("torch."))


def _from_bits(bits: np.ndarray, dtype: str) -> torch.Tensor:
    """The host tensor whose bits :func:`_to_bits` kept."""
    return torch.from_numpy(np.ascontiguousarray(bits)).view(getattr(torch, dtype))


class PrefixCache:
    """LRU-tiered retention of completed prompt prefix pages.

    Parameters
    ----------
    pool:
        The ``PagePool`` whose pages are being retained.  The cache holds
        at most one reference per page (idempotent ``hold``).
    page_bytes:
        KV bytes of one page across all layers/heads; the unit of the
        LRU budget and of ``bytes_by_tier`` accounting.
    budget_bytes:
        HBM-tier byte budget.  ``0`` keeps nothing resident: every
        ``hold`` demotes immediately (a pure host/disk cache).
    cache_dir:
        Optional directory for the disk tier.  When set, demotions write
        through to ``<sha256(prefix tokens)>.npz`` and a fresh engine
        pointed here inherits the spilled chunks.
    host_budget_bytes:
        Optional cap on the host tier; overflow drops the oldest host
        entries (their disk copies, if any, persist).
    gather:
        ``page_id -> {"k": tensor, "v": tensor}`` snapshot of one live
        page (on any device; the cache copies it to the host).  Called at
        demotion time, while the page is still allocated.
    on_page_freed:
        Called with the page id whenever a demotion actually frees the
        page (refcount hit zero) - the engine passes ``PrefixTrie.drop``
        so the trie never points at a freed page.
    """

    def __init__(
        self,
        pool,
        page_bytes: int,
        *,
        budget_bytes: int = 0,
        cache_dir: str | os.PathLike | None = None,
        host_budget_bytes: int | None = None,
        gather: Callable[[int], dict] | None = None,
        on_page_freed: Callable[[int], None] | None = None,
    ):
        if page_bytes <= 0:
            raise ValueError(f"page_bytes must be positive, got {page_bytes}")
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        self.pool = pool
        self.page_bytes = int(page_bytes)
        self.budget_bytes = int(budget_bytes)
        self.host_budget_bytes = host_budget_bytes
        self.gather = gather
        self.on_page_freed = on_page_freed
        # Insertion order is LRU order: oldest first, most-recent last.
        self._hbm: dict[str, int] = {}
        self._page2key: dict[int, str] = {}
        self._host: dict[str, dict] = {}
        self.cache_dir: Path | None = None
        self._disk_index: set[str] = set()
        self._disk_bytes = 0
        self.demotions_host = 0
        self.demotions_disk = 0
        if cache_dir is not None:
            self.cache_dir = Path(cache_dir)
            self.cache_dir.mkdir(parents=True, exist_ok=True)
            for p in self.cache_dir.glob("*.npz"):
                self._disk_index.add(p.stem)
                self._disk_bytes += p.stat().st_size

    # ------------------------------------------------------------------
    # keys

    @staticmethod
    def key(tokens) -> str:
        """Content hash of a token prefix (sha256 over int64 token bytes).

        The caller passes *all* tokens up to and including the chunk
        being keyed, so the key pins the full attention context of the
        chunk's KV, never just the chunk's own tokens.
        """
        arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int64))
        return hashlib.sha256(arr.tobytes()).hexdigest()

    # ------------------------------------------------------------------
    # HBM tier

    @property
    def held_pages(self) -> tuple[int, ...]:
        """Pages currently retained in the HBM tier, LRU-first."""
        return tuple(self._hbm.values())

    @property
    def host_keys(self) -> tuple[str, ...]:
        """Keys currently resident in the host tier, LRU-first."""
        return tuple(self._host)

    def held(self, page: int) -> bool:
        """True when the cache holds a reference on ``page``."""
        return page in self._page2key

    def hold(self, key: str, page: int) -> None:
        """Retain ``page`` in the HBM tier under ``key`` (idempotent).

        Re-holding a page the cache already tracks is just an LRU touch.
        If ``key`` maps to a *different* page (the chunk was re-prefilled
        at a new page after its old entry became unreachable), the stale
        entry is released first - both pages carry identical bytes, so
        either is a valid cache of the chunk.
        """
        if page in self._page2key:
            self.touch(page)
            return
        stale = self._hbm.get(key)
        if stale is not None:
            del self._hbm[key]
            del self._page2key[stale]
            if self.pool.free([stale]) and self.on_page_freed is not None:
                self.on_page_freed(stale)
        self.pool.retain([page])
        self._hbm[key] = page
        self._page2key[page] = key
        # The HBM copy supersedes any host copy of the same chunk.
        self._host.pop(key, None)
        self._enforce()

    def touch(self, page: int) -> None:
        """Move a held page to the MRU end of the HBM tier."""
        key = self._page2key.get(page)
        if key is not None:
            self._hbm[key] = self._hbm.pop(key)

    def reclaimable(self) -> int:
        """HBM-tier pages only the cache still references.

        These can be demoted on demand to satisfy an allocation, so the
        scheduler's admission budget counts them as free-able capacity.
        """
        return sum(1 for p in self._hbm.values() if self.pool.ref_count(p) == 1)

    def reclaim(self, n: int) -> int:
        """Demote LRU single-reference entries until ``n`` pages freed.

        Returns the number of pages actually freed (may be < ``n`` when
        the HBM tier runs out of reclaimable entries).  Entries shared
        with a live sequence are skipped - demoting them would snapshot
        bytes but free nothing.
        """
        freed = 0
        for key in list(self._hbm):
            if freed >= n:
                break
            if self.pool.ref_count(self._hbm[key]) == 1 and self._demote(key):
                freed += 1
        return freed

    def flush(self) -> None:
        """Demote every HBM entry (drain: cache holds no pool pages)."""
        for key in list(self._hbm):
            self._demote(key)

    def _enforce(self) -> None:
        """Demote LRU entries until the HBM tier fits its byte budget."""
        while self._hbm and len(self._hbm) * self.page_bytes > self.budget_bytes:
            self._demote(next(iter(self._hbm)))

    def _demote(self, key: str) -> bool:
        """Move one HBM entry down a tier.

        Snapshots the page's bytes to the host tier (writing through to
        disk when configured), drops the cache's pool reference, and
        notifies ``on_page_freed`` if the page actually freed.  Returns
        True when the page left the device.
        """
        page = self._hbm.pop(key)
        del self._page2key[page]
        kv = {k: _to_bits(v) for k, v in self.gather(page).items()}
        self._host[key] = kv
        self.demotions_host += 1
        if self.cache_dir is not None:
            self._disk_write(key, kv)
        self._enforce_host()
        freed = self.pool.free([page])
        if freed and self.on_page_freed is not None:
            self.on_page_freed(page)
        return bool(freed)

    # ------------------------------------------------------------------
    # host + disk tiers

    def _enforce_host(self) -> None:
        """Drop oldest host entries past the host budget (disk persists)."""
        if self.host_budget_bytes is None:
            return
        while self._host and len(self._host) * self.page_bytes > self.host_budget_bytes:
            del self._host[next(iter(self._host))]

    def peek(self, key: str) -> str | None:
        """Non-consuming lower-tier lookup: ``"host"``, ``"disk"`` or None.

        Admission planning uses this to count how far a prompt's chunk
        chain extends through the cache before committing allocations.
        """
        if key in self._host:
            return "host"
        if self.cache_dir is not None and (key in self._disk_index or self._disk_path(key).exists()):
            return "disk"
        return None

    def fetch(self, key: str) -> tuple[dict, str] | None:
        """Consume a lower-tier entry: ``(kv host tensors, tier name)`` or
        None.

        A host hit pops its entry - the promoting sequence re-registers
        the chunk in the trie, and its completion re-holds the new page,
        so the chunk re-enters the hierarchy from the top.  Disk files
        are never consumed; an unreadable file is treated as a miss.
        """
        kv = self._host.pop(key, None)
        if kv is not None:
            return {k: _from_bits(*v) for k, v in kv.items()}, "host"
        if self.cache_dir is not None:
            kv = self._disk_read(key)
            if kv is not None:
                return kv, "disk"
        return None

    def _disk_path(self, key: str) -> Path:
        """Disk-tier file for ``key``."""
        return self.cache_dir / f"{key}.npz"

    def _disk_write(self, key: str, kv: dict) -> None:
        """Atomically persist one chunk (skipped when already on disk).

        Arrays are stored as their raw bits plus dtype-name sidecars, so
        bf16 and fp8 survive the npz round trip without ``ml_dtypes``.
        """
        path = self._disk_path(key)
        if key in self._disk_index or path.exists():
            self._disk_index.add(key)
            return
        payload = {}
        for name, (bits, dtype) in kv.items():
            payload[name] = bits
            payload[name + "_dtype"] = np.asarray(dtype)
        tmp = path.with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
        self._disk_index.add(key)
        self._disk_bytes += path.stat().st_size
        self.demotions_disk += 1

    def _disk_read(self, key: str) -> dict | None:
        """Load one chunk from disk; corrupt/missing files read as a miss."""
        path = self._disk_path(key)
        if not path.exists():
            self._disk_index.discard(key)
            return None
        try:
            with np.load(path) as f:
                return {name: _from_bits(f[name], str(f[name + "_dtype"]))
                        for name in ("k", "v")}
        except Exception:
            return None

    # ------------------------------------------------------------------
    # accounting

    def bytes_by_tier(self) -> dict[str, int]:
        """Bytes resident per tier: ``{"hbm", "host", "disk"}``.

        HBM and host count retained pages at ``page_bytes`` each; disk is
        the on-disk npz file sizes (including chunks inherited from a
        previous engine's run against the same directory).
        """
        return {
            "hbm": len(self._hbm) * self.page_bytes,
            "host": len(self._host) * self.page_bytes,
            "disk": self._disk_bytes,
        }
