"""Block-paged KV cache bookkeeping, host side — a copy of the page
allocator of ``tensorhive_tpu/serving/paging.py`` (``PagePool`` with its
refcounts and prefix-cache references, ``page_content_key``) and of its
host tier (``HostPageEntry``, ``HostPageStore``, ``LaneJob``,
``HostCopyLane``).

The cache is a pool of fixed-size pages of ``page_size`` token positions; a
slot owns only the pages its request needs, handed out from a host-side
free list at admission and recycled when the slot leaves. The free list
pops in the same order as the JAX pool's, so the two engines assign the
same physical page ids to the same schedule.

Pages are refcounted: the prefix cache (``prefix_cache.py``) maps shared
prompt prefixes to physical page runs, so one page can back many slots at
once. Each slot's grant and each radix-tree node holds one reference, and a
page returns to the free list only when the last reference drops. With no
sharing every refcount is 1 and the pool behaves as a plain allocator.

Physical page 0 is the **trash page**: never handed out; a freed slot's
page-table row resets to it, so a parked slot's garbage writes land where
no live sequence reads.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

#: physical index of the write sink for parked slots; never allocated
TRASH_PAGE = 0


class PagePool:
    """Fixed-size page allocator + per-slot page tables + refcounts.

    ``num_pages`` usable pages (physical ``1..num_pages``; 0 is the trash
    page). ``page_table`` is the ``[slots, max_pages_per_slot]`` int32
    array the paged step/prefill consume: row ``s``, entry ``j`` is the
    physical page holding slot ``s``'s logical positions ``j*page_size ..
    (j+1)*page_size-1``; unassigned entries point at the trash page.

    A page is FREE (refcount 0, on the free list) or LIVE (refcount = slot
    grants + at most one prefix-cache reference). ``free_pages +
    live_pages == num_pages`` after every operation."""

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int) -> None:
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_pages_per_slot < 1:
            raise ValueError(
                f"max_pages_per_slot must be >= 1, got {max_pages_per_slot}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.max_pages_per_slot = int(max_pages_per_slot)
        # LIFO free list (recently used pages are reissued first); usable
        # physical pages are 1 .. num_pages
        self._free: List[int] = list(range(self.num_pages, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(self.slots)]
        #: per physical page: slot grants + prefix-cache references
        self._refcounts = np.zeros(1 + self.num_pages, np.int32)
        self.page_table = np.full((self.slots, self.max_pages_per_slot),
                                  TRASH_PAGE, np.int32)

    @property
    def physical_pages(self) -> int:
        """Rows of the physical cache array: trash + usable."""
        return 1 + self.num_pages

    def pages_for(self, tokens: int) -> int:
        """Pages a ``tokens``-position sequence occupies (ceil division)."""
        if tokens < 1:
            raise ValueError(f"tokens must be >= 1, got {tokens}")
        return -(-tokens // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def live_pages(self) -> int:
        """Pages with at least one reference (slot grant or prefix-cache
        retention) — the complement of the free list."""
        return int((self._refcounts > 0).sum())

    def refcount(self, page: int) -> int:
        return int(self._refcounts[page])

    def owned_count(self, slot: int) -> int:
        return len(self._owned[slot])

    def owned_pages(self, slot: int) -> List[int]:
        """The slot's granted pages in logical order (a copy)."""
        return list(self._owned[slot])

    def slot_ref_counts(self) -> Dict[int, int]:
        """page -> number of slots holding a grant on it. A live page
        absent from this map is held only by the prefix cache."""
        counts: Dict[int, int] = {}
        for owned in self._owned:
            for page in owned:
                counts[page] = counts.get(page, 0) + 1
        return counts

    def cached_only_pages(self) -> int:
        """Live pages held ONLY by the prefix cache (no slot grant) — the
        evictable headroom admission can reclaim under pressure."""
        slot_held = set()
        for owned in self._owned:
            slot_held.update(owned)
        return int(sum(1 for page in range(1, self.physical_pages)
                       if self._refcounts[page] > 0
                       and page not in slot_held))

    def saturation(self) -> float:
        """Fraction of the pool in use (1.0 = exhausted)."""
        return self.used_pages / self.num_pages

    # -- allocation --------------------------------------------------------
    def assign(self, slot: int, pages: int) -> bool:
        """Move ``pages`` fresh pages from the free list to ``slot`` and fill
        its page-table row. Returns False (taking nothing) when the pool
        cannot satisfy the request; raises on an occupied slot or an
        oversize grant."""
        if not 0 < pages <= self.max_pages_per_slot:
            raise ValueError(
                f"pages must be in [1, {self.max_pages_per_slot}], "
                f"got {pages}")
        return self.assign_shared(slot, (), pages)

    def assign_shared(self, slot: int, shared: Sequence[int],
                      fresh: int) -> bool:
        """Grant ``slot`` a run of already-live ``shared`` pages (a prefix-
        cache hit: each gains one reference and is read-only to this slot)
        followed by ``fresh`` pages popped from the free list (the private
        suffix). Returns False taking nothing when the free list cannot
        cover ``fresh``; raises on an occupied slot, an oversize grant or
        sharing a page nobody holds."""
        total = len(shared) + fresh
        if not 0 < total <= self.max_pages_per_slot:
            raise ValueError(
                f"total pages must be in [1, {self.max_pages_per_slot}], "
                f"got {total}")
        if self._owned[slot]:
            raise ValueError(
                f"slot {slot} already owns {len(self._owned[slot])} pages; "
                "release before reassigning")
        for page in shared:
            if not 1 <= page < self.physical_pages:
                raise ValueError(f"shared page {page} is not a usable page")
            if self._refcounts[page] < 1:
                raise ValueError(
                    f"shared page {page} has no live reference — sharing a "
                    "free page would read recycled garbage")
        if fresh > len(self._free):
            return False
        granted = [self._free.pop() for _ in range(fresh)]
        for page in shared:
            self._refcounts[page] += 1
        for page in granted:
            self._refcounts[page] = 1
        row = list(shared) + granted
        self._owned[slot] = row
        self.page_table[slot, :len(row)] = row
        return True

    def release(self, slot: int) -> int:
        """Drop ``slot``'s reference on each granted page, returning pages
        whose refcount reaches 0 to the free list, and point the whole row
        back at the trash page; idempotent. Returns the NET number of pages
        freed (shared pages survive their sharers)."""
        granted = self._owned[slot]
        self._owned[slot] = []
        freed = 0
        for page in reversed(granted):
            self._refcounts[page] -= 1
            if self._refcounts[page] == 0:
                self._free.append(page)
                freed += 1
        self.page_table[slot, :] = TRASH_PAGE
        return freed

    # -- prefix-cache references -------------------------------------------
    def cache_ref(self, page: int) -> None:
        """Add the prefix cache's retention reference to a LIVE page."""
        if self._refcounts[page] < 1:
            raise ValueError(
                f"page {page} is free — the prefix cache can only retain "
                "pages a slot currently holds")
        self._refcounts[page] += 1

    def cache_unref(self, page: int) -> bool:
        """Drop the prefix cache's reference (eviction); True when that
        freed the page back to the pool."""
        if self._refcounts[page] < 1:
            raise ValueError(f"page {page} has no reference to drop")
        self._refcounts[page] -= 1
        if self._refcounts[page] == 0:
            self._free.append(page)
            return True
        return False


def page_content_key(prompt: Sequence[int], page_index: int,
                     page_size: int) -> bytes:
    """Content key of logical page ``page_index`` of ``prompt``: the WHOLE
    token prefix through the page's last position, serialized (K/V at a
    position depends on every earlier token)."""
    end = (page_index + 1) * page_size
    return np.asarray(prompt[:end], np.int32).tobytes()


# -- host tier ----------------------------------------------------------------

class HostPageEntry:
    """One demoted page: int8 K/V payload ``[layers, page_size, kv_heads,
    d_head]`` plus the per-(page, kv_head) f32 scale rows ``[layers,
    kv_heads]`` that travelled with it. Immutable once stored: a promotion
    reads it, never edits it, so the store can hand one entry to several
    promote jobs without copying."""

    __slots__ = ("k", "v", "k_scale", "v_scale", "nbytes", "last_used")

    def __init__(self, k: np.ndarray, v: np.ndarray, k_scale: np.ndarray,
                 v_scale: np.ndarray, last_used: int) -> None:
        self.k = k
        self.v = v
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.nbytes = int(k.nbytes + v.nbytes + k_scale.nbytes
                          + v_scale.nbytes)
        self.last_used = last_used


class HostPageStore:
    """Bounded host-RAM store of demoted int8 pages, LRU inside a byte
    budget (``host_kv_bytes``).

    Keys are radix content keys (:func:`page_content_key`). ``put`` admits
    an entry and LRU-evicts past the budget; ``get`` returns the entry and
    touches its LRU stamp. An entry larger than the whole budget is
    refused. Not locked: the engine touches it only from its pump thread,
    like :class:`PagePool`."""

    def __init__(self, capacity_bytes: int) -> None:
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self._entries: Dict[bytes, HostPageEntry] = {}
        self._tick = 0
        self.bytes_used = 0
        #: lifetime pages the budget pushed back out
        self.evictions = 0

    @property
    def resident_pages(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def put(self, key: bytes, k: np.ndarray, v: np.ndarray,
            k_scale: np.ndarray, v_scale: np.ndarray) -> bool:
        """Adopt one demoted page; returns False when it can never fit.
        Re-demoting a resident key refreshes its bytes and LRU stamp (the
        payload is the same by construction: content-keyed)."""
        self._tick += 1
        entry = HostPageEntry(k, v, k_scale, v_scale, self._tick)
        if entry.nbytes > self.capacity_bytes:
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes_used -= old.nbytes
        self._entries[key] = entry
        self.bytes_used += entry.nbytes
        while self.bytes_used > self.capacity_bytes:
            victim = min(self._entries,
                         key=lambda k_: self._entries[k_].last_used)
            self.bytes_used -= self._entries.pop(victim).nbytes
            self.evictions += 1
        return True

    def get(self, key: bytes) -> Optional[HostPageEntry]:
        entry = self._entries.get(key)
        if entry is not None:
            self._tick += 1
            entry.last_used = self._tick
        return entry

    def clear(self) -> int:
        dropped = len(self._entries)
        self._entries.clear()
        self.bytes_used = 0
        return dropped


class LaneJob:
    """One unit of copy-lane work. ``done`` flips True (a plain attribute
    write, atomic under the GIL) only AFTER ``result``/``error`` are set,
    so a pump-thread poll that sees ``done`` sees the whole outcome."""

    __slots__ = ("fn", "result", "error", "done")

    def __init__(self, fn: Callable[[], object]) -> None:
        self.fn = fn
        self.result: object = None
        self.error: Optional[BaseException] = None
        self.done = False

    def run(self) -> None:
        try:
            self.result = self.fn()
        except Exception as exc:            # reported through the poll
            self.error = exc
        self.done = True


class HostCopyLane:
    """The promote/demote copy lane: one background worker that runs the
    waits and host-side assembly of the tier's copies OFF the pump thread,
    so a promotion or a demotion never holds up the decode step.

    The pump thread ``submit``s a closure and polls ``job.done`` each tick;
    it never joins or waits. An ``urgent`` job (a promotion, which a
    request waits on) runs ahead of the queued others (demotions, whose
    pages were gathered already and wait on no one). The worker starts at
    the first submit and is a daemon. Tests substitute a synchronous or
    manually released lane through the same ``submit(fn, urgent)``."""

    def __init__(self) -> None:
        self._ready = threading.Condition()
        self._urgent: "collections.deque[LaneJob]" = collections.deque()
        self._queued: "collections.deque[LaneJob]" = collections.deque()
        self._worker: Optional[threading.Thread] = None

    def submit(self, fn: Callable[[], object],
               urgent: bool = False) -> LaneJob:
        job = LaneJob(fn)
        with self._ready:
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, name="host-kv-copy-lane", daemon=True)
                self._worker.start()
            (self._urgent if urgent else self._queued).append(job)
            self._ready.notify()
        return job

    def _run(self) -> None:
        while True:
            with self._ready:
                while not (self._urgent or self._queued):
                    self._ready.wait()
                job = (self._urgent or self._queued).popleft()
            job.run()
