"""Block-paged KV cache bookkeeping, host side — a copy of the page
allocator of ``tensorhive_tpu/serving/paging.py`` (``PagePool`` without the
prefix-cache references and the host tier, which are not ported yet).

The cache is a pool of fixed-size pages of ``page_size`` token positions; a
slot owns only the pages its request needs, handed out from a host-side
free list at admission and recycled when the slot leaves. The free list
pops in the same order as the JAX pool's, so the two engines assign the
same physical page ids to the same schedule.

Physical page 0 is the **trash page**: never handed out; a freed slot's
page-table row resets to it, so a parked slot's garbage writes land where
no live sequence reads.
"""
from __future__ import annotations

from typing import List

import numpy as np

#: physical index of the write sink for parked slots; never allocated
TRASH_PAGE = 0


class PagePool:
    """Fixed-size page allocator + per-slot page tables.

    ``num_pages`` usable pages (physical ``1..num_pages``; 0 is the trash
    page). ``page_table`` is the ``[slots, max_pages_per_slot]`` int32
    array the paged step/prefill consume: row ``s``, entry ``j`` is the
    physical page holding slot ``s``'s logical positions ``j*page_size ..
    (j+1)*page_size-1``; unassigned entries point at the trash page."""

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

    def assign(self, slot: int, pages: int) -> bool:
        """Move ``pages`` fresh pages from the free list to ``slot`` and fill
        its page-table row. Returns False (taking nothing) when the pool
        cannot satisfy the request; raises on an occupied slot or an
        oversize grant."""
        if not 0 < pages <= self.max_pages_per_slot:
            raise ValueError(
                f"pages must be in [1, {self.max_pages_per_slot}], "
                f"got {pages}")
        if self._owned[slot]:
            raise ValueError(
                f"slot {slot} already owns {len(self._owned[slot])} pages; "
                "release before reassigning")
        if pages > len(self._free):
            return False
        granted = [self._free.pop() for _ in range(pages)]
        self._owned[slot] = granted
        self.page_table[slot, :pages] = granted
        return True

    def release(self, slot: int) -> int:
        """Return ``slot``'s pages to the free list and point its whole row
        back at the trash page; idempotent. Returns the pages freed."""
        granted = self._owned[slot]
        self._owned[slot] = []
        self._free.extend(reversed(granted))
        self.page_table[slot, :] = TRASH_PAGE
        return len(granted)
