"""Radix prefix cache — a copy of ``tensorhive_tpu/serving/prefix_cache.py``:
shared-prompt page reuse for the paged slot engine.

A radix tree over token-id prefixes maps "prompt prefix -> physical page
run", so that

* **admission charges only the unique suffix** — matched pages are granted
  SHARED (``PagePool.assign_shared`` bumps their refcount; the joiner never
  writes them), and only ``pages_for(prompt + max_new) - matched`` fresh
  pages come off the free list;
* **prefill starts at the first uncached position** — the engine's chunked
  prefill takes the start offset, so a prompt whose first pages are cached
  prefills only the rest;
* **pool pressure evicts LRU, never a referenced page** — tree nodes whose
  page no slot holds (refcount 1 = cache-only) are reclaimed leaf-first in
  least-recently-matched order when admission runs short.

The sharing unit is one FULL page. K/V at position ``p`` depends only on
tokens ``0..p``, so a page is reusable exactly when the whole token prefix
through its last position matches; each edge keys on a page-sized token
tuple. A prompt that diverges (or ends) mid-page never writes the shared
page: the match stops at the last whole-page boundary, and the divergent
page is a fresh private page whose positions the prefill chunk recomputes
(copy-on-write by recompute). Writes to shared pages are impossible by
construction, which is what lets refcounts alone guarantee isolation.

Under int8 pages a cached page carries its payload and its per-(page,
kv_head) scales; since no sharer ever writes it, both are frozen while
referenced, and a hit reads byte for byte what the miss stored.

Readiness: a page enters the tree right after the prefill chunk covering
its last position was dispatched. The engine runs every device call on one
thread, in one stream order, so any later reader sees the writer's output.

Host bookkeeping only; the engine serializes every call under its lock.
With the host KV tier on, the engine wires the ``spill`` hook: ``evict``
calls it with each victim's content key and physical page BEFORE the
victim's reference drops, and the engine queues the page for demotion,
gathered on the compute stream ahead of any later write to the recycled
page. With the tier off ``spill`` stays ``None``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .paging import PagePool, page_content_key


class _Node:
    """One cached page: the tree edge for its ``page_size``-token chunk.
    Children key on the NEXT page's token tuple."""

    __slots__ = ("tokens", "page", "parent", "children", "last_used")

    def __init__(self, tokens: Tuple[int, ...], page: int,
                 parent: Optional["_Node"], last_used: int) -> None:
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = last_used


class PrefixCache:
    """Radix tree over token-id prefixes -> physical page runs.

    Holds one :class:`~.paging.PagePool` reference per cached page
    (``cache_ref``), so cached pages survive their computing slot's
    departure and are reclaimable (``evict``) once no slot shares them.
    ``min_tokens`` gates matching, never insertion."""

    def __init__(self, pool: PagePool, min_tokens: int = 0) -> None:
        self.pool = pool
        self.page_size = pool.page_size
        self.min_tokens = max(0, int(min_tokens))
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._nodes = 0
        self._tick = 0          # monotonic LRU stamp (no wall clock needed)
        self.evictions = 0      # lifetime pages evicted
        #: demote-on-evict hook, ``spill(content_key, page)``, called for
        #: each eviction victim before its reference drops; None = no tier
        self.spill: Optional[Callable[[bytes, int], None]] = None

    # -- introspection -----------------------------------------------------
    @property
    def cached_pages(self) -> int:
        """Pages currently retained by the tree."""
        return self._nodes

    def evictable_pages(self) -> int:
        """Cached pages no slot currently shares — reclaimable headroom."""
        return sum(1 for node in self._iter_nodes()
                   if self.pool.refcount(node.page) == 1)

    def _iter_nodes(self):
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    # -- the cacheable span of a prompt ------------------------------------
    def cacheable_tokens(self, prompt_len: int) -> int:
        """Leading tokens of a ``prompt_len`` prompt that are ever
        shareable: whole pages only, and never the page holding position
        ``prompt_len - 1`` (the first decode step writes there)."""
        return ((max(0, prompt_len - 1)) // self.page_size) * self.page_size

    # -- match -------------------------------------------------------------
    def match(self, prompt: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``prompt``: ``(cached_tokens, pages)``,
        ``cached_tokens`` a multiple of ``page_size`` capped at
        :meth:`cacheable_tokens` and ``pages`` the physical run behind it
        in logical order. Every node on the path gets an LRU touch; a match
        shorter than ``min_tokens`` reports a miss ``(0, [])``."""
        limit_pages = self.cacheable_tokens(len(prompt)) // self.page_size
        children = self._root
        pages: List[int] = []
        for index in range(limit_pages):
            key = tuple(prompt[index * self.page_size:
                               (index + 1) * self.page_size])
            node = children.get(key)
            if node is None:
                break
            self._tick += 1
            node.last_used = self._tick
            pages.append(node.page)
            children = node.children
        cached = len(pages) * self.page_size
        if cached < self.min_tokens:
            return 0, []
        return cached, pages

    # -- insert ------------------------------------------------------------
    def insert(self, prompt: Sequence[int], row_pages: Sequence[int],
               upto_tokens: int) -> int:
        """Adopt the dispatched pages of a prompt into the tree: the pages
        of ``row_pages`` (the slot's page-table row) wholly inside
        ``min(upto_tokens, cacheable_tokens)``. A node already present
        keeps its page (first writer wins; the later copy stays private to
        its slot). Returns the newly adopted page count."""
        span = min(int(upto_tokens), self.cacheable_tokens(len(prompt)))
        children = self._root
        parent: Optional[_Node] = None
        adopted = 0
        for index in range(span // self.page_size):
            key = tuple(prompt[index * self.page_size:
                               (index + 1) * self.page_size])
            node = children.get(key)
            if node is None:
                page = int(row_pages[index])
                self.pool.cache_ref(page)
                self._tick += 1
                node = _Node(key, page, parent, self._tick)
                children[key] = node
                self._nodes += 1
                adopted += 1
            else:
                self._tick += 1
                node.last_used = self._tick
            parent = node
            children = node.children
        return adopted

    # -- eviction ----------------------------------------------------------
    def evict(self, need_pages: int) -> int:
        """Free up to ``need_pages`` pages by dropping LRU cache-only
        leaves (refcount 1: no slot shares them). Evicting a leaf can
        expose its parent as the next candidate. Returns pages freed."""
        freed = 0
        while freed < need_pages:
            victim: Optional[_Node] = None
            for node in self._iter_nodes():
                if node.children:
                    continue                      # interior: children first
                if self.pool.refcount(node.page) != 1:
                    continue                      # a slot still shares it
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            if self.spill is not None:
                self.spill(self._content_key(victim), victim.page)
            self._detach(victim)
            if self.pool.cache_unref(victim.page):
                freed += 1
            self.evictions += 1
        return freed

    def _content_key(self, node: _Node) -> bytes:
        """The node's content key: the full token prefix through its
        page's last position."""
        parts: List[Tuple[int, ...]] = []
        cursor: Optional[_Node] = node
        while cursor is not None:
            parts.append(cursor.tokens)
            cursor = cursor.parent
        prefix: List[int] = [token for part in reversed(parts)
                             for token in part]
        return page_content_key(prefix, len(parts) - 1, self.page_size)

    def _detach(self, node: _Node) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._root)
        siblings.pop(node.tokens, None)
        self._nodes -= 1

    def clear(self) -> int:
        """Drop every cached page; returns pages freed."""
        freed = 0
        for node in list(self._iter_nodes()):
            if self.pool.cache_unref(node.page):
                freed += 1
        self._root = {}
        self._nodes = 0
        return freed
