"""Prefix cache: a trie over paged KV, with copy-on-write page refcounts
(port of the reference's ``serving/prefix_cache.py``).

The trie maps page-aligned token chunks to pool pages that an earlier
prefill already filled: a request whose prompt starts with a cached prefix
``adopt``\\ s those pages (refcount + 1, see :mod:`.kv_pool`) instead of
prefilling them again, and its prefill starts at the first uncached page.

Why a hit is token-exact against a prefill from the prompt:

* keys are exact token tuples at page granularity: a page is reused only
  where the request's tokens at those positions are identical;
* attention is causal and positions absolute, so the KV of tokens
  ``[0, n)`` does not depend on anything after ``n``;
* prefill and KV quantization are deterministic, so a cached page holds
  the bytes a fresh prefill would write;
* only FULL pages are cached, and the page holding the LAST prompt token
  is never matched: its logits must be computed to give the first output
  token, and decode writes land in pages the request allocated itself.

Eviction: leaf-only LRU under a page budget (``PADDLE_TPU_PREFIX_PAGES``,
64).  Evicting a node drops the trie's reference only; a request that
adopted the page keeps it until its own free.  ``clear()`` drops every trie
reference (the remedy for a cache suspected of holding corrupt pages).

The reference also reports hits, misses and held pages to its telemetry
layer; here they are the attributes of :meth:`PrefixCache.summary`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from .kv_pool import TRASH_PAGE, PagedKVPool

__all__ = ["PrefixCache", "default_prefix_pages"]


def default_prefix_pages() -> int:
    """Trie page budget (``PADDLE_TPU_PREFIX_PAGES``, default 64)."""
    return int(os.environ.get("PADDLE_TPU_PREFIX_PAGES", "64"))


class _Node:
    """One cached page: keyed in its parent by the page's token tuple,
    holding the physical page id and an LRU stamp."""

    __slots__ = ("chunk", "page", "children", "last_used")

    def __init__(self, chunk: Tuple[int, ...], page: int):
        self.chunk = chunk
        self.page = int(page)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    """Trie over :class:`PagedKVPool` pages.  The cache owns one pool
    reference per node (taken at :meth:`insert`, dropped at eviction or
    :meth:`clear`); requests that hit take their own references through
    ``pool.adopt``, so trie eviction and request preemption commute."""

    def __init__(self, pool: PagedKVPool, *, max_pages: Optional[int] = None):
        self.pool = pool
        self.page_tokens = pool.page_tokens
        self.max_pages = int(max_pages if max_pages is not None
                             else default_prefix_pages())
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._nodes = 0
        self._clock = 0          # monotonic LRU stamp (no wall time)
        self.hits = 0            # admissions that adopted >= 1 cached page
        self.misses = 0          # admissions that found nothing
        self.tokens_saved = 0    # prompt tokens served from the cache
        self.pages_inserted = 0
        self.pages_evicted = 0

    # -- lookup ------------------------------------------------------------
    def _chunks(self, prompt, n_pages: int) -> List[Tuple[int, ...]]:
        P = self.page_tokens
        return [tuple(int(t) for t in prompt[j * P:(j + 1) * P])
                for j in range(n_pages)]

    def match(self, prompt) -> Tuple[List[int], int]:
        """Longest cached page prefix of ``prompt``: ``(pages, n_tokens)``.
        The walk stops at ``(len(prompt) - 1) // page_tokens`` pages, so the
        page of the last prompt token is never matched.  Counts nothing:
        admission calls :meth:`note` once per admitted request."""
        cap = max(0, (len(prompt) - 1) // self.page_tokens)
        self._clock += 1
        pages: List[int] = []
        kids = self._root
        for chunk in self._chunks(prompt, cap):
            node = kids.get(chunk)
            if node is None:
                break
            node.last_used = self._clock
            pages.append(node.page)
            kids = node.children
        return pages, len(pages) * self.page_tokens

    def note(self, hit: bool, n_tokens: int = 0) -> None:
        """Record one admission's outcome (apart from :meth:`match`, so a
        head request probed on several steps counts once)."""
        if hit:
            self.hits += 1
            self.tokens_saved += int(n_tokens)
        else:
            self.misses += 1

    # -- insert ------------------------------------------------------------
    def insert(self, prompt, table: List[int]) -> int:
        """Register the FULL pages of a just-prefilled prompt; returns how
        many nodes were created.  Where the trie already holds a node for a
        chunk, the trie's page wins (both hold the same bytes) and the walk
        descends without taking a reference."""
        P = self.page_tokens
        n_full = min(len(prompt) // P, len(table))
        self._clock += 1
        kids = self._root
        added = 0
        for j, chunk in enumerate(self._chunks(prompt, n_full)):
            node = kids.get(chunk)
            if node is None:
                page = int(table[j])
                if page == TRASH_PAGE or self.pool.refcount(page) == 0:
                    break     # never cache the trash page or a freed one
                self.pool.incref([page])
                node = _Node(chunk, page)
                kids[chunk] = node
                self._nodes += 1
                added += 1
            node.last_used = self._clock
            kids = node.children
        if added:
            self.pages_inserted += added
            self._evict_to_budget()
        return added

    # -- eviction ----------------------------------------------------------
    def _leaves(self):
        """(parent dict, node) for every leaf, iteratively (a long prompt's
        deep trie must not reach the recursion limit)."""
        out = []
        stack = [(self._root, n) for n in self._root.values()]
        while stack:
            parent, node = stack.pop()
            if node.children:
                stack.extend((node.children, c) for c in node.children.values())
            else:
                out.append((parent, node))
        return out

    def _evict_to_budget(self) -> int:
        """Leaf-only LRU down to ``max_pages`` nodes: a surviving node's
        prefix path stays fully cached."""
        evicted = 0
        while self._nodes > self.max_pages:
            leaves = self._leaves()
            if not leaves:
                break
            parent, victim = min(leaves, key=lambda pn: pn[1].last_used)
            del parent[victim.chunk]
            self._nodes -= 1
            self.pool.decref([victim.page])
            evicted += 1
        self.pages_evicted += evicted
        return evicted

    def clear(self) -> int:
        """Drop every cached page; returns the number of trie references
        released."""
        n = 0
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.pool.decref([node.page])
            n += 1
        self._root = {}
        self._nodes = 0
        return n

    # -- introspection -----------------------------------------------------
    def pages_held(self) -> int:
        return self._nodes

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def summary(self) -> dict:
        return {"pages_held": self._nodes, "max_pages": self.max_pages,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hit_rate(), 4),
                "tokens_saved": self.tokens_saved,
                "pages_inserted": self.pages_inserted,
                "pages_evicted": self.pages_evicted}
