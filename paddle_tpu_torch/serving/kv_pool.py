"""Paged KV pool: fixed-size token pages and per-request block tables
(port of the reference's ``serving/kv_pool.py``, without the host-RAM
offload tier).

Pure accounting, no tensors: the :class:`~.engine.ServingEngine` owns the
physical ``[num_pages, page_tokens, kv_heads, head_dim]`` arenas and
indexes them with the tables handed out here.  Page 0 is RESERVED as the
trash page: idle batch rows of a decode step write their (ignored) k/v
there.  Pages carry copy-on-write refcounts (``incref``/``decref``/
``adopt``): a page returns to the free list when its last reference drops.

``swap_out``/``swap_in``/the parked plans and ``OffloadPool`` belong to the
host-RAM offload tier, which is not ported yet (the engine raises for
``offload=``).

Env: ``PADDLE_TPU_PAGE_TOKENS`` sets the default page size (tokens per
page, 16).
"""

from __future__ import annotations

import os
from typing import Dict, List

__all__ = ["PagedKVPool", "PoolExhausted", "default_page_tokens", "TRASH_PAGE"]

TRASH_PAGE = 0


def default_page_tokens() -> int:
    return int(os.environ.get("PADDLE_TPU_PAGE_TOKENS", "16"))


class PoolExhausted(RuntimeError):
    """No free pages: the caller must evict a request (or reject the
    admission) before retrying."""


class PagedKVPool:
    """Page allocator over ``num_pages`` fixed blocks of ``page_tokens``
    token slots each.  Page 0 is the reserved trash page and is never
    handed out, so ``capacity`` is ``num_pages - 1``."""

    def __init__(self, num_pages: int, page_tokens: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        self._free: List[int] = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._tables: Dict[object, List[int]] = {}
        # page id -> live references (>= 1 while allocated); a page is on
        # the free list or in here, never both; the trash page is in neither
        self._refs: Dict[int, int] = {}
        self._peak_used = 0
        # byte accountant (the engine fills it in via set_page_bytes)
        self.bytes_per_page = 0
        self.scale_bytes_per_page = 0
        self.kv_dtype = "bf16"

    # -- byte accounting ---------------------------------------------------
    def set_page_bytes(self, arena_bytes: int, scale_bytes: int = 0,
                       kv_dtype: str = "bf16") -> None:
        """Record what one page costs on the device (across all layers,
        k+v, plus any scale planes)."""
        self.bytes_per_page = int(arena_bytes)
        self.scale_bytes_per_page = int(scale_bytes)
        self.kv_dtype = str(kv_dtype)

    def pool_bytes(self) -> int:
        """Device bytes held by the allocatable pages (trash page excluded)."""
        return self.capacity * (self.bytes_per_page + self.scale_bytes_per_page)

    def used_bytes(self) -> int:
        return self.pages_used * (self.bytes_per_page + self.scale_bytes_per_page)

    def bytes_per_token(self) -> float:
        """Device bytes one token slot costs (arena + scales, all layers)."""
        return (self.bytes_per_page + self.scale_bytes_per_page) \
            / max(self.page_tokens, 1)

    # -- capacity ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return self.capacity - len(self._free)

    def occupancy(self) -> float:
        """Fraction of allocatable pages currently owned by requests."""
        return self.pages_used / max(self.capacity, 1)

    @property
    def peak_used(self) -> int:
        return self._peak_used

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` token slots."""
        return -(-max(int(n_tokens), 0) // self.page_tokens)

    def can_alloc(self, n_pages: int) -> bool:
        return len(self._free) >= int(n_pages)

    # -- alloc / free ------------------------------------------------------
    def alloc(self, rid, n_pages: int = 1) -> List[int]:
        """Append ``n_pages`` fresh pages to ``rid``'s block table and
        return the page ids.  All-or-nothing: raises :class:`PoolExhausted`
        without allocating when fewer than ``n_pages`` are free."""
        n = int(n_pages)
        if n < 0:
            raise ValueError("n_pages must be >= 0")
        if len(self._free) < n:
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"({self.pages_used}/{self.capacity} in use)")
        got = [self._free.pop() for _ in range(n)]
        for p in got:
            self._refs[p] = 1
        self._tables.setdefault(rid, []).extend(got)
        self._peak_used = max(self._peak_used, self.pages_used)
        return got

    # -- copy-on-write sharing ---------------------------------------------
    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 = free / never allocated)."""
        return self._refs.get(int(page), 0)

    def shared_pages(self) -> int:
        """Allocated pages with more than one live reference."""
        return sum(1 for c in self._refs.values() if c > 1)

    def incref(self, pages) -> None:
        """Take an additional reference on live pages.  The trash page and
        free pages cannot gain references: both are caller bugs and raise."""
        for p in pages:
            p = int(p)
            if p == TRASH_PAGE:
                raise ValueError("incref of the trash page (page 0): the "
                                 "trash page is never allocatable state")
            if p not in self._refs:
                raise KeyError(f"incref of free/unknown page {p}: only "
                               f"live pages can gain references")
            self._refs[p] += 1

    def decref(self, pages) -> int:
        """Drop one reference per page; pages reaching zero return to the
        free list.  Returns how many actually freed; a double-free raises."""
        freed = 0
        for p in pages:
            p = int(p)
            if p == TRASH_PAGE:
                raise ValueError("decref of the trash page (page 0)")
            c = self._refs.get(p, 0)
            if c <= 0:
                raise KeyError(f"double-free: decref of page {p} with no "
                               f"live references")
            if c == 1:
                del self._refs[p]
                self._free.append(p)
                freed += 1
            else:
                self._refs[p] = c - 1
        return freed

    def adopt(self, rid, pages) -> List[int]:
        """Append already-allocated ``pages`` to ``rid``'s block table,
        taking a reference on each.  All-or-nothing: validates every page
        before touching any refcount."""
        pages = [int(p) for p in pages]
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("adopt of the trash page (page 0)")
            if p not in self._refs:
                raise KeyError(f"adopt of free/unknown page {p}")
        self.incref(pages)
        self._tables.setdefault(rid, []).extend(pages)
        return pages

    def table(self, rid) -> List[int]:
        """The request's block table: physical page of logical page ``j``
        (token range ``[j*page_tokens, (j+1)*page_tokens)``)."""
        return list(self._tables.get(rid, ()))

    def free(self, rid) -> int:
        """Drop ``rid``'s reference on every page it owns; returns how many
        pages returned to the free list.  Unknown ``rid`` raises."""
        if rid not in self._tables:
            raise KeyError(f"free of unknown/already-freed request {rid!r}")
        pages = self._tables.pop(rid)
        return self.decref(reversed(pages))

    def check_leaks(self, allow_shared: bool = False) -> None:
        """Assert the quiesced-pool invariant: no table left behind, and
        the free list plus the referenced pages partition
        ``{1..num_pages-1}`` exactly (a shared page counts once).  With
        ``allow_shared``, surviving references are legal."""
        if self._tables:
            raise AssertionError(
                f"leaked block tables: { {k: len(v) for k, v in self._tables.items()} }")
        if not allow_shared and self._refs:
            raise AssertionError(
                f"leaked page references: { {p: c for p, c in sorted(self._refs.items())} }")
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise AssertionError("free list corrupt: duplicate entries")
        if free_set & set(self._refs):
            raise AssertionError(
                f"pages both free and referenced: "
                f"{sorted(free_set & set(self._refs))}")
        if free_set | set(self._refs) != set(range(1, self.num_pages)):
            raise AssertionError(
                f"page accounting corrupt: {len(self._free)} free + "
                f"{len(self._refs)} referenced != capacity {self.capacity}")
