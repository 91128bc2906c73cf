"""Paged KV pool: fixed-size token pages and per-request block tables,
and the host-RAM tier for parked pages (port of the reference's
``serving/kv_pool.py``).

Pure accounting, no tensors: the :class:`~.engine.ServingEngine` owns the
physical ``[num_pages, page_tokens, kv_heads, head_dim]`` arenas and
indexes them with the tables handed out here.  Page 0 is RESERVED as the
trash page: idle batch rows of a decode step write their (ignored) k/v
there.  Pages carry copy-on-write refcounts (``incref``/``decref``/
``adopt``): a page returns to the free list when its last reference drops.

A request preempted under pool pressure can be PARKED (``swap_out``): its
private pages return to the free list once the engine has copied their
bytes into :class:`OffloadPool` frames, and its shared pages keep the
request's reference, so their one resident copy serves every holder.
``swap_in`` rebuilds the table, all or nothing.

Env: ``PADDLE_TPU_PAGE_TOKENS`` sets the default page size (tokens per
page, 16); ``PADDLE_TPU_KV_OFFLOAD_PAGES`` the host tier's budget in pages
(64).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

__all__ = ["PagedKVPool", "OffloadPool", "PoolExhausted",
           "default_page_tokens", "default_offload_pages", "TRASH_PAGE"]

TRASH_PAGE = 0


def default_page_tokens() -> int:
    return int(os.environ.get("PADDLE_TPU_PAGE_TOKENS", "16"))


def default_offload_pages() -> int:
    """Host-RAM offload tier capacity in pages
    (``PADDLE_TPU_KV_OFFLOAD_PAGES``, default 64)."""
    return int(os.environ.get("PADDLE_TPU_KV_OFFLOAD_PAGES", "64"))


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
        # parked requests: rid -> per-slot plan, a page id where the slot's
        # page is shared (the rid's reference is kept) or None where its
        # bytes went to the host tier
        self._parked: Dict[object, List[Optional[int]]] = {}
        self._peak_used = 0
        # byte accountant (the engine fills it in via set_page_bytes)
        self.bytes_per_page = 0
        self.scale_bytes_per_page = 0
        self.kv_dtype = "bf16"
        self.shards = 1

    # -- byte accounting ---------------------------------------------------
    def set_page_bytes(self, arena_bytes: int, scale_bytes: int = 0,
                       kv_dtype: str = "bf16", shards: int = 1) -> None:
        """Record what one page costs on the device (across all layers,
        k+v, plus any scale planes), in all; ``shards``: the members of a
        tensor-parallel engine, each holding an equal share of every page
        (its kv heads)."""
        self.bytes_per_page = int(arena_bytes)
        self.scale_bytes_per_page = int(scale_bytes)
        self.kv_dtype = str(kv_dtype)
        self.shards = int(shards)

    def pool_bytes(self) -> int:
        """Device bytes held by the allocatable pages (trash page excluded)."""
        return self.capacity * (self.bytes_per_page + self.scale_bytes_per_page)

    def used_bytes(self) -> int:
        return self.pages_used * (self.bytes_per_page + self.scale_bytes_per_page)

    def bytes_per_token(self) -> float:
        """Device bytes one token slot costs (arena + scales, all layers)."""
        return (self.bytes_per_page + self.scale_bytes_per_page) \
            / max(self.page_tokens, 1)

    def member_bytes_per_token(self) -> float:
        """What one token slot costs each member of a tensor-parallel
        engine: :meth:`bytes_per_token` over the members."""
        return self.bytes_per_token() / self.shards

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

    # -- parking for the host-RAM offload tier ------------------------------
    def swap_out(self, rid) -> List[Optional[int]]:
        """Park ``rid``'s table and return the per-slot plan.  Private pages
        (this table holds the only reference) return to the free list —
        the CALLER must have copied their bytes to the :class:`OffloadPool`
        first — and park as ``None``.  Shared pages keep the rid's
        reference (no other holder's free can drop them while the request
        is parked) and park as their page id: their one resident copy
        serves every holder, so they never copy."""
        if rid not in self._tables:
            raise KeyError(f"swap_out of unknown request {rid!r}")
        if rid in self._parked:
            raise KeyError(f"swap_out of already-parked request {rid!r}")
        plan: List[Optional[int]] = []
        for p in self._tables.pop(rid):
            if self._refs.get(p, 0) > 1:
                plan.append(p)
            else:
                self.decref([p])
                plan.append(None)
        self._parked[rid] = plan
        return list(plan)

    def swap_in(self, rid) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Un-park ``rid``: rebuild its block table and return ``(table,
        refill)``, ``refill`` the ``(slot, new page)`` pairs the caller must
        restore from the :class:`OffloadPool` frames.  All or nothing:
        raises :class:`PoolExhausted`, leaving the request parked, when the
        private slots cannot all be allocated."""
        if rid not in self._parked:
            raise KeyError(f"swap_in of unparked request {rid!r}")
        plan = self._parked[rid]
        need = sum(1 for p in plan if p is None)
        if len(self._free) < need:
            raise PoolExhausted(
                f"swap_in needs {need} pages, {len(self._free)} free "
                f"({self.pages_used}/{self.capacity} in use)")
        del self._parked[rid]
        table: List[int] = []
        refill: List[Tuple[int, int]] = []
        for j, p in enumerate(plan):
            if p is None:
                p = self._free.pop()
                self._refs[p] = 1
                refill.append((j, p))
            table.append(int(p))
        self._tables[rid] = table
        self._peak_used = max(self._peak_used, self.pages_used)
        return list(table), refill

    def drop_parked(self, rid) -> int:
        """Abandon a parked request whose host frames are gone (the engine
        re-prefills it instead): release its retained shared-page
        references; returns how many pages returned to the free list."""
        if rid not in self._parked:
            raise KeyError(f"drop_parked of unparked request {rid!r}")
        plan = self._parked.pop(rid)
        return self.decref([p for p in reversed(plan) if p is not None])

    def is_parked(self, rid) -> bool:
        return rid in self._parked

    def parked_plan(self, rid) -> List[Optional[int]]:
        """The per-slot park plan (page id for a resident shared slot,
        ``None`` for a slot whose bytes went to the host tier)."""
        return list(self._parked[rid])

    def check_leaks(self, allow_shared: bool = False) -> None:
        """Assert the quiesced-pool invariant: no table or parked request
        left behind, and the free list plus the referenced pages partition
        ``{1..num_pages-1}`` exactly (a shared page counts once).  With
        ``allow_shared`` (a live prefix cache), surviving references are
        legal."""
        if self._tables:
            raise AssertionError(
                f"leaked block tables: { {k: len(v) for k, v in self._tables.items()} }")
        if self._parked:
            raise AssertionError(
                f"leaked parked requests: { {k: len(v) for k, v in self._parked.items()} }")
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


class OffloadPool:
    """Host-RAM tier for the page frames of parked requests, under a page
    budget (``PADDLE_TPU_KV_OFFLOAD_PAGES``).

    A frame is one page across every layer: a dict from arena plane
    (``k``, ``v`` and, for int8 pages, ``ks``, ``vs``) to a host array
    ``[layers, page_tokens, ...]``.  A spill fills a staging slot first and
    :meth:`publish` inserts it as one dict insert, so a recall never reads
    a torn frame.  Eviction is LRU over frames; the engine re-stamps
    (:meth:`touch`) a parked request's frames as it nears re-admission.  A
    drop is LOSS, not corruption: :meth:`put` returns the dropped owners,
    and the engine re-prefills those requests (an "offload stall")."""

    def __init__(self, max_pages: Optional[int] = None):
        self.max_pages = int(max_pages if max_pages is not None
                             else default_offload_pages())
        # (rid, slot) -> frame {plane: host array [layers, ...]}
        self._frames: "OrderedDict[Tuple[object, int], dict]" = OrderedDict()
        self._staging: Optional[Tuple[Tuple[object, int], dict]] = None
        self.pages_out = 0        # frames spilled to host
        self.pages_in = 0         # frames recalled to the device
        self.pages_dropped = 0    # frames LRU-dropped (recall impossible)
        self.bytes_out = 0
        self.bytes_in = 0

    # -- capacity ----------------------------------------------------------
    def frames_held(self) -> int:
        return len(self._frames)

    def holds(self, rid, slot: int) -> bool:
        return (rid, slot) in self._frames

    @staticmethod
    def _frame_bytes(frame: dict) -> int:
        return sum(int(v.nbytes) for v in frame.values())

    # -- spill -------------------------------------------------------------
    def stage(self, rid, slot: int, frame: dict) -> None:
        """Phase one of a spill: park the host copy in the staging slot.
        Nothing is recallable until :meth:`publish`."""
        self._staging = ((rid, int(slot)), frame)

    def publish(self) -> List[Tuple[object, int]]:
        """Phase two: insert the staged frame, then trim to the budget.
        Returns the (rid, slot) owners of the LRU-dropped frames."""
        if self._staging is None:
            raise RuntimeError("publish with no staged frame")
        key, frame = self._staging
        self._staging = None
        self._frames[key] = frame
        self._frames.move_to_end(key)
        self.pages_out += 1
        self.bytes_out += self._frame_bytes(frame)
        dropped: List[Tuple[object, int]] = []
        while len(self._frames) > self.max_pages:
            k, _ = self._frames.popitem(last=False)
            self.pages_dropped += 1
            dropped.append(k)
        return dropped

    def put(self, rid, slot: int, frame: dict) -> List[Tuple[object, int]]:
        """Stage and publish in one call."""
        self.stage(rid, slot, frame)
        return self.publish()

    # -- recall ------------------------------------------------------------
    def get(self, rid, slot: int) -> Optional[dict]:
        """Pop and return the frame of ``(rid, slot)``, or ``None`` if it
        was LRU-dropped (the caller must re-prefill)."""
        frame = self._frames.pop((rid, int(slot)), None)
        if frame is not None:
            self.pages_in += 1
            self.bytes_in += self._frame_bytes(frame)
        return frame

    def touch(self, rid) -> int:
        """Re-stamp every frame of ``rid`` as most recently useful (``rid``
        nears re-admission); returns how many frames were stamped."""
        keys = [k for k in self._frames if k[0] == rid]
        for k in keys:
            self._frames.move_to_end(k)
        return len(keys)

    def drop(self, rid) -> int:
        """Discard every frame of ``rid``; returns how many were dropped."""
        keys = [k for k in self._frames if k[0] == rid]
        for k in keys:
            del self._frames[k]
        return len(keys)

    def summary(self) -> dict:
        return {"frames_held": len(self._frames),
                "max_pages": self.max_pages,
                "pages_out": self.pages_out, "pages_in": self.pages_in,
                "pages_dropped": self.pages_dropped,
                "bytes_out": self.bytes_out, "bytes_in": self.bytes_in}
