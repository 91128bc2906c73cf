"""Continuous-batching serving engine over a paged KV pool, on one card
(port of the reference's ``serving/engine.py``: ``Request`` and
``ServingEngine``).

- **Physical cache**: per layer, ``k``/``v`` page arenas of shape
  ``[num_pages, page_tokens, kv_heads, head_dim]`` on the model's device,
  updated IN PLACE (``index_put_``) by every step; int8 pages add f32 scale
  arenas ``ks``/``vs`` of shape ``[num_pages, page_tokens, kv_heads]``, fp8
  pages share one static scale.  The reference donates the arenas to its
  two compiled XLA programs; an eager step writes them where they lie.
- **Decode step**: every active request is a row of one batch of
  ``max_batch`` rows; a row's block table gathers its pages into a
  ``[rows, pages_per_seq * page_tokens, kv, d]`` view masked by the row's
  position.  Idle rows point at the trash page.
- **Prefill**: prompts stream through in ``page_tokens``-sized chunks,
  each filling one page; junk tail slots of the last chunk are overwritten
  by the first decode steps before the position mask exposes them.
- **Context-parallel prefill** (``cp`` > 1, ``PADDLE_TPU_SERVE_CP``): a
  prompt of at least ``cp`` page-chunks prefills in ONE forward over the
  whole prompt, zero-padded to a multiple of ``cp`` chunks, whose attention
  is ``ring_attention`` over a ``sep`` ring of ``cp`` members (B10); its
  k/v land in the pages where the chunked path would put them, pad chunks
  in the trash page.  The reference needs one device per ring member (XLA's
  SPMD); one process drives the port's ring, so member i sits on visible
  card ``i mod n_cards`` (``cp_devices``), and several members may share
  one card.  The projections and the MLP run on the model's card.
- **Paged attention** is what the reference computes: scatter this step's
  k/v (quantized on the scatter for int8/fp8 pages), gather ``arena[tables]``
  (dequantized at the gather), then a grouped einsum with f32 accumulation
  under the ``col <= pos`` mask.  As in the reference, it calls none of the
  decode kernels (B6, B8, B9): the forward's kernels are RMSNorm (B1) and
  the rotary embedding (B2), on the card.
- **Scheduler**: FIFO admission gated on free pages, bounded long-prompt
  deferral, eviction under pool pressure (youngest-admitted victim, or the
  most-slack one when deadlines are attached; the evictee requeues at the
  front and recomputes from its prompt, token-exact because decoding is
  greedy), deadline shedding, a circuit breaker, per-request SLO
  milestones in :class:`~.metrics.SLOMeter`.

Not ported yet, and raising ``NotImplementedError`` that names the ROADMAP
item: speculative decoding (A2), tensor-parallel decode (``tp`` > 1, A6),
the host-RAM offload tier, the prefix cache, the
journal and crash recovery (``journal``, ``journal_ship``, ``recover``),
disaggregated prefill (``submit_prefilled``, ``prefill_export``, A8) and
the decode-loop watchdog (A7).  The reference's chaos seams
(``_faults.fire``) and telemetry events wait for A7 and A8.

Env knobs: ``PADDLE_TPU_SERVE_MAX_BATCH`` (rows, default 4),
``PADDLE_TPU_PAGE_TOKENS`` (page size, default 16),
``PADDLE_TPU_SERVE_PAGES`` (arena pages incl. the trash page, default 64),
``PADDLE_TPU_SERVE_MAX_PAGES_PER_SEQ`` (per-request budget, default 8),
``PADDLE_TPU_SERVE_MAX_QUEUE``, ``PADDLE_TPU_SERVE_BREAKER_THRESHOLD`` /
``_COOLDOWN`` (admission), ``PADDLE_TPU_SERVE_MAX_STEP_FAILURES``
(consecutive absorbed step failures, default 8),
``PADDLE_TPU_SERVE_DEFER_LOOKAHEAD`` / ``_DEFER_MAX`` (long-prompt
deferral window / starvation cap), ``PADDLE_TPU_KV_DTYPE`` and
``PADDLE_TPU_KV_FP8_SCALE`` (pages), ``PADDLE_TPU_SERVE_CP`` (ring members
of the context-parallel prefill, default 1).
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import devices
from ..distributed.meta_parallel.context_parallel import ring_attention
from ..distributed.topology import build_mesh
from ..models.llama import apply_rotary_at_positions
from .admission import AdmissionController, Deadline, Overloaded, _env_float, _env_int
from .kv_pool import PagedKVPool, PoolExhausted, TRASH_PAGE, default_page_tokens
from .kv_quant import (default_fp8_scale, dequantize_kv, dequantize_kv_fp8,
                       kv_cache_dtype, kv_page_bytes, kv_scale_page_bytes,
                       quantize_kv, quantize_kv_fp8)
from .metrics import SLOMeter

__all__ = ["Request", "ServingEngine"]

QUEUED, RUNNING, FINISHED, SHED = "queued", "running", "finished", "shed"
_F32_MIN = torch.finfo(torch.float32).min


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"ServingEngine: {what} is not ported to paddle_tpu_torch yet "
        f"(ROADMAP {item})")


class Request:
    """One generation request riding the engine."""

    _next_rid = 0

    def __init__(self, prompt, max_new_tokens: int,
                 eos_token_id: Optional[int],
                 rid: Optional[int] = None,
                 trace_id: Optional[str] = None):
        if rid is None:
            rid = Request._next_rid
            Request._next_rid += 1
        else:
            rid = int(rid)
            Request._next_rid = max(Request._next_rid, rid + 1)
        self.rid = rid
        self.trace_id = trace_id
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.eos_token_id = None if eos_token_id is None else int(eos_token_id)
        self.state = QUEUED
        self.generated: List[int] = []
        self.row: Optional[int] = None
        self.evictions = 0
        self.deadline: Optional[Deadline] = None
        self.delivered = 0                    # client-visible high-water mark
        self.delivered_tokens: List[int] = []
        self.defers = 0                       # FIFO-head bypasses suffered

    @property
    def pos(self) -> int:
        """Cache position the NEXT decode step writes (the position of the
        last generated token)."""
        return len(self.prompt) + len(self.generated) - 1

    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens or (
            self.eos_token_id is not None and bool(self.generated)
            and self.generated[-1] == self.eos_token_id)


class ServingEngine:
    """Continuous batching over a llama-family causal LM (``model.llama``
    with ``layers``/``embed_tokens``/``norm`` and the rope tables), on the
    model's device: the card, or the CPU for a model made there.  Greedy
    decoding — determinism is what makes eviction replay token-exact.

    ``kv_dtype``: ``"bf16"`` (the model's own floating dtype, exact),
    ``"int8"`` (per-token scales) or ``"fp8"`` (e4m3 under
    ``PADDLE_TPU_KV_FP8_SCALE``); default ``PADDLE_TPU_KV_DTYPE``.
    ``lint``: the reference's donation lint inspects its compiled XLA
    decode program, which the port does not have (its arenas are updated
    in place by eager steps): only ``None`` and ``False`` are accepted.
    ``cp`` > 1: prompts of at least ``cp`` page-chunks prefill in one
    forward with ring attention over ``cp`` members (module docstring);
    ``cp`` with ``tp`` > 1 raises ``ValueError``, as in the reference.
    ``speculative``, ``tp`` > 1, ``offload``, ``prefix_cache``,
    ``journal`` and ``journal_ship`` raise ``NotImplementedError``, also
    when their environment variables turn them on."""

    def __init__(self, model, *, max_batch: Optional[int] = None,
                 page_tokens: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_pages_per_seq: Optional[int] = None,
                 lint: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 admission: Optional[AdmissionController] = None,
                 journal=None, journal_ship=None, on_token=None, now=None,
                 kv_dtype: Optional[str] = None, speculative=None,
                 tp: Optional[int] = None, prefix_cache=None,
                 cp: Optional[int] = None, offload=None):
        base = getattr(model, "llama", None)
        if base is None or not hasattr(base, "layers"):
            raise TypeError(
                "ServingEngine serves llama-family causal LMs "
                "(model.llama.layers); got " + type(model).__name__)
        if speculative or (speculative is None
                           and _env_int("PADDLE_TPU_SPEC_K", 0) > 0):
            raise _not_ported("speculative decoding", "A2")
        tp = int(tp if tp is not None else _env_int("PADDLE_TPU_SERVE_TP", 1))
        self.cp = int(cp if cp is not None else _env_int("PADDLE_TPU_SERVE_CP", 1))
        if self.cp > 1 and tp > 1:
            raise ValueError(
                f"PADDLE_TPU_SERVE_CP={self.cp} cannot combine with "
                f"PADDLE_TPU_SERVE_TP={tp}: the serving mesh is one axis "
                f"(shard prompts OR heads, not both yet)")
        if tp > 1:
            raise _not_ported("tensor-parallel decode (tp > 1)", "A6")
        if offload or (offload is None
                       and os.environ.get("PADDLE_TPU_KV_OFFLOAD", "0") == "1"):
            raise _not_ported("the host-RAM KV offload tier (offload=)", "A1")
        if prefix_cache or (prefix_cache is None and
                            os.environ.get("PADDLE_TPU_PREFIX_CACHE", "0") == "1"):
            raise _not_ported("the prefix cache (prefix_cache=)", "A1")
        if journal is not None or journal_ship is not None:
            raise _not_ported("the serving journal (journal=, journal_ship=)", "A1")
        if lint:
            raise ValueError(
                "ServingEngine(lint=True): the donation lint checks the "
                "reference's compiled XLA decode program; the port's eager "
                "steps update the arenas in place and compile nothing")
        self.model = model
        self.max_batch = max_batch if max_batch is not None else \
            _env_int("PADDLE_TPU_SERVE_MAX_BATCH", 4)
        P = page_tokens if page_tokens is not None else default_page_tokens()
        N = num_pages if num_pages is not None else \
            _env_int("PADDLE_TPU_SERVE_PAGES", 64)
        MP = max_pages_per_seq if max_pages_per_seq is not None else \
            _env_int("PADDLE_TPU_SERVE_MAX_PAGES_PER_SEQ", 8)
        max_pos = model.config.max_position_embeddings
        if MP * P > max_pos:
            MP = max(1, max_pos // P)
        self.page_tokens, self.num_pages, self.max_pages_per_seq = P, N, MP
        self.pool = PagedKVPool(N, P)
        self._now = now if now is not None else time.monotonic
        self.meter = SLOMeter(now=self._now)
        self.admission = admission if admission is not None else \
            AdmissionController(max_queue=max_queue, now=self._now)
        self._on_token = on_token

        param = next(p for p in model.parameters() if p.is_floating_point())
        self._cdt, self.device = param.dtype, param.device
        # the ring members of the CP prefill, round-robin over the visible
        # devices of the model's type (a departure from the reference,
        # which needs cp devices: one process drives this ring)
        cards = devices(self.device.type) if self.cp > 1 else [self.device]
        self.cp_devices = [cards[i % len(cards)] for i in range(self.cp)]
        self._mesh = build_mesh(sep=self.cp, devices=self.cp_devices) \
            if self.cp > 1 else None
        self.cp_prefills = 0                     # prompts the ring prefilled
        self.cp_fallbacks: Dict[str, int] = {}   # gate reason -> count
        n_layers, kv_heads, head_dim = model._kv_cache_spec()
        self._arena_shape = (N, P, kv_heads, head_dim)
        self.kv_dtype = kv_cache_dtype(kv_dtype)
        self._fp8_scale = default_fp8_scale() if self.kv_dtype == "fp8" else None
        adt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(self.kv_dtype,
                                                                   self._cdt)

        def zeros(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=self.device)
                    for _ in range(n_layers)]

        self._arenas: Dict[str, List[torch.Tensor]] = {
            "k": zeros(self._arena_shape, adt), "v": zeros(self._arena_shape, adt)}
        self._scale_bytes = 0
        if self.kv_dtype == "int8":
            sshape = (N, P, kv_heads)
            self._arenas["ks"] = zeros(sshape, torch.float32)
            self._arenas["vs"] = zeros(sshape, torch.float32)
            self._scale_bytes = 2 * n_layers * int(np.prod(sshape)) * 4
        self._arena_bytes = 2 * n_layers * int(np.prod(self._arena_shape)) \
            * self._arenas["k"][0].element_size()
        self.pool.set_page_bytes(
            kv_page_bytes(P, kv_heads, head_dim, self.kv_dtype, n_layers=n_layers),
            kv_scale_page_bytes(P, kv_heads, self.kv_dtype, n_layers=n_layers),
            self.kv_dtype)
        self.meter.set_kv_bytes_per_token(self.pool.bytes_per_token())

        self._queue: deque = deque()
        self._active: Dict[int, Request] = {}          # row -> Request
        self._results: Dict[int, np.ndarray] = {}
        self.shed: Dict[int, str] = {}                 # rid -> reason
        self.last_decode_logits = None   # host copy of the latest decode
        # step's logits [R, 1, V] (f32)
        self.steps_total = 0
        self.first_step_wall: Optional[float] = None
        self._pending_delivery: List[tuple] = []       # (rid, idx, token)
        self._work = threading.Event()
        self._stop_flag = False
        self._step_failures = 0
        self._max_step_failures = _env_int(
            "PADDLE_TPU_SERVE_MAX_STEP_FAILURES", 8)
        self._defer_lookahead = _env_int(
            "PADDLE_TPU_SERVE_DEFER_LOOKAHEAD", 4)
        self._defer_max = _env_int("PADDLE_TPU_SERVE_DEFER_MAX", 8)

    # -- public API --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None, *,
               deadline: Optional[Deadline] = None,
               rid: Optional[int] = None,
               delivered_tokens: Optional[List[int]] = None,
               age_s: float = 0.0,
               trace_id: Optional[str] = None) -> int:
        """Admit a request or refuse it.  Raises ``ValueError`` for a
        request the engine could NEVER serve (malformed, a known rid, or a
        worst-case page demand beyond the per-request budget or the whole
        pool), :class:`Overloaded` for one it cannot serve NOW (bounded
        queue full, circuit breaker open), with ``retry_after_s``.

        ``delivered_tokens`` / ``age_s``: a request replayed from elsewhere
        arrives with the tokens its client already saw (regenerated, not
        re-emitted) and the age its deadlines keep counting from.
        ``trace_id``: its trace id (a fresh one is minted when absent)."""
        trace_id = trace_id or os.urandom(8).hex()
        r = Request(prompt, max_new_tokens, eos_token_id, rid=rid,
                    trace_id=trace_id)
        if rid is not None and (
                rid in self._results or rid in self.shed or
                any(q.rid == rid for q in list(self._queue)) or
                any(a.rid == rid for a in list(self._active.values()))):
            raise ValueError(f"rid {rid} already known to this engine")
        if deadline is not None and not isinstance(deadline, Deadline):
            raise TypeError("deadline must be a serving.Deadline")
        r.deadline = deadline
        budget = self.max_pages_per_seq * self.page_tokens
        if len(r.prompt) + r.max_new_tokens > budget:
            raise ValueError(
                f"prompt ({len(r.prompt)}) + max_new_tokens "
                f"({r.max_new_tokens}) exceeds the per-request page budget "
                f"{budget} (= {self.max_pages_per_seq} pages x "
                f"{self.page_tokens} tokens)")
        need_max = self.pool.pages_for(len(r.prompt) + r.max_new_tokens)
        if need_max > self.pool.capacity:
            # admitted, an unservable request would block the FIFO head
            # forever or evict everyone and still starve mid-decode
            raise ValueError(
                f"request needs up to {need_max} pages but the pool only "
                f"has {self.pool.capacity} — raise PADDLE_TPU_SERVE_PAGES "
                f"or lower max_new_tokens")
        try:
            self.admission.check(len(self._queue), self.meter)
        except Overloaded as e:
            self.meter.reject(reason=e.reason, retry_after_s=e.retry_after_s)
            raise
        if delivered_tokens:
            r.delivered = len(delivered_tokens)
            r.delivered_tokens = [int(t) for t in delivered_tokens]
        self._queue.append(r)
        self.meter.submit(r.rid, age_s=age_s, trace_id=trace_id)
        self.meter.set_queue_depth(len(self._queue))
        self._work.set()
        return r.rid

    def submit_prefilled(self, *args, **kwargs) -> int:
        """Admit a request prefilled on a prefill-tier worker: not ported."""
        raise _not_ported("disaggregated prefill (submit_prefilled)", "A8")

    def prefill_export(self, prompt):
        """Prefill and export the pages for another engine: not ported."""
        raise _not_ported("disaggregated prefill (prefill_export)", "A8")

    def recover(self) -> dict:
        """Replay a journal after a crash: not ported (no journal)."""
        raise _not_ported("journal replay (recover)", "A1")

    def run(self, max_steps: int = 100000, *, forever: bool = False,
            watchdog_s: Optional[float] = None,
            on_wedge=None) -> Dict[int, np.ndarray]:
        """Drive the scheduler; returns {rid: generated token array}.

        ``forever=False`` returns once every submitted request finished
        (or was shed) and checks that the pool quiesced with no leaked
        page.  ``forever=True`` keeps serving, idling on an event that
        ``submit`` sets, until :meth:`stop`.  ``watchdog_s`` > 0 (or
        ``PADDLE_TPU_SERVE_WATCHDOG_S``) needs the decode-loop watchdog,
        which is not ported."""
        if watchdog_s is None:
            watchdog_s = _env_float("PADDLE_TPU_SERVE_WATCHDOG_S", 0.0)
        if watchdog_s and watchdog_s > 0:
            raise _not_ported("the decode-loop watchdog (watchdog_s > 0)", "A7")
        steps = 0
        self._stop_flag = False
        while True:
            if not self._queue and not self._active:
                if self._undelivered():
                    self.step()
                    continue
                if not forever or self._stop_flag:
                    break
                self._work.wait()        # event-gated idle: no spin
                self._work.clear()
                continue
            self.step()
            steps += 1
            if not forever and steps > max_steps:
                raise RuntimeError(f"serving loop did not quiesce in "
                                   f"{max_steps} steps")
        self.pool.check_leaks()
        return dict(self._results)

    def serve_forever(self, **kw) -> Dict[int, np.ndarray]:
        """``run(forever=True)``: serve until :meth:`stop`."""
        return self.run(forever=True, **kw)

    def stop(self) -> None:
        """Ask a ``forever`` loop to return once it drains to idle."""
        self._stop_flag = True
        self._work.set()

    def step(self) -> None:
        """One scheduler iteration: shed what cannot meet its deadline,
        admit what fits, prefill the newly admitted, take one decode step
        for every active row, retire finished rows, then surface newly
        delivered tokens to the sink.

        ``OSError``-class failures are absorbed: the circuit breaker counts
        them and the next step retries; after
        ``PADDLE_TPU_SERVE_MAX_STEP_FAILURES`` consecutive ones the error
        propagates."""
        self.steps_total += 1
        try:
            did_work = self._step_inner()
        except OSError:
            self._step_failures += 1
            self.admission.breaker.note_failure()
            if self._step_failures >= self._max_step_failures:
                raise
            return
        if did_work:
            self._step_failures = 0
            self.admission.breaker.note_success()
            if self.first_step_wall is None:
                self.first_step_wall = time.time()

    def _undelivered(self) -> bool:
        """Tokens still awaiting delivery to the sink."""
        return bool(self._pending_delivery)

    def _step_inner(self) -> bool:
        self._shed_scan()
        self._admit()
        did_work = self._undelivered()
        for r in [r for r in self._active.values() if not r.generated]:
            self._prefill(r)
            did_work = True
            self._retire_if_done(r)
        if self._active:
            self._decode_step()
            did_work = True
        self._flush_delivery()
        self.meter.set_queue_depth(len(self._queue))
        self.meter.set_occupancy(self.pool.occupancy())
        return did_work

    # -- scheduling --------------------------------------------------------
    def _free_rows(self) -> List[int]:
        return [i for i in range(self.max_batch) if i not in self._active]

    def _shed_scan(self) -> None:
        """Drop queued requests whose deadline can no longer be met.
        Active requests are never shed (a miss is counted at finish)."""
        # snapshot + in-place removal: submit() may append from another
        # thread while a forever-mode engine steps
        for r in list(self._queue):
            reason = self.admission.shed_reason(
                submit_t=self.meter.clock(r.rid).submit_t,
                deadline=r.deadline, first_token_out=r.delivered > 0,
                meter=self.meter)
            if reason is not None:
                self._queue.remove(r)
                self._shed(r, reason)

    def _shed(self, r: Request, reason: str) -> None:
        r.state = SHED
        self.shed[r.rid] = reason
        self.meter.shed(r.rid, reason=reason)

    def _admit_need(self, r: Request) -> int:
        """Pages to allocate when admitting ``r``: its prompt and the slot
        of its first decode write."""
        return self.pool.pages_for(len(r.prompt) + 1)

    def _admit(self) -> None:
        rows = self._free_rows()
        while self._queue and rows:
            r = self._queue[0]
            need = self._admit_need(r)
            if not self.pool.can_alloc(need):
                # pool pressure: a long prompt at the head must not wedge
                # admission — try ONE shorter request from the lookahead
                # window (bounded per-head bypass budget, no starvation)
                if not self._admit_bypass(r, need, rows):
                    break
                continue
            self._admit_one(r, need, rows, from_head=True)

    def _admit_one(self, r: Request, need: int, rows: List[int],
                   *, from_head: bool) -> None:
        if from_head:
            self._queue.popleft()
        else:
            self._queue.remove(r)
        self.pool.alloc(r.rid, need)
        r.row = rows.pop(0)
        r.state = RUNNING
        self._active[r.row] = r
        self.meter.admit(r.rid, queue_depth=len(self._queue), pages=need)
        self.meter.set_occupancy(self.pool.occupancy())

    def _admit_bypass(self, head: Request, head_need: int,
                      rows: List[int]) -> bool:
        """Pool-pressure deferral of long prompts: when the FIFO head does
        not fit, admit one STRICTLY smaller request from the next
        ``PADDLE_TPU_SERVE_DEFER_LOOKAHEAD`` queue slots instead.  The head
        keeps its place and can be bypassed at most
        ``PADDLE_TPU_SERVE_DEFER_MAX`` times."""
        if head.defers >= self._defer_max:
            return False
        window = min(len(self._queue), self._defer_lookahead + 1)
        for i in range(1, window):
            c = self._queue[i]
            need = self._admit_need(c)
            if need < head_need and self.pool.can_alloc(need):
                head.defers += 1
                self.meter.defer(head.rid, defers=head.defers,
                                 need=head_need, free=self.pool.pages_free)
                self._admit_one(c, need, rows, from_head=False)
                return True
        return False

    def _evict(self, victim: Request) -> None:
        """Preempt ``victim``: free its pages, requeue it at the front; the
        greedy replay regenerates the same tokens (those the client already
        saw are not re-delivered: ``delivered`` is the high-water mark)."""
        freed = self.pool.free(victim.rid)
        del self._active[victim.row]
        victim.row = None
        victim.state = QUEUED
        victim.generated = []        # replayed from the prompt on re-admit
        victim.evictions += 1
        self._queue.appendleft(victim)
        self.meter.evict(victim.rid, reason="pool_pressure", pages_freed=freed)

    def _preempt(self, victim: Request) -> None:
        """A pool-pressure preemption: without the host-RAM offload tier
        (not ported) it is the eviction replay."""
        self._evict(victim)

    def _victim_key(self, x: Request):
        """Eviction preference under pool pressure, largest key loses:
        requests without deadlines first, youngest-admitted first; among
        deadline-carrying ones, the one with the MOST remaining slack."""
        c = self.meter.clock(x.rid)
        budgets = []
        if x.deadline is not None:
            if x.deadline.total_s is not None:
                budgets.append(c.submit_t + x.deadline.total_s)
            if x.deadline.ttft_s is not None and x.delivered == 0:
                budgets.append(c.submit_t + x.deadline.ttft_s)
        if not budgets:
            return (1, c.admit_t or 0.0, x.rid)
        return (0, min(budgets) - self._now(), x.rid)

    def _ensure_page(self, r: Request, n_tok: int = 1) -> bool:
        """Make sure pages covering ``r.pos .. r.pos + n_tok - 1`` exist.
        Under pool pressure an active request is preempted (see
        :meth:`_victim_key`); when ``r`` itself is chosen it self-preempts
        (returns False) and waits in the queue."""
        need = (r.pos + max(int(n_tok), 1) - 1) // self.page_tokens + 1
        while len(self.pool.table(r.rid)) < need:
            if self.pool.can_alloc(1):
                self.pool.alloc(r.rid, 1)
                continue
            live = [x for x in self._active.values() if x.state == RUNNING]
            if live == [r]:  # r alone owns the pool and still starves
                raise PoolExhausted(
                    f"request {r.rid} needs page {need} but the pool is "
                    f"exhausted — raise PADDLE_TPU_SERVE_PAGES or lower "
                    f"the per-request budget")
            victim = max(live, key=self._victim_key)
            self._preempt(victim)
            if victim is r:
                return False
        return True

    def _retire_if_done(self, r: Request) -> None:
        if not r.done():
            return
        self.pool.free(r.rid)
        del self._active[r.row]
        r.row = None
        r.state = FINISHED
        self._results[r.rid] = np.asarray(r.generated, np.int32)
        self.meter.finish(r.rid, n_tokens=len(r.generated),
                          deadline=r.deadline)
        self.meter.set_occupancy(self.pool.occupancy())

    # -- prefill and decode ------------------------------------------------
    def _padded_table(self, rid) -> np.ndarray:
        t = np.full((self.max_pages_per_seq,), TRASH_PAGE, np.int32)
        pages = self.pool.table(rid)
        t[:len(pages)] = pages
        return t

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

    def _prefill_chunks(self, prompt, table) -> np.ndarray:
        """Run ``prompt`` through the forward in page-sized chunks over the
        block table ``table`` [1, max_pages_per_seq]; returns the last
        prompt token's logits [V] on the host, in f32."""
        P = self.page_tokens
        n_chunks = -(-len(prompt) // P)
        tables = self._tensor(table)
        n_tok = self._tensor([P])          # a full chunk: junk tail slots
        logits = None                      # are overwritten by decode
        for c in range(n_chunks):
            chunk = np.zeros((1, P), np.int64)
            part = prompt[c * P:(c + 1) * P]
            chunk[0, :len(part)] = part
            take = (len(prompt) - 1 - c * P) if c == n_chunks - 1 else 0
            logits = self._forward(self._tensor(chunk), self._tensor([c * P]),
                                   tables, n_tok, take=max(take, 0))
        return logits[0, 0].float().cpu().numpy()

    def _prefill(self, r: Request) -> None:
        if self._cp_accepts(len(r.prompt)):
            logits = self._cp_prefill_run(r.prompt, self.pool.table(r.rid))
        else:
            logits = self._prefill_chunks(r.prompt, self._padded_table(r.rid)[None])
        tok = int(np.argmax(logits))
        r.generated.append(tok)
        self.meter.first_token(r.rid)
        self._deliver(r, tok)

    # -- context-parallel prefill ---------------------------------------------
    def _cp_accepts(self, n_prompt: int) -> bool:
        """Gate of the CP prefill.  A prompt of fewer page-chunks than ring
        members takes the chunked path (reason ``short_prompt``, counted in
        ``cp_fallbacks``): some members would hold only padding.  The
        reference's ``prefix_cached`` and ``kv_import`` reasons cannot arise
        (the prefix cache and page import are not ported)."""
        if self.cp <= 1:
            return False
        if -(-n_prompt // self.page_tokens) < self.cp:
            self.cp_fallbacks["short_prompt"] = self.cp_fallbacks.get("short_prompt", 0) + 1
            return False
        return True

    def _cp_prefill_run(self, prompt, pages) -> np.ndarray:
        """Prefill ``prompt`` over its allocated ``pages`` in one forward:
        the chunk count pads up to a multiple of ``cp`` so the ring divides
        evenly, and pad chunks carry token 0 into the trash page.  Returns
        the last prompt token's logits [V] on the host, in f32."""
        P = self.page_tokens
        n_chunks = -(-len(prompt) // P)
        nc_pad = -(-n_chunks // self.cp) * self.cp
        tokens = np.zeros((1, nc_pad * P), np.int64)
        tokens[0, :len(prompt)] = prompt
        table = np.full((nc_pad,), TRASH_PAGE, np.int64)
        table[:n_chunks] = pages[:n_chunks]
        logits = self._cp_forward(self._tensor(tokens), self._tensor(table), len(prompt) - 1)
        self.cp_prefills += 1
        return logits[0, 0].float().cpu().numpy()

    @torch.inference_mode()
    def _cp_forward(self, tokens, table, take: int):
        """The CP prefill's forward: ``tokens`` [1, s] at positions
        ``0 .. s-1``, their k/v into the pages of ``table`` [s / P],
        attention by the ring, and only row ``take`` of the hidden state
        through the lm head.  Returns logits [1, 1, V]."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        page, slot = table[pos // self.page_tokens], pos % self.page_tokens
        return self._layers(tokens, pos[None].to(torch.int32), take,
                            lambda q, k, v, li: self._ring_attention(q, k, v, li, page, slot))

    def _ring_attention(self, q, k, v, li, page, slot):
        """Scatter the whole prompt's k/v [1, s, kv, d] into layer ``li``'s
        pages at (``page``, ``slot``) and attend causally over the ring.
        int8 and fp8 pages are quantized, then dequantized BEFORE the ring:
        the chunked path reads even its own chunk's k/v back from the
        pages, so the ring must attend over the same rounded values to stay
        token-exact."""
        ar = self._arenas
        if self.kv_dtype == "int8":
            (kq, ksc), (vq, vsc) = quantize_kv(k), quantize_kv(v)
            ar["k"][li][page, slot], ar["v"][li][page, slot] = kq[0], vq[0]
            ar["ks"][li][page, slot], ar["vs"][li][page, slot] = ksc[0], vsc[0]
            k, v = dequantize_kv(kq, ksc).to(self._cdt), dequantize_kv(vq, vsc).to(self._cdt)
        elif self.kv_dtype == "fp8":
            kq = quantize_kv_fp8(k, self._fp8_scale)
            vq = quantize_kv_fp8(v, self._fp8_scale)
            ar["k"][li][page, slot], ar["v"][li][page, slot] = kq[0], vq[0]
            k = dequantize_kv_fp8(kq, self._fp8_scale).to(self._cdt)
            v = dequantize_kv_fp8(vq, self._fp8_scale).to(self._cdt)
        else:
            k, v = k.to(self._cdt), v.to(self._cdt)
            ar["k"][li][page, slot], ar["v"][li][page, slot] = k[0], v[0]
        return ring_attention(q, k, v, mesh=self._mesh, causal=True)

    def _decode_step(self) -> None:
        """One serial decode step (S = 1) over every active row; idle rows
        decode token 0 at position 0 into the trash page."""
        R, MP = self.max_batch, self.max_pages_per_seq
        tokens = np.zeros((R, 1), np.int64)
        positions = np.zeros((R,), np.int64)
        n_tok = np.zeros((R,), np.int64)
        tables = np.full((R, MP), TRASH_PAGE, np.int64)
        stepped: List[Request] = []
        for r in [self._active[row] for row in sorted(self._active)]:
            # _ensure_page can evict LATER snapshot entries; skip anything
            # no longer running so an evictee never allocates while queued
            if r.state != RUNNING or r.row is None or r.done():
                continue
            self._ensure_page(r, 1)
        # _ensure_page may have evicted rows; rebuild the live view
        for row, r in sorted(self._active.items()):
            if r.done():
                continue
            tokens[row, 0] = r.generated[-1]
            n_tok[row] = 1
            positions[row] = r.pos
            tables[row] = self._padded_table(r.rid)
            stepped.append(r)
        if not stepped:
            for r in list(self._active.values()):
                self._retire_if_done(r)
            return
        logits = self._forward(self._tensor(tokens), self._tensor(positions),
                               self._tensor(tables), self._tensor(n_tok))
        logits = logits.float().cpu().numpy()               # [R, 1, V]
        self.last_decode_logits = logits
        for r in stepped:
            row_logits = logits[r.row, :1]
            if not np.all(np.isfinite(row_logits)):
                # a corrupted int8 scale (or any cache poisoning) surfaces
                # as NaN/inf logits — fail LOUDLY instead of emitting junk
                raise RuntimeError(
                    f"non-finite decode logits for rid {r.rid} "
                    f"(kv_dtype={self.kv_dtype}): corrupted KV page or "
                    f"scale buffer")
            tok = int(np.argmax(row_logits[0]))
            r.generated.append(tok)
            self.meter.token(r.rid)
            self._deliver(r, tok)
        for r in list(self._active.values()):
            self._retire_if_done(r)

    # -- delivery ----------------------------------------------------------
    def _deliver(self, r: Request, tok: int) -> None:
        """Token bookkeeping right after ``r.generated.append(tok)``: new
        tokens advance the high-water mark and queue for the sink; replayed
        ones (after an eviction) are suppressed and checked against what
        the client already saw — greedy decode is deterministic, so a
        divergence is an engine bug."""
        idx = len(r.generated) - 1
        if idx < r.delivered:
            if r.delivered_tokens[idx] != tok:
                raise RuntimeError(
                    f"replay divergence for rid {r.rid} at token {idx}: "
                    f"regenerated {tok}, client saw "
                    f"{r.delivered_tokens[idx]}")
            return
        r.delivered_tokens.append(tok)
        r.delivered = idx + 1
        self._pending_delivery.append((r.rid, idx, tok))

    def _flush_delivery(self) -> None:
        """Hand the step's new tokens to the sink (``on_token``)."""
        if self._on_token is not None:
            for rid, idx, tok in self._pending_delivery:
                self._on_token(rid, idx, tok)
        self._pending_delivery.clear()

    # -- the forward -------------------------------------------------------
    def _slots(self, tables, positions, n_tok, s: int):
        """Where this step's tokens go and what each may see, the same for
        every layer: the (page, slot) of each of the ``s`` tokens of each
        row (invalid tokens — beyond ``n_tok``, idle rows — go to the trash
        page) and the ``col <= pos`` mask [R, 1, 1, s, C] over a row's
        gathered pages."""
        P, MP = self.page_tokens, tables.shape[1]
        offs = torch.arange(s, device=tables.device)
        pos_js = positions[:, None] + offs[None, :]                 # [R, s]
        valid = offs[None, :] < n_tok[:, None]
        page = torch.gather(tables, 1, (pos_js // P).clamp(0, MP - 1))
        page = torch.where(valid, page, TRASH_PAGE)
        slot = torch.where(valid, pos_js % P, 0)
        col = torch.arange(MP * P, device=tables.device)
        return page, slot, col <= pos_js[:, None, None, :, None]

    def _paged_attention(self, q, k_new, v_new, li, tables, page, slot, visible):
        """Scatter this step's k/v [R, s, kv, d] into layer ``li``'s page
        arenas IN PLACE at (``page``, ``slot``) and attend each row of q
        [R, s, h, d] over its gathered pages where ``visible``.  As the
        reference's grouped einsum: the cache dtype's products with f32
        accumulation (computed in f32 from the same values), junk columns
        masked to exact zeros; int8 pages quantize on the scatter (scales
        into the scale arenas) and dequantize at the gather, fp8 pages
        under the static scale."""
        R, s, h, d = q.shape
        kv = k_new.shape[2]
        C = tables.shape[1] * self.page_tokens
        ar = self._arenas
        kp, vp = ar["k"][li], ar["v"][li]
        if self.kv_dtype == "int8":
            kq, ksc = quantize_kv(k_new)
            vq, vsc = quantize_kv(v_new)
            kp[page, slot], vp[page, slot] = kq, vq
            ar["ks"][li][page, slot], ar["vs"][li][page, slot] = ksc, vsc
            kk = dequantize_kv(kp[tables].reshape(R, C, kv, d),
                               ar["ks"][li][tables].reshape(R, C, kv)).to(self._cdt)
            vv = dequantize_kv(vp[tables].reshape(R, C, kv, d),
                               ar["vs"][li][tables].reshape(R, C, kv)).to(self._cdt)
        elif self.kv_dtype == "fp8":
            kp[page, slot] = quantize_kv_fp8(k_new, self._fp8_scale)
            vp[page, slot] = quantize_kv_fp8(v_new, self._fp8_scale)
            kk = dequantize_kv_fp8(kp[tables].reshape(R, C, kv, d),
                                   self._fp8_scale).to(self._cdt)
            vv = dequantize_kv_fp8(vp[tables].reshape(R, C, kv, d),
                                   self._fp8_scale).to(self._cdt)
        else:
            kp[page, slot] = k_new.to(kp.dtype)
            vp[page, slot] = v_new.to(vp.dtype)
            kk = kp[tables].reshape(R, C, kv, d)
            vv = vp[tables].reshape(R, C, kv, d)
        q5 = q.reshape(R, s, kv, h // kv, d).to(kk.dtype)
        scores = torch.einsum("bskgd,bckd->bkgsc", q5.float(), kk.float()) \
            / math.sqrt(d)
        scores = torch.where(visible, scores, _F32_MIN)
        probs = torch.softmax(scores, dim=-1).to(vv.dtype)
        out = torch.einsum("bkgsc,bckd->bskgd", probs.float(), vv.float())
        return out.reshape(R, s, h, d).to(q.dtype)

    @torch.inference_mode()
    def _forward(self, tokens, positions, tables, n_tok, take=None):
        """The transformer step shared by chunked prefill and decode:
        ``tokens`` [R, s] (decode: s = 1; prefill: R = 1, s = page_tokens)
        at ``positions`` [R] (each row's first token), ``n_tok`` [R] valid
        tokens per row (idle rows 0: their writes go to the trash page).
        Returns logits [R, s, V], or with ``take`` those of position
        ``take`` only, [R, 1, V]."""
        s = tokens.shape[1]
        pos_ids = (positions[:, None] + torch.arange(s, device=tokens.device)
                   ).to(torch.int32)
        page, slot, visible = self._slots(tables, positions, n_tok, s)
        return self._layers(tokens, pos_ids, take, lambda q, k, v, li: self._paged_attention(
            q, k, v, li, tables, page, slot, visible))

    def _layers(self, tokens, pos_ids, take, attend):
        """Embedding, the decoder layers with ``attend(q, k, v, layer)`` as
        their attention (q, k rotated at ``pos_ids`` [R, s]), the final
        norm, and the logits of every position or of ``take`` only."""
        model = self.model
        base = model.llama
        R, s = tokens.shape
        cfg = model.config
        h, kvh, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        cos, sin = base.rope_cos.float(), base.rope_sin.float()
        x = base.embed_tokens(tokens)
        for li, layer in enumerate(base.layers):
            attn = layer.self_attn
            xin = layer.input_layernorm(x)
            q = attn.q_proj(xin).view(R, s, h, d)
            k = attn.k_proj(xin).view(R, s, kvh, d)
            v = attn.v_proj(xin).view(R, s, kvh, d)
            q, k = apply_rotary_at_positions(q, k, cos, sin, pos_ids)
            out = attend(q, k, v, li)
            x = x + attn.o_proj(out.reshape(R, s, h * d))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        hidden = base.norm(x)
        if take is not None:
            hidden = hidden[:, take:take + 1]
        return model._logits(hidden)
