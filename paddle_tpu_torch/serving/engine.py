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
- **Speculative decoding** (``speculative=``, ``PADDLE_TPU_SPEC_K``): every
  decode forward is ``1 + k`` tokens wide; each row drafts up to ``k``
  tokens host-side (:class:`~..generation.speculative.NGramDrafter` or a
  drafter factory), the one forward scores them all, and the greedy
  acceptance loop emits the longest prefix of drafts that match the
  target's argmax plus its next token, so the stream is token-exact against
  serial decode.  :class:`~..generation.speculative.AdaptiveK` sets how
  many draft slots are valid; the width never changes.
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
- **Tensor-parallel decode** (``tp`` > 1, ``PADDLE_TPU_SERVE_TP``): the
  Megatron split of the reference, over a ``model`` axis of ``tp`` members
  (``serving/disagg.py``): member j holds its share of the q/k/v/gate/up
  columns and the o/down rows, and its kv heads' k/v (and int8 scale)
  arenas.  Chunked prefill and decode run the same forward: the norms,
  embedding, residual adds and LM head once on the model's device; each
  member's projections, rope (B2 on its heads) and paged attention on its
  device; the row-parallel outputs summed over the members in member order.
  As with ``cp``, one process drives the members, which go round-robin over
  the visible cards from the model's, so several may share one card.  Page
  frames hold every kv head, so a page exported at one ``tp`` recalls at
  another.
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
- **Prefix cache** (``prefix_cache=``, ``PADDLE_TPU_PREFIX_CACHE=1``): a
  request whose prompt starts with cached full pages adopts them
  (:class:`~.prefix_cache.PrefixCache`) and its prefill resumes at the
  first uncached chunk; under ``cp`` > 1 such a request takes the chunked
  path (reason ``prefix_cached``), since the ring rewrites every page.
- **Host-RAM offload** (``offload=``, ``PADDLE_TPU_KV_OFFLOAD=1``): a
  preempted request's private pages go to an :class:`~.kv_pool.
  OffloadPool` and come back when it is re-admitted, with no recompute; a
  victim's pages leave the card in one copy a plane (pinned host memory)
  and return in one.  Frames dropped by the tier's LRU turn the recall into
  a re-prefill (``kv_offload_stalls``).
- **Journal** (``journal=``, ``journal_ship=``): accepted requests and
  delivered tokens are flushed to a :class:`~.journal.ServingJournal`
  before the sink sees a token, and :meth:`ServingEngine.recover` replays
  it into a fresh engine with every token delivered exactly once.

Not ported yet, and raising ``NotImplementedError`` that names the ROADMAP
item: disaggregated prefill (``submit_prefilled``, ``prefill_export``, A8) and
the decode-loop watchdog (A7b).  The reference's chaos seams
(``_faults.fire``) and telemetry events wait for A7b and A8.

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
of the context-parallel prefill, default 1), ``PADDLE_TPU_SERVE_TP``
(tensor-parallel members, default 1), ``PADDLE_TPU_PREFIX_CACHE`` /
``PADDLE_TPU_PREFIX_PAGES`` (prefix cache on / its page budget, 64),
``PADDLE_TPU_KV_OFFLOAD`` / ``PADDLE_TPU_KV_OFFLOAD_PAGES`` (host tier on /
its page budget, 64), ``PADDLE_TPU_RESUME_REPORT`` (where ``recover`` writes
its report), ``PADDLE_TPU_SPEC_K`` (draft length when ``speculative`` is
not given; 0, the default, is serial decode).
"""

from __future__ import annotations

import json
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
from ..distributed.meta_parallel.mp_layers import member_sum
from ..distributed.topology import build_mesh
from ..generation.speculative import AdaptiveK, SpecConfig
from ..models.llama import apply_rotary_at_positions
from ..nn import functional as F
from .disagg import decode_mesh, shard_arenas, shard_llama_params
from .admission import AdmissionController, Deadline, Overloaded, _env_float, _env_int
from .journal import ServingJournal
from .kv_pool import OffloadPool, PagedKVPool, PoolExhausted, TRASH_PAGE, default_page_tokens
from .kv_quant import (default_fp8_scale, dequantize_kv, dequantize_kv_fp8,
                       kv_cache_dtype, kv_page_bytes, kv_scale_page_bytes,
                       quantize_kv, quantize_kv_fp8)
from .metrics import SLOMeter
from .prefix_cache import PrefixCache

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
        self.cached_tokens = 0                # prompt tokens adopted from the
        # prefix cache at the LAST admission (reset on eviction)
        self.offloads = 0                     # host-RAM swap-outs suffered
        self.drafter = None                   # speculative proposer (or None)

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
    ``prefix_cache``: ``True`` (a trie under ``PADDLE_TPU_PREFIX_PAGES``),
    an ``int`` page budget, or a :class:`PrefixCache` over this engine's
    pool; default ``PADDLE_TPU_PREFIX_CACHE=1``.  ``offload``: ``True`` (a
    tier under ``PADDLE_TPU_KV_OFFLOAD_PAGES``), an ``int`` page budget, or
    an :class:`OffloadPool`; default ``PADDLE_TPU_KV_OFFLOAD=1``.
    ``journal``: a directory or a :class:`ServingJournal`;
    ``journal_ship(seq, data)`` receives each flushed segment before the
    tokens it covers reach ``on_token``.  ``speculative``: an ``int`` draft
    length, a :class:`SpecConfig`, or ``None`` for ``PADDLE_TPU_SPEC_K``
    (0 = serial decode).  ``tp`` (default ``PADDLE_TPU_SERVE_TP``, 1): the
    members of tensor-parallel decode (module docstring); it must divide
    the attention and kv head counts, and it takes the model's parameters
    for itself, as the reference's ``shard_llama_params`` does."""

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
        tp = int(tp if tp is not None else _env_int("PADDLE_TPU_SERVE_TP", 1))
        self.cp = int(cp if cp is not None else _env_int("PADDLE_TPU_SERVE_CP", 1))
        if self.cp > 1 and tp > 1:
            raise ValueError(
                f"PADDLE_TPU_SERVE_CP={self.cp} cannot combine with "
                f"PADDLE_TPU_SERVE_TP={tp}: the serving mesh is one axis "
                f"(shard prompts OR heads, not both yet)")
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
        self.journal: Optional[ServingJournal] = \
            ServingJournal(journal, ship=journal_ship) \
            if isinstance(journal, str) else journal
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
        self.tp = tp
        h_att = model.config.num_attention_heads
        if tp < 1 or kv_heads % tp or h_att % tp:
            raise ValueError(
                f"PADDLE_TPU_SERVE_TP={tp} must divide both kv_heads ({kv_heads}) "
                f"and attention heads ({h_att}) — a ragged shard would change the "
                f"q-group geometry")
        if tp > 1:
            # members round-robin over the visible devices, from the model's
            cards = devices(self.device.type)
            at = cards.index(self.device) if self.device in cards else 0
            self._mesh = decode_mesh(tp, devices=cards[at:] + cards[:at])
            shard_llama_params(model, self._mesh)
        self.tp_devices = self._mesh.axis_devices("model") if tp > 1 else [self.device]
        # each layer's projection weights, one a member (the engine keeps
        # the shards it was built with); an MoE layer's MLP keeps its own,
        # whole on the model's device (they are no projection to split)
        self._weights = [
            {key: (proj.weight.shards if tp > 1 else [proj.weight]) for key, proj in (
                ("q", ly.self_attn.q_proj), ("k", ly.self_attn.k_proj),
                ("v", ly.self_attn.v_proj), ("o", ly.self_attn.o_proj),
                *((("gate", ly.mlp.gate_proj), ("up", ly.mlp.up_proj),
                   ("down", ly.mlp.down_proj)) if hasattr(ly.mlp, "gate_proj") else ()))}
            for ly in model.llama.layers]
        self._arena_shape = (N, P, kv_heads, head_dim)
        self.kv_dtype = kv_cache_dtype(kv_dtype)
        self._fp8_scale = default_fp8_scale() if self.kv_dtype == "fp8" else None
        adt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(self.kv_dtype,
                                                                   self._cdt)

        planes = {"k": (self._arena_shape, adt), "v": (self._arena_shape, adt)}
        self._scale_bytes = 0
        if self.kv_dtype == "int8":
            sshape = (N, P, kv_heads)
            planes.update(ks=(sshape, torch.float32), vs=(sshape, torch.float32))
            self._scale_bytes = 2 * n_layers * int(np.prod(sshape)) * 4
        self._arena_bytes = 2 * n_layers * int(np.prod(self._arena_shape)) \
            * adt.itemsize
        # one dict of arenas a member, each holding its kv heads; a layer at
        # a time, so no whole global cache is ever held beside the shards
        self._shards: List[Dict[str, List[torch.Tensor]]] = [
            {key: [] for key in planes} for _ in self.tp_devices]
        for key, (shape, dtype) in planes.items():
            for _ in range(n_layers):
                layer = {key: [torch.zeros(shape, dtype=dtype, device=self.device)]}
                parts = shard_arenas(layer, self._mesh) if tp > 1 else [layer]
                for ar, part in zip(self._shards, parts):
                    ar[key] += part[key]
        self._arenas = self._shards[0]   # the whole cache when tp == 1
        self.pool.set_page_bytes(
            kv_page_bytes(P, kv_heads, head_dim, self.kv_dtype, n_layers=n_layers),
            kv_scale_page_bytes(P, kv_heads, self.kv_dtype, n_layers=n_layers),
            self.kv_dtype, shards=tp)
        self.meter.set_kv_bytes_per_token(self.pool.bytes_per_token(),
                                          per_member=self.pool.member_bytes_per_token())

        if prefix_cache is None:
            prefix_cache = os.environ.get("PADDLE_TPU_PREFIX_CACHE", "0") == "1"
        if prefix_cache is True:
            prefix_cache = PrefixCache(self.pool)
        elif isinstance(prefix_cache, int) and not isinstance(prefix_cache, bool) \
                and prefix_cache > 0:
            prefix_cache = PrefixCache(self.pool, max_pages=prefix_cache)
        self.prefix: Optional[PrefixCache] = \
            prefix_cache if isinstance(prefix_cache, PrefixCache) else None
        if offload is None:
            offload = os.environ.get("PADDLE_TPU_KV_OFFLOAD", "0") == "1"
        if offload is True:
            offload = OffloadPool()
        elif isinstance(offload, int) and not isinstance(offload, bool) and offload > 0:
            offload = OffloadPool(max_pages=offload)
        self.offload: Optional[OffloadPool] = \
            offload if isinstance(offload, OffloadPool) else None
        self._offload_lost: set = set()   # parked rids whose frames the
        # tier's LRU dropped: their recall becomes a re-prefill

        # speculative decoding: every decode forward is [R, 1 + k] wide; a
        # row's valid-token count carries the adaptive draft length
        if speculative is None:
            env_k = _env_int("PADDLE_TPU_SPEC_K", 0)
            speculative = SpecConfig(k=env_k) if env_k > 0 else None
        elif isinstance(speculative, int):
            speculative = SpecConfig(k=speculative) if speculative > 0 else None
        elif not isinstance(speculative, SpecConfig):
            raise TypeError("speculative must be None, an int draft "
                            "length, or a generation.SpecConfig")
        self.spec: Optional[SpecConfig] = speculative
        self._spec_width = 1 + (self.spec.k if self.spec else 0)
        self._adapt = AdaptiveK(self.spec.k, self.spec.adaptive,
                                decay=self.spec.ema_decay) if self.spec else None

        self._queue: deque = deque()
        self._active: Dict[int, Request] = {}          # row -> Request
        self._results: Dict[int, np.ndarray] = {}
        self.shed: Dict[int, str] = {}                 # rid -> reason
        self.last_decode_logits = None   # host copy of the latest decode
        # step's logits [R, 1 + k, V] (f32)
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
        if self.journal is not None:
            # durable BEFORE it is queued: a failed flush leaves neither a
            # queue entry nor a journal record of a refused request
            self.journal.submit_durable(r.rid, r.prompt, r.max_new_tokens,
                                        r.eos_token_id, r.deadline,
                                        primed=r.delivered_tokens or None,
                                        age_s=age_s, trace_id=trace_id)
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
        """Replay the journal into this (fresh) engine after a crash:
        re-submit every accepted, unfinished request with its rid and
        delivered high-water mark (tokens the client saw are regenerated,
        not delivered again), its deadlines aged by the wall time since its
        submit, then re-offer every journaled token to the sink (which drops
        what it already has), then restore finished results and shed
        records.  Reads nothing of the engine that wrote the journal.
        Returns ``{"replayed", "finished", "shed", "truncated",
        "known_rids"}`` and writes the resume report
        (``PADDLE_TPU_RESUME_REPORT``) when there was anything to
        recover."""
        if self.journal is None:
            raise RuntimeError("recover() needs a journal-backed engine")
        st = self.journal.load_state()
        replayed = 0
        for rid in st.open_rids():
            rec = st.requests[rid]
            r = Request(np.asarray(rec["prompt"], np.int32),
                        rec["max_new_tokens"], rec["eos_token_id"], rid=rid,
                        trace_id=rec.get("trace_id"))
            r.deadline = Deadline.from_doc(rec.get("deadline"))
            toks = st.delivered.get(rid, [])
            r.delivered = len(toks)
            r.delivered_tokens = list(toks)
            self._queue.append(r)
            age = max(0.0, time.time() - rec.get("submit_wall", time.time()))
            self.meter.submit(r.rid, age_s=age, trace_id=r.trace_id)
            replayed += 1
        # re-offer BEFORE restoring _results: a status poll must never see a
        # rid finished while its journaled tokens are on their way to the sink
        if self._on_token is not None:
            for rid in sorted(st.delivered):
                if rid in st.shed:
                    continue
                for idx, tok in enumerate(st.delivered[rid]):
                    self._on_token(rid, idx, tok)
        for rid in st.finished:
            self._results[rid] = np.asarray(st.delivered.get(rid, []), np.int32)
        for rid, reason in st.shed.items():
            self.shed[rid] = reason
        info = {"replayed": replayed, "finished": len(st.finished),
                "shed": len(st.shed), "truncated": st.truncated,
                "known_rids": sorted(st.requests)}
        if st.requests:
            self._write_resume_report(info)
        if self._queue:
            self.meter.set_queue_depth(len(self._queue))
            self._work.set()
        return info

    @staticmethod
    def _write_resume_report(info: dict) -> None:
        """The reference's resume-report protocol: a relaunching supervisor
        reads ``<PADDLE_TPU_RESUME_REPORT>.0`` back."""
        base = os.environ.get("PADDLE_TPU_RESUME_REPORT")
        if not base:
            return
        try:
            with open(f"{base}.0", "w") as f:
                json.dump({"rank": 0, "source": "journal",
                           "replayed": info["replayed"]}, f)
        except OSError:
            pass

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
            raise _not_ported("the decode-loop watchdog (watchdog_s > 0)", "A7b")
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
        # a live prefix cache legitimately pins pages at quiesce
        self.pool.check_leaks(allow_shared=self.prefix is not None)
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
        for every active row, retire finished rows, then flush the journal
        and surface newly delivered tokens to the sink.

        ``OSError``-class failures (a journal flush that failed through its
        retries) are absorbed: the circuit breaker counts them and the next
        step retries with the records still buffered; after
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
        """Tokens or journal records still awaiting a successful flush."""
        return bool(self._pending_delivery) or (
            self.journal is not None and self.journal.pending > 0)

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
        if self.journal is not None:
            self.journal.shed(r.rid, reason)
        self.meter.shed(r.rid, reason=reason)

    def _admit_need(self, r: Request):
        """``(pages to allocate, cached prefix pages to adopt)`` when
        admitting ``r``: its prompt and the slot of its first decode write,
        less the prefix cache's longest match (which never covers the last
        prompt token, so at least one page is always fresh)."""
        total = self.pool.pages_for(len(r.prompt) + 1)
        if self.prefix is None:
            return total, []
        pages, _ = self.prefix.match(r.prompt)
        return total - len(pages), pages

    def _admit(self) -> None:
        rows = self._free_rows()
        while self._queue and rows:
            r = self._queue[0]
            if self.pool.is_parked(r.rid):
                # a swapped-out request at the head: its KV comes back from
                # the host tier (or it re-prefills if the frames are gone)
                if self._recall(r, rows) == "wait":
                    break
                continue
            need, cached = self._admit_need(r)
            if not self.pool.can_alloc(need):
                # pool pressure: a long prompt at the head must not wedge
                # admission — try ONE shorter request from the lookahead
                # window (bounded per-head bypass budget, no starvation)
                if not self._admit_bypass(r, need, rows):
                    break
                continue
            self._admit_one(r, need, rows, from_head=True, cached=cached)

    def _admit_one(self, r: Request, need: int, rows: List[int],
                   *, from_head: bool, cached=()) -> None:
        if from_head:
            self._queue.popleft()
        else:
            self._queue.remove(r)
        # a prefix hit adopts the trie's pages (a reference each) and
        # allocates only the rest; prefill resumes after them
        if cached:
            self.pool.adopt(r.rid, cached)
        r.cached_tokens = len(cached) * self.page_tokens
        if self.prefix is not None:
            self.prefix.note(bool(cached), n_tokens=r.cached_tokens)
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
        ``PADDLE_TPU_SERVE_DEFER_MAX`` times.  Demand is compared in fresh
        pages: a long prompt that is mostly cached is cheap."""
        if head.defers >= self._defer_max:
            return False
        window = min(len(self._queue), self._defer_lookahead + 1)
        for i in range(1, window):
            c = self._queue[i]
            if self.pool.is_parked(c.rid):
                continue   # parked requests re-enter only through _recall
            need, cached = self._admit_need(c)
            if need < head_need and self.pool.can_alloc(need):
                head.defers += 1
                self.meter.defer(head.rid, defers=head.defers,
                                 need=head_need, free=self.pool.pages_free)
                self._admit_one(c, need, rows, from_head=False, cached=cached)
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
        victim.cached_tokens = 0     # its pages went back (the trie keeps
        # its own); the re-admission matches the prefix cache again
        victim.drafter = None        # rebuilt at the re-prefill: drafts only
        # choose which positions are verified, never the tokens
        victim.evictions += 1
        self._queue.appendleft(victim)
        self.meter.evict(victim.rid, reason="pool_pressure", pages_freed=freed)

    def _preempt(self, victim: Request) -> None:
        """A pool-pressure preemption: with a host-RAM offload tier the
        victim's pages spill and it resumes without recompute
        (:meth:`_offload`); without one, the eviction replay."""
        if self.offload is not None:
            self._offload(victim)
        else:
            self._evict(victim)

    def _offload(self, victim: Request) -> None:
        """Swap ``victim`` out to the host tier: its PRIVATE pages leave the
        card as :class:`OffloadPool` frames and are freed; its SHARED pages
        (prefix-cache adoptions) keep its reference and never copy.  It
        keeps its generated tokens and requeues at the front.  If the puts
        LRU-drop frames of any parked request (this one included), that
        request is marked lost and re-prefills at its recall."""
        pages = self.pool.table(victim.rid)
        spill = [(j, p) for j, p in enumerate(pages) if self.pool.refcount(p) <= 1]
        # the copy ends before swap_out frees the pages for reuse
        frames = self._export_pages([p for _, p in spill])
        self.pool.swap_out(victim.rid)
        del self._active[victim.row]
        victim.row = None
        victim.state = QUEUED
        victim.offloads += 1
        self._queue.appendleft(victim)
        nbytes = 0
        lost = set()
        for (j, _), fr in zip(spill, frames):
            nbytes += OffloadPool._frame_bytes(fr)
            for rid_lost, _slot in self.offload.put(victim.rid, j, fr):
                lost.add(rid_lost)
        for rid_lost in lost:
            # a partial frame set is useless: drop the rest too
            self._offload_lost.add(rid_lost)
            self.offload.drop(rid_lost)
        self.meter.offload(victim.rid, pages=len(frames),
                           shared_pages=len(pages) - len(frames), bytes_out=nbytes)

    def _recall(self, r: Request, rows: List[int]) -> str:
        """Re-admit the parked request at the head of the queue.  Returns
        ``"recalled"`` (its row active again, its KV restored),
        ``"downgraded"`` (its frames are gone: reset to a re-prefill, still
        queued) or ``"wait"`` (frames intact, too few free pages)."""
        if r.rid in self._offload_lost or self.offload is None:
            self._downgrade(r)
            return "downgraded"
        missing = [j for j, p in enumerate(self.pool.parked_plan(r.rid)) if p is None]
        if not all(self.offload.holds(r.rid, j) for j in missing):
            self._downgrade(r)
            return "downgraded"
        if not self.pool.can_alloc(len(missing)):
            # nearing re-admission: let the LRU drop colder frames first
            self.offload.touch(r.rid)
            return "wait"
        _, refill = self.pool.swap_in(r.rid)
        frames = [self.offload.get(r.rid, j) for j, _ in refill]
        self._import_pages([p for _, p in refill], frames)
        self._queue.popleft()
        r.row = rows.pop(0)
        r.state = RUNNING
        self._active[r.row] = r
        self.meter.recall(r.rid, pages=len(refill),
                          bytes_in=sum(OffloadPool._frame_bytes(f) for f in frames),
                          n_tokens=len(r.generated))
        self.meter.set_occupancy(self.pool.occupancy())
        return "recalled"

    def _downgrade(self, r: Request) -> None:
        """The offload stall: the parked request's frames are gone, so it
        releases its retained references and re-prefills from its prompt,
        the ``delivered`` high-water mark keeping its tokens from being
        delivered twice.  It keeps its queue position."""
        self.pool.drop_parked(r.rid)
        if self.offload is not None:
            self.offload.drop(r.rid)
        self._offload_lost.discard(r.rid)
        r.generated = []
        r.cached_tokens = 0
        r.drafter = None
        r.evictions += 1
        self.meter.offload_stall(r.rid)

    def _export_pages(self, pids) -> List[dict]:
        """Host copies of the physical pages ``pids``, one frame a page:
        ``{plane: [layers, page_tokens, ...]}``, the reference's format.  A
        plane's pages leave the device in ONE copy: one ``index_select`` a
        layer into a device buffer ``[n, layers, ...]``, copied whole into
        host memory (pinned for a card), of which each frame is a view.
        The copy is on the compute stream and waits for it, so it has
        finished when this returns and the pages may be reused."""
        if not pids:
            return []
        idx = self._page_ids(pids)
        host = {}
        for key, arrs in self._arenas.items():
            # [n, layers, page_tokens, kv, (d)]: the members' kv heads joined
            planes = [torch.stack([_raw(a).index_select(0, idx[a.device]) for a in ar[key]],
                                  dim=1).to(self.device) for ar in self._shards]
            dev = (planes[0] if len(planes) == 1 else torch.cat(planes, 3)).view(arrs[0].dtype)
            host[key] = torch.empty(dev.shape, dtype=dev.dtype,
                                    pin_memory=self.device.type == "cuda")
            host[key].copy_(dev)
        return [{key: buf[i] for key, buf in host.items()} for i in range(len(pids))]

    def _import_pages(self, pids, frames) -> None:
        """Write ``frames`` (:meth:`_export_pages`'s format) into the
        physical pages ``pids``: one host-to-device copy a plane (the
        frames of one swap-out are consecutive views of one buffer, taken
        as one without a host copy), then one ``index_copy_`` a layer, on
        the compute stream ahead of the next forward."""
        if not pids:
            return
        idx = self._page_ids(pids)
        for key in self._arenas:
            dev = _host_run([f[key] for f in frames]).to(self.device)
            w = dev.shape[3] // self.tp            # a member's kv heads
            for j, ar in enumerate(self._shards):
                part = dev.narrow(3, j * w, w).to(self.tp_devices[j])
                for li, a in enumerate(ar[key]):
                    _raw(a).index_copy_(0, idx[a.device], _raw(part[:, li]))

    def _page_ids(self, pids) -> Dict[torch.device, torch.Tensor]:
        """The page ids on each member's device."""
        return {dev: torch.as_tensor(pids, dtype=torch.long, device=dev)
                for dev in set(self.tp_devices)}

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
        if self.journal is not None:
            self.journal.finish(r.rid)
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

    def _prefill_chunks(self, prompt, table, c0: int = 0) -> np.ndarray:
        """Run ``prompt`` through the forward in page-sized chunks over the
        block table ``table`` [1, max_pages_per_seq], from chunk ``c0`` on
        (the chunks before it are prefix-cached pages); returns the last
        prompt token's logits [V] on the host, in f32."""
        P = self.page_tokens
        n_chunks = -(-len(prompt) // P)
        tables = self._tensor(table)
        n_tok = self._tensor([P])          # a full chunk: junk tail slots
        logits = None                      # are overwritten by decode
        for c in range(c0, n_chunks):
            chunk = np.zeros((1, P), np.int64)
            part = prompt[c * P:(c + 1) * P]
            chunk[0, :len(part)] = part
            take = (len(prompt) - 1 - c * P) if c == n_chunks - 1 else 0
            logits = self._forward(self._tensor(chunk), self._tensor([c * P]),
                                   tables, n_tok, take=max(take, 0))
        return logits[0, 0].float().cpu().numpy()

    def _prefill(self, r: Request) -> None:
        n_chunks = -(-len(r.prompt) // self.page_tokens)
        # a prefix hit adopted chunks [0, c0) already filled; the match cap
        # keeps c0 < n_chunks, so the last token's logits are computed
        c0 = min(r.cached_tokens // self.page_tokens, n_chunks - 1)
        if self._cp_accepts(len(r.prompt), cached_tokens=r.cached_tokens):
            logits = self._cp_prefill_run(r.prompt, self.pool.table(r.rid))
        else:
            logits = self._prefill_chunks(r.prompt, self._padded_table(r.rid)[None], c0)
        tok = int(np.argmax(logits))
        r.generated.append(tok)
        self.meter.first_token(r.rid)
        self._deliver(r, tok)
        if self.prefix is not None:
            # the prompt's full pages serve later requests (the chunks
            # matched at admission just refresh their LRU stamp)
            self.prefix.insert(r.prompt, self.pool.table(r.rid))
        if self.spec is not None:
            # (re)built here, so an eviction replay and a crash recovery
            # get a drafter primed with the tokens a first admission's saw
            r.drafter = self.spec.make_drafter()
            r.drafter.begin([int(t) for t in r.prompt])
            r.drafter.observe([tok])

    # -- context-parallel prefill ---------------------------------------------
    def _cp_accepts(self, n_prompt: int, *, cached_tokens: int = 0) -> bool:
        """Gate of the CP prefill; each refusal is counted by reason in
        ``cp_fallbacks``.  ``prefix_cached``: the ring rewrites every page
        of the prompt, which would overwrite pages other requests share and
        recompute the cached prefix.  ``short_prompt``: fewer page-chunks
        than ring members, so some members would hold only padding.  The
        reference's ``kv_import`` reason waits for disaggregated prefill
        (A8)."""
        if self.cp <= 1:
            return False
        if cached_tokens > 0:
            reason = "prefix_cached"
        elif -(-n_prompt // self.page_tokens) < self.cp:
            reason = "short_prompt"
        else:
            return True
        self.cp_fallbacks[reason] = self.cp_fallbacks.get(reason, 0) + 1
        return False

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
                            lambda q, k, v, li, ar: self._ring_attention(q, k, v, li, page, slot))

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
        """One decode step over every active row, ``1 + k`` tokens wide
        (serial decode: k = 0).  With speculation each row drafts ``k_r``
        tokens host-side, the one forward scores positions ``pos ..
        pos + k_r``, and the greedy acceptance loop emits the longest prefix
        whose drafts match the target's argmax, then the target's own next
        token.  A rejected draft's slots lie at or past the next write
        position: the next step overwrites them before it reads them, and
        the position mask hides what lies beyond.  Idle rows decode token 0
        at position 0 into the trash page."""
        R, MP, S = self.max_batch, self.max_pages_per_seq, self._spec_width
        tokens = np.zeros((R, S), np.int64)
        positions = np.zeros((R,), np.int64)
        n_tok = np.zeros((R,), np.int64)
        tables = np.full((R, MP), TRASH_PAGE, np.int64)
        drafts: Dict[int, List[int]] = {}
        stepped: List[Request] = []
        for r in [self._active[row] for row in sorted(self._active)]:
            # _ensure_page can evict LATER snapshot entries; skip anything
            # no longer running so an evictee never allocates while queued
            if r.state != RUNNING or r.row is None or r.done():
                continue
            d: List[int] = []
            if self.spec is not None and r.drafter is not None:
                # never draft past the output budget: the last budgeted
                # token needs no verification slot
                k_r = min(self._adapt.k(), r.max_new_tokens - len(r.generated) - 1)
                if k_r > 0:
                    d = [int(t) for t in r.drafter.propose(k_r)]
            drafts[r.rid] = d
            self._ensure_page(r, 1 + len(d))
        # _ensure_page may have evicted rows; rebuild the live view
        for row, r in sorted(self._active.items()):
            if r.done():
                continue
            seq = [r.generated[-1]] + drafts.get(r.rid, [])
            tokens[row, :len(seq)] = seq
            n_tok[row] = len(seq)
            positions[row] = r.pos
            tables[row] = self._padded_table(r.rid)
            stepped.append(r)
        if not stepped:
            for r in list(self._active.values()):
                self._retire_if_done(r)
            return
        logits = self._forward(self._tensor(tokens), self._tensor(positions),
                               self._tensor(tables), self._tensor(n_tok))
        logits = logits.float().cpu().numpy()               # [R, S, V]
        self.last_decode_logits = logits
        proposed_total = accepted_total = emitted_total = 0
        for r in stepped:
            nv = int(n_tok[r.row])
            row_logits = logits[r.row, :nv]
            if not np.all(np.isfinite(row_logits)):
                # a corrupted int8 scale (or any cache poisoning) surfaces
                # as NaN/inf logits — fail LOUDLY instead of emitting junk
                raise RuntimeError(
                    f"non-finite decode logits for rid {r.rid} "
                    f"(kv_dtype={self.kv_dtype}): corrupted KV page or "
                    f"scale buffer")
            d = drafts.get(r.rid, [])
            emitted: List[int] = []
            for i in range(nv):
                tok = int(np.argmax(row_logits[i]))
                r.generated.append(tok)
                self.meter.token(r.rid)
                self._deliver(r, tok)
                emitted.append(tok)
                if r.done():
                    break
                if i < nv - 1 and tok != d[i]:
                    break   # the rest of the draft follows a rejected token
            if self.spec is not None:
                accepted = len(emitted) - 1
                proposed_total += len(d)
                accepted_total += accepted
                emitted_total += len(emitted)
                self._adapt.update(accepted, len(d))
                if r.drafter is not None and not r.done():
                    r.drafter.observe(emitted)
        if self.spec is not None:
            self.meter.spec_step(proposed=proposed_total, accepted=accepted_total,
                                 emitted=emitted_total, rows=len(stepped))
        for r in list(self._active.values()):
            self._retire_if_done(r)

    # -- delivery ----------------------------------------------------------
    def _deliver(self, r: Request, tok: int) -> None:
        """Token bookkeeping right after ``r.generated.append(tok)``: new
        tokens advance the journaled high-water mark and queue for the sink
        (emitted after the covering journal flush); replayed ones (after an
        eviction, an offload stall or a crash) are suppressed and checked
        against what the client already saw — greedy decode is
        deterministic, so a divergence is an engine bug."""
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
        if self.journal is not None:
            self.journal.deliver(r.rid, idx, tok)
        self._pending_delivery.append((r.rid, idx, tok))

    def _flush_delivery(self) -> None:
        """The durability barrier, then the sink: journal records reach disk
        BEFORE any token they cover reaches ``on_token``.  On a flush
        failure everything stays pending; the step-failure path retries."""
        if self.journal is not None:
            self.journal.flush()
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

    def _paged_attention(self, q, k_new, v_new, li, ar, tables, page, slot, visible):
        """Scatter this step's k/v [R, s, kv, d] into layer ``li``'s page
        arenas of ``ar`` (one member's) IN PLACE at (``page``, ``slot``) and
        attend each row of q [R, s, h, d] over its gathered pages where
        ``visible``.  As the reference's grouped einsum: the cache dtype's
        products with f32 accumulation (computed in f32 from the same
        values), junk columns masked to exact zeros; int8 pages quantize on
        the scatter (scales into the scale arenas) and dequantize at the
        gather, fp8 pages under the static scale."""
        R, s, h, d = q.shape
        kv = k_new.shape[2]
        C = tables.shape[1] * self.page_tokens
        tables, page, slot, visible = (t.to(q.device) for t in (tables, page, slot, visible))
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
        ``tokens`` [R, s] (decode: s = 1 + k; prefill: R = 1, s = page_tokens)
        at ``positions`` [R] (each row's first token), ``n_tok`` [R] valid
        tokens per row (idle rows 0: their writes go to the trash page).
        Returns logits [R, s, V], or with ``take`` those of position
        ``take`` only, [R, 1, V]."""
        s = tokens.shape[1]
        pos_ids = (positions[:, None] + torch.arange(s, device=tokens.device)
                   ).to(torch.int32)
        page, slot, visible = self._slots(tables, positions, n_tok, s)
        return self._layers(tokens, pos_ids, take, lambda q, k, v, li, ar: self._paged_attention(
            q, k, v, li, ar, tables, page, slot, visible))

    def _layers(self, tokens, pos_ids, take, attend):
        """Embedding, the decoder layers with ``attend(q, k, v, layer,
        arenas)`` as their attention over a member's heads and arenas (q, k
        rotated at ``pos_ids`` [R, s]), the final norm, and the logits of
        every position or of ``take`` only.  The projections, rope and
        attention run on each member (one when ``tp`` == 1); the
        row-parallel outputs are summed over the members in member order, in
        f32 (``member_sum``); the rest, an MoE layer's MLP included, runs
        once on the model's device."""
        model = self.model
        base = model.llama
        R, s = tokens.shape
        cfg = model.config
        h, kvh, d = cfg.num_attention_heads // self.tp, cfg.num_key_value_heads // self.tp, \
            cfg.head_dim
        cos, sin = base.rope_cos.float(), base.rope_sin.float()
        rope = {dev: (cos.to(dev), sin.to(dev), pos_ids.to(dev)) for dev in self.tp_devices}
        x = base.embed_tokens(tokens)
        for li, layer in enumerate(base.layers):
            w = self._weights[li]
            xin = layer.input_layernorm(x)
            parts = []
            for j, dev in enumerate(self.tp_devices):
                xj = xin.to(dev)
                q = F.linear(xj, w["q"][j]).view(R, s, h, d)
                k = F.linear(xj, w["k"][j]).view(R, s, kvh, d)
                v = F.linear(xj, w["v"][j]).view(R, s, kvh, d)
                q, k = apply_rotary_at_positions(q, k, *rope[dev])
                out = attend(q, k, v, li, self._shards[j])
                parts.append(F.linear(out.reshape(R, s, h * d), w["o"][j]))
            x = x + member_sum(parts, x.device)
            x2 = layer.post_attention_layernorm(x)
            if "gate" not in w:
                # an MoE layer: its MLP once, on the model's device, over
                # the whole block (the routing couples every token of it,
                # pads and idle rows included, as in the reference)
                x = x + layer.mlp(x2)
                continue
            parts = []
            for j, dev in enumerate(self.tp_devices):
                xj = x2.to(dev)
                act = F.swiglu(F.linear(xj, w["gate"][j]), F.linear(xj, w["up"][j]))
                parts.append(F.linear(act, w["down"][j]))
            x = x + member_sum(parts, x.device)
        hidden = base.norm(x)
        if take is not None:
            hidden = hidden[:, take:take + 1]
        return model._logits(hidden)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """``t`` as bytes where torch indexes no e4m3 (fp8 pages)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _host_run(ts: List[torch.Tensor]) -> torch.Tensor:
    """The host tensors ``ts`` (one plane of consecutive frames) as one
    tensor ``[n, ...]``: a view of their buffer when they are consecutive
    slices of it (the frames of one swap-out, in slot order), else stacked."""
    t0 = ts[0]
    ptr, step = t0.untyped_storage().data_ptr(), t0.numel()
    if all(t.is_contiguous() and t.untyped_storage().data_ptr() == ptr
           and t.storage_offset() == t0.storage_offset() + i * step
           for i, t in enumerate(ts)):
        return t0.as_strided((len(ts), *t0.shape), (step, *t0.stride()),
                             t0.storage_offset())
    return torch.stack(ts)
