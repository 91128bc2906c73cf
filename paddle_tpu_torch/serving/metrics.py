"""Per-request SLO metrics for the serving engine (port of the reference's
``serving/metrics.py``: :class:`RequestClock` and :class:`SLOMeter`).

The meter prices a REQUEST: TTFT (arrival → first token), TPOT (mean
inter-token gap over the decode phase), end-to-end latency, and the gauges
a capacity planner reads (queue depth, KV-pool occupancy, requests/s, shed
and deadline-miss rates, KV bytes per token).  Memory is bounded:
percentiles roll over a window of the most recent finished requests
(``PADDLE_TPU_SERVE_SLO_WINDOW``, default 1024), per-request clocks are
dropped at finish or shed, and the exact totals are O(1) counters.

``summary()`` has the reference's keys.  As in the reference, every gauge
and counter also goes to the telemetry runtime (``telemetry.counters()``,
so ``prometheus_text()``), TTFT, TPOT and latency are observed into
mergeable histograms (:meth:`SLOMeter.hist_docs`, which the metrics pusher
ships), and the transitions are narrated into the flight recorder as
``serve_submit`` / ``serve_admit`` / ``serve_first_token`` /
``serve_evict`` / ``serve_shed`` / ``serve_finish`` events carrying the
request's trace id.  With speculative decoding on, ``spec_step`` counts
each verify step's drafts, acceptances and emitted tokens; with it off,
``spec_acceptance`` and ``effective_tokens_per_step`` read ``None``.
:class:`FleetMeter` meters the multi-replica frontend.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..telemetry import record_event
from ..telemetry.aggregator import Histogram
from ..telemetry.runtime import bump, identity, set_gauge
from .admission import _env_int

__all__ = ["RequestClock", "SLOMeter", "FleetMeter"]


def default_slo_window() -> int:
    return max(1, _env_int("PADDLE_TPU_SERVE_SLO_WINDOW", 1024))


@dataclass
class RequestClock:
    """Wall-clock milestones of one request's life (monotonic seconds).
    Lives only while the request is in flight."""

    rid: object
    submit_t: float
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    last_token_t: Optional[float] = None
    n_tokens: int = 0
    evictions: int = 0
    replay_watermark: int = 0   # tokens produced before the last eviction
    trace_id: Optional[str] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean inter-token gap over the decode phase (first token
        excluded — that one is priced by TTFT)."""
        if self.finish_t is None or self.first_token_t is None \
                or self.n_tokens < 2:
            return None
        return (self.finish_t - self.first_token_t) / (self.n_tokens - 1)

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t


# EWMA smoothing of the finished requests' TPOT trend (the reference's
# fleet frontend reads it to eject a slow replica)
_TPOT_EMA_ALPHA = 0.25


def _pct(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


def _r(x: Optional[float]) -> Optional[float]:
    return None if x is None else round(x, 3)


class SLOMeter:
    """Aggregates :class:`RequestClock` milestones into p50/p99 SLO lines
    over a bounded window, with live gauges as attributes."""

    def __init__(self, now=time.monotonic, window: Optional[int] = None):
        self._now = now
        self._clocks: Dict[object, RequestClock] = {}
        # each entry: (finish_t, ttft_s|None, tpot_s|None, latency_s,
        #              deadline_miss True/False/None)
        self._window: deque = deque(
            maxlen=window if window is not None else default_slo_window())
        self._ft_window: deque = deque(maxlen=self._window.maxlen)
        self._t_first_submit: Optional[float] = None
        self._t_last_finish: Optional[float] = None
        self.queue_depth = 0
        self.occupancy = 0.0
        self.occupancy_peak = 0.0
        self.finished_total = 0
        self.evictions_total = 0
        self.shed_total = 0
        self.shed_reasons: Dict[str, int] = {}
        self.rejected_total = 0
        self.deadline_misses_total = 0
        self.defers_total = 0
        self.kv_bytes_per_token: Optional[float] = None
        self.kv_bytes_per_token_member: Optional[float] = None
        self.tokens_out_total = 0        # new tokens
        self.tokens_replayed_total = 0   # recomputed after an eviction
        # the host-RAM offload tier: swaps in pages and bytes
        self.offloads_total = 0
        self.recalls_total = 0
        self.offload_stalls_total = 0
        self.offload_bytes_out_total = 0
        self.recall_bytes_in_total = 0
        self.tpot_ema_s: Optional[float] = None
        self._trace_complete = 0
        # speculative decoding: drafts proposed / accepted, tokens emitted
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.spec_emitted_total = 0
        self.spec_verify_steps = 0
        self.spec_rows_total = 0
        # TTFT/TPOT/latency histograms: mergeable bucket counts the
        # metrics pusher ships, so the fleet p99 comes from summed buckets;
        # each observation also bumps `serving.<kind>_hist.*` counters,
        # which prometheus_text() renders as _bucket/_sum/_count series
        self.hists: Dict[str, Histogram] = {
            "ttft_s": Histogram(), "tpot_s": Histogram(), "latency_s": Histogram()}

    def _observe(self, kind: str, value: float) -> None:
        h = self.hists[kind]
        h.observe(value)
        for ub in h.buckets:
            if value <= ub:
                bump(f"serving.{kind}_hist.bucket.{ub}")
                break
        else:
            bump(f"serving.{kind}_hist.bucket_inf")
        bump(f"serving.{kind}_hist.sum", float(value))
        bump(f"serving.{kind}_hist.count")

    def hist_docs(self) -> Dict[str, dict]:
        return {k: h.to_doc() for k, h in self.hists.items()}

    def clock(self, rid) -> RequestClock:
        return self._clocks[rid]

    def trace_of(self, rid) -> Optional[str]:
        c = self._clocks.get(rid)
        return None if c is None else c.trace_id

    # -- lifecycle ---------------------------------------------------------
    def submit(self, rid, age_s: float = 0.0,
               trace_id: Optional[str] = None) -> None:
        """``age_s`` backdates the clock (a request that already waited that
        long elsewhere keeps aging its deadline budgets)."""
        t = self._now() - max(0.0, float(age_s))
        self._clocks[rid] = RequestClock(rid=rid, submit_t=t,
                                         trace_id=trace_id)
        if self._t_first_submit is None:
            self._t_first_submit = t
        record_event("serve_submit", str(rid), trace=trace_id,
                     age_s=round(float(age_s), 6))
        bump("serving.requests_submitted")

    def admit(self, rid, *, queue_depth: int, pages: int) -> None:
        c = self._clocks[rid]
        c.admit_t = self._now()
        record_event("serve_admit", str(rid), pages=pages,
                     queue_depth=queue_depth, trace=c.trace_id,
                     queued_s=round(c.admit_t - c.submit_t, 6))
        bump("serving.requests_admitted")

    def first_token(self, rid) -> None:
        t = self._now()
        c = self._clocks[rid]
        if c.first_token_t is None:
            c.first_token_t = t     # an eviction-replay re-prefill must
            if c.admit_t is not None:    # not reset the client's TTFT
                self._ft_window.append(t - c.admit_t)
            if c.ttft_s is not None:
                self._observe("ttft_s", c.ttft_s)
            # the prefill span: submit -> first token out
            record_event("serve_first_token", str(rid), trace=c.trace_id,
                         ttft_s=None if c.ttft_s is None else round(c.ttft_s, 6))
        c.last_token_t = t
        c.n_tokens += 1
        self._count_token(c)

    def token(self, rid) -> None:
        c = self._clocks[rid]
        c.last_token_t = self._now()
        c.n_tokens += 1
        self._count_token(c)

    def _count_token(self, c: RequestClock) -> None:
        """Recomputing an already-produced token after an eviction is
        replay work, not new output: the two are counted apart."""
        if c.n_tokens <= c.replay_watermark:
            self.tokens_replayed_total += 1
            bump("serving.tokens_replayed")
        else:
            self.tokens_out_total += 1
            bump("serving.tokens_generated")

    def evict(self, rid, *, reason: str, pages_freed: int) -> None:
        c = self._clocks[rid]
        c.evictions += 1
        self.evictions_total += 1
        # the restarted prefill regenerates from scratch: token milestones
        # reset (the retained first_token_t stands — the client saw it)
        c.replay_watermark = max(c.replay_watermark, c.n_tokens)
        c.n_tokens = 0
        record_event("serve_evict", str(rid), reason=reason,
                     pages_freed=pages_freed, evictions=c.evictions,
                     trace=c.trace_id)
        bump("serving.evictions")

    def offload(self, rid, *, pages: int, shared_pages: int,
                bytes_out: int) -> None:
        """A preempted request's private pages went to the host tier
        (shared pages stay resident and move no byte).  Unlike
        :meth:`evict`, the token milestones stand: the recall restores the
        cache, nothing is recomputed."""
        c = self._clocks[rid]
        self.offloads_total += 1
        self.offload_bytes_out_total += int(bytes_out)
        record_event("serve_offload", str(rid), pages=pages,
                     shared_pages=shared_pages, bytes_out=int(bytes_out),
                     trace=c.trace_id)
        bump("serving.kv_offloads_total")
        bump("serving.kv_offload_bytes_out_total", int(bytes_out))

    def recall(self, rid, *, pages: int, bytes_in: int,
               n_tokens: int) -> None:
        """A parked request's frames came back from the host tier; its
        ``n_tokens`` generated tokens resume without recompute."""
        c = self._clocks[rid]
        self.recalls_total += 1
        self.recall_bytes_in_total += int(bytes_in)
        record_event("serve_recall", str(rid), pages=pages,
                     bytes_in=int(bytes_in), n_tokens=int(n_tokens),
                     trace=c.trace_id)
        bump("serving.kv_recalls_total")
        bump("serving.kv_recall_bytes_in_total", int(bytes_in))
        set_gauge("serving.kv_recall_bytes_per_token", self.kv_recall_bytes_per_token())

    def offload_stall(self, rid) -> None:
        """A parked request's frames were LRU-dropped before its recall: it
        re-prefills from its prompt, and its token milestones reset as an
        eviction's do."""
        c = self._clocks[rid]
        self.offload_stalls_total += 1
        self.evictions_total += 1
        c.evictions += 1
        c.replay_watermark = max(c.replay_watermark, c.n_tokens)
        c.n_tokens = 0
        record_event("serve_offload_stall", str(rid), trace=c.trace_id)
        bump("serving.kv_offload_stalls_total")

    def kv_recall_bytes_per_token(self) -> float:
        """Host-to-device recall bytes over every NEW token the engine
        produced (0.0 until a recall)."""
        if self.tokens_out_total <= 0:
            return 0.0
        return self.recall_bytes_in_total / self.tokens_out_total

    def shed(self, rid, *, reason: str) -> None:
        """A queued request dropped by deadline shedding (or handed back
        by a drain, reason ``drained``): it will never run here — fold its
        clock away.  The by-reason split lets the autoscaler leave its own
        scale-in hand-backs out of its overload signal."""
        c = self._clocks.pop(rid, None)
        self.shed_total += 1
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
        record_event("serve_shed", str(rid), reason=reason,
                     trace=None if c is None else c.trace_id,
                     queued_s=None if c is None else round(self._now() - c.submit_t, 6))
        bump("serving.requests_shed_total")

    def reject(self, *, reason: str,
               retry_after_s: Optional[float] = None) -> None:
        """An Overloaded refusal at submit (bounded queue / breaker)."""
        self.rejected_total += 1
        record_event("serve_reject", reason, retry_after_s=retry_after_s)
        bump("serving.requests_rejected_total")

    def defer(self, rid, *, defers: int, need: int, free: int) -> None:
        """The FIFO head was bypassed under pool pressure."""
        self.defers_total += 1
        record_event("serve_defer", str(rid), defers=defers,
                     pages_needed=need, pages_free=free)
        bump("serving.admission_defers_total")

    def finish(self, rid, *, n_tokens: int, deadline=None) -> None:
        c = self._clocks.pop(rid)
        c.finish_t = self._now()
        c.n_tokens = n_tokens
        self._t_last_finish = c.finish_t
        self.finished_total += 1
        miss = None
        if deadline is not None:
            miss = bool(
                (deadline.ttft_s is not None and c.ttft_s is not None
                 and c.ttft_s > deadline.ttft_s) or
                (deadline.total_s is not None
                 and c.latency_s > deadline.total_s))
            if miss:
                self.deadline_misses_total += 1
                bump("serving.deadline_misses_total")
        self._window.append((c.finish_t, c.ttft_s, c.tpot_s, c.latency_s,
                             miss))
        if c.tpot_s is not None:
            self._observe("tpot_s", c.tpot_s)
            self.tpot_ema_s = c.tpot_s if self.tpot_ema_s is None else (
                (1.0 - _TPOT_EMA_ALPHA) * self.tpot_ema_s
                + _TPOT_EMA_ALPHA * c.tpot_s)
            set_gauge("serving.tpot_ema_ms", self.tpot_ema_s * 1e3)
        if c.latency_s is not None:
            self._observe("latency_s", c.latency_s)
        # the span chain complete? (the submit span always exists; admit and
        # first token are the waypoints a lost trace would have dropped)
        if c.trace_id is not None and c.admit_t is not None \
                and c.first_token_t is not None:
            self._trace_complete += 1
        set_gauge("serving.deadline_miss_rate", self.deadline_miss_rate())
        record_event("serve_finish", str(rid), n_tokens=n_tokens,
                     latency_s=round(c.latency_s, 6), trace=c.trace_id,
                     evictions=c.evictions, deadline_miss=miss)
        bump("serving.requests_finished")

    # -- estimates (admission control reads these) -------------------------
    def est_first_token_s(self) -> Optional[float]:
        """Recent mean admit → first-token latency."""
        if not self._ft_window:
            return None
        return sum(self._ft_window) / len(self._ft_window)

    def finish_rate_per_s(self) -> Optional[float]:
        """Finished requests/s over the current window."""
        if len(self._window) < 2:
            return None
        span = self._window[-1][0] - self._window[0][0]
        if span <= 0:
            return None
        return (len(self._window) - 1) / span

    def deadline_miss_rate(self) -> float:
        """Fraction of deadline-carrying finishes in the window that
        missed (0.0 when none carried a deadline)."""
        hits = [m for (_, _, _, _, m) in self._window if m is not None]
        if not hits:
            return 0.0
        return sum(1 for m in hits if m) / len(hits)

    # -- gauges ------------------------------------------------------------
    def set_queue_depth(self, n: int) -> None:
        self.queue_depth = int(n)
        set_gauge("serving.queue_depth", float(n))

    def set_occupancy(self, frac: float) -> None:
        self.occupancy = float(frac)
        self.occupancy_peak = max(self.occupancy_peak, float(frac))
        set_gauge("serving.kv_pool_occupancy", float(frac))

    def set_kv_bytes_per_token(self, b: float, per_member: Optional[float] = None) -> None:
        """Device bytes one KV token slot costs (arena + scales, all
        layers): the denominator the int8/fp8 page halving shows up in.
        ``per_member``: what each member of a tensor-parallel engine holds
        of it (``b`` itself with one member)."""
        self.kv_bytes_per_token = float(b)
        self.kv_bytes_per_token_member = float(b if per_member is None else per_member)
        set_gauge("serving.kv_bytes_per_token", float(b))

    def spec_step(self, *, proposed: int, accepted: int, emitted: int,
                  rows: int) -> None:
        """One speculative verify step over ``rows`` live rows: ``proposed``
        drafts went in, ``accepted`` matched the target's argmax,
        ``emitted`` tokens came out (at least one a row)."""
        self.spec_proposed_total += int(proposed)
        self.spec_accepted_total += int(accepted)
        self.spec_emitted_total += int(emitted)
        self.spec_rows_total += int(rows)
        self.spec_verify_steps += 1
        set_gauge("serving.spec_acceptance_rate", self.spec_acceptance())
        set_gauge("serving.effective_tokens_per_step", self.effective_tokens_per_step())
        bump("serving.spec_tokens_proposed_total", int(proposed))
        bump("serving.spec_tokens_accepted_total", int(accepted))

    def spec_acceptance(self) -> float:
        """Fraction of drafted tokens the target's own argmax confirmed."""
        if self.spec_proposed_total <= 0:
            return 0.0
        return self.spec_accepted_total / self.spec_proposed_total

    def effective_tokens_per_step(self) -> float:
        """Mean tokens emitted a row per verify step (serial decode: 1.0)."""
        if self.spec_rows_total <= 0:
            return 0.0
        return self.spec_emitted_total / self.spec_rows_total

    # -- rollup ------------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        """SLO rollup (milliseconds); percentiles over the bounded window,
        totals exact."""
        ttft = [t * 1e3 for (_, t, _, _, _) in self._window if t is not None]
        tpot = [t * 1e3 for (_, _, t, _, _) in self._window if t is not None]
        lat = [t * 1e3 for (_, _, _, t, _) in self._window if t is not None]
        span = None
        if self._t_first_submit is not None and \
                self._t_last_finish is not None:
            span = max(self._t_last_finish - self._t_first_submit, 1e-9)
        n = self.finished_total
        ident = identity()
        return {
            "wall_time": time.time(),
            "replica": ident.get("replica"),
            "rank": ident.get("rank"),
            "trace_coverage": round(self._trace_complete / n, 4) if n
            else 1.0,
            "requests_finished": n,
            "requests_shed": self.shed_total,
            "shed_reasons": dict(self.shed_reasons),
            "requests_rejected": self.rejected_total,
            "requests_per_sec": round(n / span, 3) if span else None,
            "ttft_ms_p50": _r(_pct(ttft, 50)),
            "ttft_ms_p99": _r(_pct(ttft, 99)),
            "tpot_ms_p50": _r(_pct(tpot, 50)),
            "tpot_ms_p99": _r(_pct(tpot, 99)),
            "latency_ms_p50": _r(_pct(lat, 50)),
            "latency_ms_p99": _r(_pct(lat, 99)),
            "deadline_miss_rate": round(self.deadline_miss_rate(), 4),
            "evictions": self.evictions_total,
            "kv_pool_occupancy_peak": round(self.occupancy_peak, 4),
            "spec_acceptance": (round(self.spec_acceptance(), 4)
                                if self.spec_verify_steps else None),
            "effective_tokens_per_step": (
                round(self.effective_tokens_per_step(), 4)
                if self.spec_verify_steps else None),
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "kv_offloads": self.offloads_total,
            "kv_recalls": self.recalls_total,
            "kv_offload_stalls": self.offload_stalls_total,
            "kv_offload_bytes_out": self.offload_bytes_out_total,
            "kv_recall_bytes_in": self.recall_bytes_in_total,
            "kv_recall_bytes_per_token": round(
                self.kv_recall_bytes_per_token(), 3),
            "tpot_ema_ms": _r(None if self.tpot_ema_s is None
                              else self.tpot_ema_s * 1e3),
        }


class FleetMeter:
    """Fleet-level counters/gauges for the multi-replica frontend
    (:class:`~.fleet.ServingFrontend`): live replica
    count, per-replica queue depth, failovers, replayed requests, drain
    hand-backs.  Same runtime seam as :class:`SLOMeter`, so the fleet
    story lands in ``telemetry.counters()`` / ``prometheus_text()`` and
    the flight recorder for free."""

    def __init__(self):
        self.failovers_total = 0
        self.replayed_requests_total = 0
        self.handbacks_total = 0
        self.live_replicas = 0
        self.scale_out_total = 0
        self.scale_in_total = 0
        self.serving_replicas = 0
        self.warming_replicas = 0
        self.draining_replicas = 0
        self.degraded_replicas = 0
        self.degraded_ejects_total = 0
        self.degraded_readmits_total = 0
        self.last_autoscale: Optional[Dict[str, object]] = None
        self.prefill_routed_total = 0
        self.prefill_fallbacks_total = 0
        self.prefix_hit_rate: Optional[float] = None
        self.tier_occupancy: Dict[str, float] = {}

    def set_live_replicas(self, n: int) -> None:
        self.live_replicas = int(n)
        set_gauge("serving.fleet_live_replicas", float(n))

    def set_replica_queue_depth(self, name: str, depth: int) -> None:
        set_gauge(f"serving.fleet_queue_depth.{name}", float(depth))

    def set_fleet_states(self, serving: int, warming: int,
                         draining: int, degraded: int = 0) -> None:
        """Per-state replica gauges (SERVING / WARMING / DRAINING /
        DEGRADED), as the autoscaler's lease scan counts them."""
        self.serving_replicas = int(serving)
        self.warming_replicas = int(warming)
        self.draining_replicas = int(draining)
        self.degraded_replicas = int(degraded)
        set_gauge("serving.fleet_serving_replicas", float(serving))
        set_gauge("serving.fleet_warming_replicas", float(warming))
        set_gauge("serving.fleet_draining_replicas", float(draining))
        set_gauge("serving.fleet_degraded_replicas", float(degraded))

    def degrade(self, name: str, *, tpot_ema_ms: Optional[float],
                median_ms: Optional[float]) -> None:
        """One replica ejected from routing as a latency outlier (EWMA
        TPOT over the fleet median by the straggler factor)."""
        self.degraded_ejects_total += 1
        bump("serving.fleet_degraded_ejects_total")
        record_event("serve_fleet_degraded", str(name),
                     tpot_ema_ms=tpot_ema_ms, median_ms=median_ms)

    def readmit(self, name: str, *,
                tpot_ema_ms: Optional[float] = None) -> None:
        """A previously degraded replica whose probe came back clean
        rejoins the routable pool."""
        self.degraded_readmits_total += 1
        bump("serving.fleet_degraded_readmits_total")
        record_event("serve_fleet_readmit", str(name),
                     tpot_ema_ms=tpot_ema_ms)

    def autoscale(self, direction: str, *, target: int,
                  reason: str) -> None:
        """One autoscale decision acted on (``direction`` is ``out`` or
        ``in``); stamps the flight recorder so the merged black box shows
        WHY capacity moved."""
        if direction == "out":
            self.scale_out_total += 1
            bump("serving.fleet_scale_out_total")
        else:
            self.scale_in_total += 1
            bump("serving.fleet_scale_in_total")
        self.last_autoscale = {"direction": str(direction),
                               "target": int(target),
                               "reason": str(reason)}
        record_event("autoscale_decision", str(direction),
                     target=int(target), reason=str(reason))

    def set_prefix_hit_rate(self, rate: Optional[float]) -> None:
        """Fleet-wide prefix-cache hit rate (token-weighted mean over the
        replicas that publish one; ``None`` when no replica caches)."""
        self.prefix_hit_rate = None if rate is None else float(rate)
        if rate is not None:
            set_gauge("serving.fleet_prefix_hit_rate", float(rate))

    def set_tier_occupancy(self, tier: str, occupancy: float) -> None:
        """Mean load of one serving tier (``prefill`` / ``decode``), as
        the frontend's lease scan measures it — the capacity-planning
        signal for the disaggregated split."""
        self.tier_occupancy[str(tier)] = float(occupancy)
        set_gauge(f"serving.fleet_tier_occupancy.{tier}", float(occupancy))

    def prefill_route(self, name: str, rid: int) -> None:
        """One long prompt routed through the dedicated prefill tier."""
        self.prefill_routed_total += 1
        bump("serving.fleet_prefill_routed_total")
        record_event("fleet_prefill_route", str(name), rid=int(rid))

    def prefill_fallback(self, name: str, rid: int, reason: str) -> None:
        """A prefill-tier attempt abandoned mid-flight (worker death,
        fenced epoch, pruned KV frames) — the request fell back to a
        plain decode-tier prefill, exactly-once preserved."""
        self.prefill_fallbacks_total += 1
        bump("serving.fleet_prefill_fallbacks_total")
        record_event("fleet_prefill_fallback", str(name), rid=int(rid),
                     reason=str(reason))

    def disagg_doc(self) -> Dict[str, object]:
        """The frontend's disaggregation self-report, pushed to the
        metrics depot as the ``disagg`` extra (the report CLI's
        prefix-hit-rate / per-tier occupancy rows; latest ``wall_time``
        wins in the rollup, mirroring ``autoscale``)."""
        return {"prefix_hit_rate": self.prefix_hit_rate,
                "tier_occupancy": dict(self.tier_occupancy),
                "prefill_routed_total": self.prefill_routed_total,
                "prefill_fallbacks_total": self.prefill_fallbacks_total}

    def failover(self, name: str, replayed: int = 0) -> None:
        self.failovers_total += 1
        self.replayed_requests_total += int(replayed)
        bump("serving.fleet_failovers_total")
        if replayed:
            bump("serving.fleet_requests_replayed_total", int(replayed))
        record_event("serve_fleet_failover", str(name),
                     replayed=int(replayed))

    def handback(self, name: str, moved: int = 0) -> None:
        self.handbacks_total += int(moved)
        if moved:
            bump("serving.fleet_handbacks_total", int(moved))
        record_event("serve_fleet_drain", str(name), moved=int(moved))

    def summary(self) -> Dict[str, object]:
        return {"live_replicas": self.live_replicas,
                "failovers": self.failovers_total,
                "replayed_requests": self.replayed_requests_total,
                "handbacks": self.handbacks_total,
                "scale_out": self.scale_out_total,
                "scale_in": self.scale_in_total,
                "serving_replicas": self.serving_replicas,
                "warming_replicas": self.warming_replicas,
                "draining_replicas": self.draining_replicas,
                "degraded_replicas": self.degraded_replicas,
                "degraded_ejects": self.degraded_ejects_total,
                "degraded_readmits": self.degraded_readmits_total,
                "last_autoscale": self.last_autoscale,
                "prefill_routed": self.prefill_routed_total,
                "prefill_fallbacks": self.prefill_fallbacks_total,
                "prefix_hit_rate": self.prefix_hit_rate,
                "tier_occupancy": dict(self.tier_occupancy)}
