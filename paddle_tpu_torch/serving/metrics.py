"""Per-request SLO metrics for the serving engine (port of the reference's
``serving/metrics.py``: :class:`RequestClock` and :class:`SLOMeter`).

The meter prices a REQUEST: TTFT (arrival → first token), TPOT (mean
inter-token gap over the decode phase), end-to-end latency, and the gauges
a capacity planner reads (queue depth, KV-pool occupancy, requests/s, shed
and deadline-miss rates, KV bytes per token).  Memory is bounded:
percentiles roll over a window of the most recent finished requests
(``PADDLE_TPU_SERVE_SLO_WINDOW``, default 1024), per-request clocks are
dropped at finish or shed, and the exact totals are O(1) counters.

``summary()`` has the reference's keys.  The reference also exports every
gauge, counter and histogram through its telemetry layer (Prometheus text,
the flight recorder, the metrics depot): that export waits for the port of
the telemetry layer (ROADMAP A8).  The offload tier and speculative
decoding are not ported either: their fields read as the reference's do
with those features off.  ``FleetMeter`` belongs to the serving fleet (A8).
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from .admission import _env_int

__all__ = ["RequestClock", "SLOMeter"]


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
        self.tokens_out_total = 0        # new tokens
        self.tokens_replayed_total = 0   # recomputed after an eviction
        self.tpot_ema_s: Optional[float] = None
        self._trace_complete = 0

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

    def admit(self, rid, *, queue_depth: int, pages: int) -> None:
        self._clocks[rid].admit_t = self._now()

    def first_token(self, rid) -> None:
        t = self._now()
        c = self._clocks[rid]
        if c.first_token_t is None:
            c.first_token_t = t     # an eviction-replay re-prefill must
            if c.admit_t is not None:    # not reset the client's TTFT
                self._ft_window.append(t - c.admit_t)
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
        else:
            self.tokens_out_total += 1

    def evict(self, rid, *, reason: str, pages_freed: int) -> None:
        c = self._clocks[rid]
        c.evictions += 1
        self.evictions_total += 1
        # the restarted prefill regenerates from scratch: token milestones
        # reset (the retained first_token_t stands — the client saw it)
        c.replay_watermark = max(c.replay_watermark, c.n_tokens)
        c.n_tokens = 0

    def shed(self, rid, *, reason: str) -> None:
        """A queued request dropped by deadline shedding: it will never
        run — fold its clock away."""
        self._clocks.pop(rid, None)
        self.shed_total += 1
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1

    def reject(self, *, reason: str,
               retry_after_s: Optional[float] = None) -> None:
        """An Overloaded refusal at submit (bounded queue / breaker)."""
        self.rejected_total += 1

    def defer(self, rid, *, defers: int, need: int, free: int) -> None:
        """The FIFO head was bypassed under pool pressure."""
        self.defers_total += 1

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
        self._window.append((c.finish_t, c.ttft_s, c.tpot_s, c.latency_s,
                             miss))
        if c.tpot_s is not None:
            self.tpot_ema_s = c.tpot_s if self.tpot_ema_s is None else (
                (1.0 - _TPOT_EMA_ALPHA) * self.tpot_ema_s
                + _TPOT_EMA_ALPHA * c.tpot_s)
        if c.trace_id is not None and c.admit_t is not None \
                and c.first_token_t is not None:
            self._trace_complete += 1

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

    def set_occupancy(self, frac: float) -> None:
        self.occupancy = float(frac)
        self.occupancy_peak = max(self.occupancy_peak, float(frac))

    def set_kv_bytes_per_token(self, b: float) -> None:
        """Device bytes one KV token slot costs (arena + scales, all
        layers): the denominator the int8/fp8 page halving shows up in."""
        self.kv_bytes_per_token = float(b)

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
        rank = os.environ.get("PADDLE_TRAINER_ID")
        return {
            "wall_time": time.time(),
            "replica": os.environ.get("PADDLE_TPU_SERVE_REPLICA") or None,
            "rank": int(rank) if rank is not None and rank.lstrip("-").isdigit()
            else None,
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
            "spec_acceptance": None,
            "effective_tokens_per_step": None,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "kv_offloads": 0,
            "kv_recalls": 0,
            "kv_offload_stalls": 0,
            "kv_offload_bytes_out": 0,
            "kv_recall_bytes_in": 0,
            "kv_recall_bytes_per_token": 0.0,
            "tpot_ema_ms": _r(None if self.tpot_ema_s is None
                              else self.tpot_ema_s * 1e3),
        }
