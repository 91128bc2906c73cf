"""Admission control and load shedding for the serving engine (port of the
reference's ``serving/admission.py``, pure Python): the front door that
detects overload early, refuses work the engine cannot finish, and keeps
the work it accepted inside its SLO.

Three mechanisms, all consulted by :meth:`ServingEngine.submit` /
:meth:`ServingEngine.step`:

- **Bounded queue** — admission refuses at ``submit`` with
  :class:`Overloaded` once ``max_queue`` requests wait, instead of growing
  the backlog until every queued deadline is dead on arrival.  The error
  carries ``retry_after_s`` derived from the :class:`SLOMeter`'s measured
  drain rate (queue depth / recent finish rate), so clients back off by
  observed capacity, not a guess.
- **Deadline shedding** — a request may attach a :class:`Deadline` (TTFT
  and/or total budget, seconds from submit).  Each scheduler step sheds
  queued requests whose TTFT budget is already spent or provably
  unreachable (remaining budget < the meter's recent submit→first-token
  estimate): serving them would burn pool pages and decode slots on output
  the client has stopped waiting for, stealing capacity from requests that
  can still make their SLO.
- **Circuit breaker** — repeated step failures (storage flake on the
  journal, injected ``serve`` faults, transient runtime errors) open the
  breaker: admission pauses (``submit`` raises :class:`Overloaded`) for a
  cooldown, then half-opens to probe; the first successful step closes it.
  Already-admitted requests keep being served — the breaker sheds *new*
  load, it never drops accepted work.

The breaker's telemetry events (``serve_breaker_open``/``_close``) wait
for the port of the telemetry layer (ROADMAP A8).

Env knobs: ``PADDLE_TPU_SERVE_MAX_QUEUE`` (default 64),
``PADDLE_TPU_SERVE_BREAKER_THRESHOLD`` (consecutive step failures before
opening, default 3), ``PADDLE_TPU_SERVE_BREAKER_COOLDOWN`` (seconds open
before half-open, default 5).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import os

__all__ = ["Overloaded", "Deadline", "CircuitBreaker", "AdmissionController",
           "warming_retry_hint"]


def _env_int(name: str, default: int) -> int:
    """Int env knob with a safe fallback."""
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    """Float env knob with a safe fallback."""
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def warming_retry_hint(retry_after_s: Optional[float], warming: int,
                       eta_s: Optional[float] = None) -> Optional[float]:
    """Cap an :class:`Overloaded` retry hint by capacity that is already
    warming up: with ``warming`` scale-out replicas in flight, a client
    should retry when the new replica starts taking traffic
    (``PADDLE_TPU_AS_WARMUP_ETA_S``, default 5s — roughly AOT-cache
    checkpoint-load time, not a compile), not after the CURRENT fleet's
    drain-rate-only estimate.  With nothing warming the hint passes
    through unchanged."""
    if warming <= 0:
        return retry_after_s
    if eta_s is None:
        eta_s = _env_float("PADDLE_TPU_AS_WARMUP_ETA_S", 5.0)
    if retry_after_s is None:
        return round(float(eta_s), 3)
    return round(min(float(retry_after_s), float(eta_s)), 3)


class Overloaded(RuntimeError):
    """Admission refused: the engine is at capacity (bounded queue full)
    or recovering from step failures (circuit breaker open).  Retriable —
    ``retry_after_s`` is the engine's estimate of when capacity frees up,
    derived from measured drain rates where available."""

    def __init__(self, message: str, retry_after_s: Optional[float] = None,
                 reason: str = "queue_full"):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.reason = reason


@dataclass(frozen=True)
class Deadline:
    """Per-request latency budget, seconds from ``submit``.

    ``ttft_s`` bounds arrival → first token (the budget the shedder
    enforces on queued requests); ``total_s`` bounds arrival → last token.
    Either may be ``None`` (unbounded).  A deadline also changes the
    preemption policy: under pool pressure the engine evicts the active
    request with the MOST remaining slack, not the youngest."""

    ttft_s: Optional[float] = None
    total_s: Optional[float] = None

    def __post_init__(self):
        for name in ("ttft_s", "total_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")

    def to_doc(self) -> dict:
        return {"ttft_s": self.ttft_s, "total_s": self.total_s}

    @classmethod
    def from_doc(cls, doc) -> Optional["Deadline"]:
        if not doc:
            return None
        return cls(ttft_s=doc.get("ttft_s"), total_s=doc.get("total_s"))


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker over the engine's step loop.

    ``closed`` → normal admission.  ``threshold`` consecutive
    :meth:`note_failure` calls open it; while ``open``, :meth:`allow`
    refuses until ``cooldown_s`` elapses, then the breaker half-opens
    (admission resumes on probation) and the next :meth:`note_success`
    closes it — a failure while half-open re-opens immediately."""

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None, now=time.monotonic):
        self.threshold = threshold if threshold is not None else \
            _env_int("PADDLE_TPU_SERVE_BREAKER_THRESHOLD", 3)
        if cooldown_s is None:
            cooldown_s = _env_float("PADDLE_TPU_SERVE_BREAKER_COOLDOWN", 5.0)
        self.cooldown_s = float(cooldown_s)
        self._now = now
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.open_count = 0

    def note_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN or (
                self.state == CLOSED
                and self.consecutive_failures >= self.threshold):
            self.state = OPEN
            self.opened_at = self._now()
            self.open_count += 1

    def note_success(self) -> None:
        self.consecutive_failures = 0
        if self.state != CLOSED:
            self.state = CLOSED
            self.opened_at = None

    def allow(self) -> bool:
        """May a new request be admitted right now?  Flips open →
        half-open when the cooldown has elapsed."""
        if self.state == CLOSED or self.state == HALF_OPEN:
            return True
        if self.opened_at is not None and \
                self._now() - self.opened_at >= self.cooldown_s:
            self.state = HALF_OPEN
            return True
        return False

    def retry_after_s(self) -> float:
        """Remaining cooldown (0 when not open)."""
        if self.state != OPEN or self.opened_at is None:
            return 0.0
        return max(0.0, self.cooldown_s - (self._now() - self.opened_at))


class AdmissionController:
    """Front-door policy for :class:`ServingEngine`: bounded queue +
    circuit breaker at ``submit``, deadline shedding over the queue each
    step.  Owns no request state — it reads the engine's queue and the
    meter's rate estimates and says yes/no."""

    def __init__(self, *, max_queue: Optional[int] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 now=time.monotonic):
        self.max_queue = max_queue if max_queue is not None else \
            _env_int("PADDLE_TPU_SERVE_MAX_QUEUE", 64)
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.breaker = breaker or CircuitBreaker(now=now)
        self._now = now

    # -- submit-time gate --------------------------------------------------
    def check(self, queue_depth: int, meter) -> None:
        """Raise :class:`Overloaded` when a new request must be refused
        (breaker open, or bounded queue full)."""
        if not self.breaker.allow():
            raise Overloaded(
                f"admission paused: circuit breaker open after "
                f"{self.breaker.consecutive_failures} consecutive step "
                f"failures (retry in {self.breaker.retry_after_s():.2f}s)",
                retry_after_s=round(self.breaker.retry_after_s(), 3),
                reason="breaker_open")
        if queue_depth >= self.max_queue:
            hint = self.retry_after_hint(queue_depth, meter)
            raise Overloaded(
                f"admission queue full ({queue_depth}/{self.max_queue} "
                f"waiting); retry in ~{hint:.2f}s",
                retry_after_s=hint, reason="queue_full")

    def retry_after_hint(self, queue_depth: int, meter) -> float:
        """When one queue slot should free up, from the meter's measured
        drain rate; falls back to the recent prefill estimate, then 1s."""
        rate = meter.finish_rate_per_s() if meter is not None else None
        if rate:
            return round(max(queue_depth, 1) / rate, 3)
        est = meter.est_first_token_s() if meter is not None else None
        if est:
            return round(est, 3)
        return 1.0

    # -- step-time shedding ------------------------------------------------
    def shed_reason(self, *, submit_t: float, deadline: Optional[Deadline],
                    first_token_out: bool, meter) -> Optional[str]:
        """Why a QUEUED request should be shed now (None = keep it).

        A request that already delivered its first token (eviction requeue
        or journal replay) has met its TTFT — only the total budget can
        shed it then."""
        if deadline is None:
            return None
        now = self._now()
        if deadline.total_s is not None and \
                now - submit_t > deadline.total_s:
            return "total_expired"
        if deadline.ttft_s is None or first_token_out:
            return None
        remaining = (submit_t + deadline.ttft_s) - now
        if remaining <= 0:
            return "ttft_expired"
        est = meter.est_first_token_s() if meter is not None else None
        if est is not None and est > remaining:
            return "ttft_unreachable"
        return None
