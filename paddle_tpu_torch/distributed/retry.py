"""Single home for exponential-backoff-with-jitter.

Three near-copies of the same backoff loop grew up independently —
``checkpoint/storage.retry_io`` (I/O flake absorption), the replicator
client's transparent reconnect, and the elastic supervisor's
``RestartPolicy`` — each with its own exponent convention and jitter
seeding.  This module is the one implementation they all route through.

Design constraints:

* **stdlib-only** — the replicator and fault-domain modules are loaded
  standalone (no package side effects) by launcher subprocesses;
  this module must import nothing heavier than ``random``/``time``.
* **golden-value compatible** — the delay sequences produced by the
  pre-existing call sites are pinned by tests and by operator muscle
  memory.  :meth:`BackoffPolicy.delay` reproduces both conventions
  exactly (see the attempt-numbering note below), so re-routing the
  legacy sites is a pure refactor.

Attempt numbering: ``delay(attempt)`` takes a **0-based** attempt index
(first retry = 0).  The deterministic per-attempt RNG stream is seeded
``seed * 1_000_003 + attempt + 1`` so that the supervisor's historical
1-based ``restart_num`` stream (``seed * 1_000_003 + restart_num``)
falls out of ``delay(restart_num - 1)`` unchanged.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

__all__ = ["BackoffPolicy", "retry_call"]


@dataclass
class BackoffPolicy:
    """Exponential backoff with multiplicative jitter.

    ``delay(attempt) = min(cap, base * 2**attempt) * (1 + jitter * u)``
    where ``u ~ U[0, 1)`` drawn from (in precedence order) an explicit
    ``rng`` argument, a per-attempt ``random.Random`` derived from
    ``seed`` when one is set, or the module-level ``random``.
    """

    base: float = 1.0
    cap: float = 60.0
    jitter: float = 0.25
    seed: Optional[int] = None

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        d = min(self.cap, self.base * (2 ** max(0, attempt)))
        if rng is None:
            if self.seed is not None:
                rng = random.Random(self.seed * 1_000_003 + attempt + 1)
            else:
                rng = random  # type: ignore[assignment]
        return d * (1.0 + self.jitter * rng.random())


def retry_call(fn: Callable[[], object],
               *,
               attempts: int,
               policy: Optional[BackoffPolicy] = None,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               raise_now: Tuple[Type[BaseException], ...] = (),
               on_retry: Optional[
                   Callable[[int, BaseException, float], None]] = None,
               rng: Optional[random.Random] = None,
               sleep: Callable[[float], None] = time.sleep):
    """Call ``fn`` up to ``attempts`` times, backing off between failures.

    ``raise_now`` is checked *before* ``retry_on`` so a subclass that
    must never be absorbed (``FileNotFoundError`` under ``OSError``)
    propagates on the first occurrence.  ``on_retry(attempt, exc,
    backoff_s)`` fires once per absorbed failure, before the backoff
    sleep — the hook the call sites use for telemetry.  With
    ``policy=None`` the retries are immediate (the replicator's
    reconnect-once pattern) and ``backoff_s`` is 0.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except raise_now:
            raise
        except retry_on as e:  # noqa: PERF203 — the loop IS the point
            last = e
            if attempt == attempts - 1:
                break
            d = 0.0 if policy is None else policy.delay(attempt, rng=rng)
            if on_retry is not None:
                on_retry(attempt, e, d)
            if d > 0.0:
                sleep(d)
    assert last is not None
    raise last
