"""Replica selection for the serving fleet frontend.

Pure policy, no I/O: the frontend snapshots replica health (lease
payloads published by each replica) into :class:`ReplicaStatus` rows and
asks :class:`Router` to pick one.  Policy is least-loaded with
deadline-aware spill:

- **least-loaded** — smallest ``(queue_depth + active) / capacity``;
  ties break on name for determinism.
- **deadline-aware spill** — a replica whose measured
  ``est_first_token_s`` cannot meet the request's remaining TTFT budget
  is skipped, so latency-sensitive traffic spills toward replicas that
  can still make the SLO.  When NO replica can, the pick falls back to
  the least-loaded one anyway: the estimate is a trailing measurement
  (often stale right after a load shift), and the engine's own
  admission/shed machinery is the authoritative judge — shedding there
  is accounted, shedding here silently would not be.
- **draining replicas** are never picked (see
  :meth:`fleet.ServingFrontend.drain`).
- **degraded replicas** (latency outliers ejected by the frontend's
  EWMA-TPOT-vs-fleet-median scan) are route-excluded exactly like
  draining ones; they rejoin when the frontend re-admits them after a
  clean probe.
- **warming replicas** (scale-outs that have not completed a first
  step — their ``est_first_token_s`` is unmeasured and includes a cold
  checkpoint load) are excluded from deadline-bound spill the same way
  an over-budget estimate is, but stay routable for traffic without a
  TTFT budget; when EVERY routable replica is warming the pick falls
  back rather than refusing (same rationale as the all-spilled case).
- **tiers** (disaggregated serving) — replicas advertise a ``tier``
  (``decode`` by default; ``prefill`` for the dedicated prefill tier).
  A tier-targeted pick PREFERS matching replicas and falls back to the
  whole candidate set when the tier is empty/dead — TTFT-bound long
  prompts land on prefill capacity when it exists, but the fleet
  degrades to homogeneous serving rather than refusing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..telemetry import record_event
from .admission import Deadline

__all__ = ["ReplicaStatus", "Router"]


@dataclass
class ReplicaStatus:
    """One replica's routable view, as published on its heartbeat lease."""

    name: str
    address: str = ""
    capacity: int = 1                # queue slots the replica admits
    queue_depth: int = 0
    active: int = 0                  # requests holding decode rows
    est_first_token_s: Optional[float] = None
    epoch: int = 0                   # fencing incarnation
    draining: bool = False
    warming: bool = False            # no completed step yet (cold start)
    degraded: bool = False           # latency outlier, route-excluded
    tpot_ema_ms: Optional[float] = None   # decode-speed trend (EWMA)
    tier: str = "decode"             # serving tier (prefill / decode)
    extra: dict = field(default_factory=dict)

    @property
    def load(self) -> float:
        return (self.queue_depth + self.active) / max(1, self.capacity)

    @classmethod
    def from_doc(cls, name: str, doc: dict) -> "ReplicaStatus":
        return cls(name=name,
                   address=str(doc.get("address", "")),
                   capacity=int(doc.get("capacity", 1)),
                   queue_depth=int(doc.get("queue_depth", 0)),
                   active=int(doc.get("active", 0)),
                   est_first_token_s=doc.get("est_first_token_s"),
                   epoch=int(doc.get("epoch", 0)),
                   draining=bool(doc.get("draining", False)),
                   warming=bool(doc.get("warming", False)),
                   degraded=bool(doc.get("degraded", False)),
                   tpot_ema_ms=doc.get("tpot_ema_ms"),
                   tier=str(doc.get("tier", "decode")))


class Router:
    """Stateless pick over a list of :class:`ReplicaStatus`."""

    def pick(self, replicas: List[ReplicaStatus],
             deadline: Optional[Deadline] = None, *,
             age_s: float = 0.0,
             tier: Optional[str] = None,
             trace_id: Optional[str] = None) -> Optional[ReplicaStatus]:
        """Best replica for one request, or ``None`` when no routable
        replica exists at all (every one dead, draining or degraded).
        ``tier`` is a PREFERENCE: matching replicas win when any are
        routable, otherwise the pick falls back to the full candidate
        set (a fleet whose prefill tier died keeps serving).  With a
        ``trace_id`` the decision is stamped into the flight recorder
        (``fleet_route``) so the merged black box shows WHY a request
        landed where it did."""
        cands = [r for r in replicas if not r.draining and not r.degraded]
        if not cands:
            return None
        if tier is not None:
            tiered = [r for r in cands if r.tier == tier]
            if tiered:
                cands = tiered
        budget = None
        if deadline is not None and deadline.ttft_s is not None:
            budget = deadline.ttft_s - age_s
        spilled = False
        if budget is not None:
            # a WARMING replica's first token costs an unmeasured cold
            # start on top of any estimate: deadline-bound traffic never
            # spills onto it while a warmed replica exists
            fits = [r for r in cands
                    if not r.warming
                    and (r.est_first_token_s is None
                         or r.est_first_token_s <= budget)]
            if fits:
                spilled = len(fits) < len(cands)
                cands = fits   # spill toward replicas that can make TTFT
        best = min(cands, key=lambda r: (r.load, r.name))
        if trace_id is not None:
            record_event("fleet_route", best.name, trace=trace_id,
                         load=round(best.load, 4), spilled=spilled,
                         candidates=len(replicas))
        return best

    def order(self, replicas: List[ReplicaStatus],
              deadline: Optional[Deadline] = None, *,
              age_s: float = 0.0,
              tier: Optional[str] = None,
              trace_id: Optional[str] = None) -> List[ReplicaStatus]:
        """All routable replicas, best first — the frontend walks this so
        a replica-side refusal (``Overloaded``) spills to the next one.
        Only the FIRST pick carries the trace: one routing decision per
        attempt, the spill walk is not N decisions."""
        out: List[ReplicaStatus] = []
        pool = list(replicas)
        while True:
            best = self.pick(pool, deadline, age_s=age_s, tier=tier,
                             trace_id=trace_id if not out else None)
            if best is None:
                return out
            out.append(best)
            pool = [r for r in pool if r.name != best.name]
