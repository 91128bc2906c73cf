"""Elastic fleet autoscaling: signal-driven scale-out/in with lossless
drains and warm starts.

A fleet of fixed capacity can only shed under a traffic step, and after
the step it keeps idle replicas forever.  This module closes the loop — an :class:`Autoscaler` hosted by ``launch
--mode serve`` (next to the lease scan) reads the SAME measured signals
that drive admission (queue depth, occupancy, shed/reject counts,
``finish_rate_per_s`` via the metrics depot) and issues scale decisions
to a :class:`~paddle_tpu_torch.distributed.fleet.elastic.supervisor.
ReplicaPool`:

- **scale-out** — occupancy over ``PADDLE_TPU_AS_UP_THRESH`` (or any
  overload shed/reject since the last tick) spawns a fresh-named replica
  (``pool.scale_to``).  The newcomer adopts a fresh fencing epoch at
  start and advertises ``warming=True`` on its lease until its first
  completed step, so the router never spills a deadline-bound request
  onto a cold replica.
- **scale-in** — occupancy under ``PADDLE_TPU_AS_DOWN_THRESH`` with no
  overload pressure and nothing warming picks the LEAST-loaded serving
  replica and drains it losslessly: ``note_retiring`` at the pool first
  (any exit from here on is intentional — zero restart budget burned,
  never relaunched), then the ``retire`` RPC flips ``draining`` on the
  victim's lease (every frontend route-excludes it) and hands back its
  queued-but-unstarted work, which is re-routed to survivors; finally
  ``stop`` lets the victim finish its ACTIVE requests and exit 0.  A
  SIGKILL landing anywhere mid-drain degrades to the normal lease-expiry
  fence + journal-fold + replay failover — exactly-once tokens hold.
- **hysteresis/cooldown** — the band between the thresholds plus
  ``PADDLE_TPU_AS_COOLDOWN_S`` after every action keeps a noisy load
  signal from flapping capacity.

Hand-back descriptors that find no immediate home (all survivors full)
are parked and retried every tick — the same park-don't-drop contract as
the frontend's failover orphans.

Env knobs: ``PADDLE_TPU_AS_MIN`` (default 1), ``PADDLE_TPU_AS_MAX``
(default 4), ``PADDLE_TPU_AS_UP_THRESH`` (occupancy, default 0.8),
``PADDLE_TPU_AS_DOWN_THRESH`` (default 0.25), ``PADDLE_TPU_AS_COOLDOWN_S``
(default 30), ``PADDLE_TPU_AS_INTERVAL_S`` (tick period, default
cooldown/10 clamped to [0.25, 5]), ``PADDLE_TPU_AS_WARMUP_ETA_S`` (the
client retry hint while capacity warms, see
:func:`.admission.warming_retry_hint`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

from ..distributed.checkpoint.replicator import env_int as _env_int
from ..distributed.fleet.fault_domain import (_adapt_kv, _env_float,
                                              lease_expired)
from ..telemetry import record_event as _event
from .admission import Deadline, Overloaded
from .fleet import FLEET_HB_PREFIX, RemoteReplica, fleet_ttl
from .metrics import FleetMeter
from .router import ReplicaStatus, Router

__all__ = ["FleetSignals", "AutoscalePolicy", "Autoscaler"]

SERVING, WARMING, DRAINING = "SERVING", "WARMING", "DRAINING"
DEGRADED = "DEGRADED"


def _state_of(st: ReplicaStatus) -> str:
    if st.draining:
        return DRAINING
    if st.degraded:
        return DEGRADED
    return WARMING if st.warming else SERVING


@dataclass
class FleetSignals:
    """One scan's fleet-wide load view, as the policy consumes it."""

    serving: int = 0
    warming: int = 0
    draining: int = 0
    degraded: int = 0             # latency outliers, route-excluded
    queue_depth: int = 0          # summed over non-draining replicas
    active: int = 0
    capacity: int = 0
    shed_overload_total: int = 0  # sheds EXCLUDING "drained" hand-backs
    rejected_total: int = 0
    finish_rate_per_s: Optional[float] = None
    statuses: List[ReplicaStatus] = field(default_factory=list)

    @property
    def live(self) -> int:
        """Capacity present or arriving (draining replicas are leaving)."""
        return self.serving + self.warming

    @property
    def occupancy(self) -> float:
        """Work in the system per admit slot, over replicas that will
        still be here: the policy's primary signal."""
        return (self.queue_depth + self.active) / max(1, self.capacity)


@dataclass
class AutoscalePolicy:
    """Pure decision function over :class:`FleetSignals` — no I/O, no
    clocks (cooldown is the :class:`Autoscaler`'s job), so the hysteresis
    band is unit-testable with hand-built signals."""

    min_replicas: int = 1
    max_replicas: int = 4
    up_thresh: float = 0.8
    down_thresh: float = 0.25
    cooldown_s: float = 30.0
    step: int = 1                 # replicas moved per decision

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not (0.0 <= self.down_thresh < self.up_thresh):
            raise ValueError("need 0 <= down_thresh < up_thresh "
                             "(the gap IS the hysteresis band)")

    @classmethod
    def from_env(cls) -> "AutoscalePolicy":
        return cls(
            min_replicas=_env_int("PADDLE_TPU_AS_MIN", 1),
            max_replicas=_env_int("PADDLE_TPU_AS_MAX", 4),
            up_thresh=_env_float("PADDLE_TPU_AS_UP_THRESH", 0.8),
            down_thresh=_env_float("PADDLE_TPU_AS_DOWN_THRESH", 0.25),
            cooldown_s=_env_float("PADDLE_TPU_AS_COOLDOWN_S", 30.0))

    def decide(self, sig: FleetSignals, *,
               pressure: bool = False) -> tuple:
        """``(direction, reason)`` — direction ``"out"``/``"in"``/``None``.
        ``pressure`` is the tick-delta overload signal (sheds excluding
        drains, plus rejects): it forces scale-out below the occupancy
        threshold and vetoes scale-in above none."""
        live = sig.live
        if 0 < live < self.min_replicas:
            # live == 0 is NOT a scale-out case: either the fleet was
            # intentionally stopped (the pod is exiting — respawning
            # would keep it alive forever) or every replica crashed, and
            # crash relaunches are the ReplicaPool's job, not ours
            return "out", "below_min"
        if (pressure or sig.occupancy >= self.up_thresh) \
                and live < self.max_replicas:
            return "out", ("overload_shed" if pressure else "occupancy_high")
        if sig.occupancy <= self.down_thresh and not pressure \
                and sig.warming == 0 and sig.draining == 0 \
                and sig.degraded == 0 \
                and live > self.min_replicas:
            # never shrink while capacity is still arriving (warming) or
            # leaving (a drain in flight): one membership change at a time
            return "in", "occupancy_low"
        return None, "steady"


class Autoscaler:
    """The control loop: scan leases + depot metrics → decide → act.

    ``store`` is the fleet store (any KV ``_adapt_kv`` accepts); ``depot``
    an optional metrics depot client (``metrics_pull`` for fleet-wide
    shed/reject/finish-rate, ``metrics_push`` for the autoscale rollup
    row).  ``pool`` duck-types :class:`ReplicaPool` (``live_names``,
    ``scale_to``, ``note_retiring``); ``retirer`` overrides the default
    RPC drain protocol for in-process fleets (bench), called as
    ``retirer(victim_status, statuses) -> bool``."""

    def __init__(self, store, depot=None, *,
                 policy: Optional[AutoscalePolicy] = None,
                 pool=None,
                 retirer: Optional[Callable[..., bool]] = None,
                 router: Optional[Router] = None,
                 meter: Optional[FleetMeter] = None,
                 ttl: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 now: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 src: str = "autoscaler"):
        self._kv = _adapt_kv(store)
        self.depot = depot
        self.policy = policy or AutoscalePolicy.from_env()
        self.pool = pool
        self._retirer = retirer
        self.router = router or Router()
        self.meter = meter or FleetMeter()
        self.ttl = fleet_ttl(ttl)
        if interval_s is None:
            interval_s = _env_float(
                "PADDLE_TPU_AS_INTERVAL_S",
                min(5.0, max(0.25, self.policy.cooldown_s / 10.0)))
        self.interval_s = float(interval_s)
        self._now = now
        self._wall = wall
        self.src = str(src)
        self._cool_until = 0.0
        self._last_shed = 0
        self._last_rejected = 0
        self._seeded = False          # first tick only sets watermarks
        self.scale_outs = 0
        self.scale_ins = 0
        self.last_decision: Optional[Dict[str, Any]] = None
        self._orphans: List[dict] = []    # handbacks awaiting a new home
        self._stopping: Set[str] = set()  # victims retired, stop pending
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- signals -----------------------------------------------------------
    def signals(self) -> FleetSignals:
        """One pass over the lease table + metrics depot."""
        sig = FleetSignals()
        for key in self._kv.keys(FLEET_HB_PREFIX):
            name = key[len(FLEET_HB_PREFIX):]
            if not name:
                continue
            age = self._kv.age(key)
            if age is None:
                continue
            doc = self._kv.get(key) or {}
            if lease_expired(age, float(doc.get("ttl", self.ttl))):
                continue   # the frontend's scan owns death; we just
                # stop counting the capacity
            st = ReplicaStatus.from_doc(name, doc)
            sig.statuses.append(st)
            if st.draining:
                sig.draining += 1
                continue
            if st.degraded:
                # route-excluded pending probe: its queue/capacity are not
                # admit slots right now, so they stay out of occupancy
                sig.degraded += 1
                continue
            if st.warming:
                sig.warming += 1
            else:
                sig.serving += 1
            sig.queue_depth += st.queue_depth
            sig.active += st.active
            sig.capacity += st.capacity
        if self.pool is not None:
            # a spawn whose lease has not appeared yet is capacity in
            # flight: counting it as warming stops a repeat scale-out
            # racing the newcomer's first heartbeat
            seen = {st.name for st in sig.statuses}
            for name in self.pool.live_names():
                if name not in seen:
                    sig.warming += 1
        if self.depot is not None:
            try:
                docs = self.depot.metrics_pull()
            except OSError:
                docs = {}
            for src, doc in docs.items():
                if src == self.src or not isinstance(doc, dict):
                    continue
                slo = doc.get("slo") or {}
                shed = int(slo.get("requests_shed", 0) or 0)
                drained = int((slo.get("shed_reasons") or {})
                              .get("drained", 0) or 0)
                sig.shed_overload_total += max(0, shed - drained)
                sig.rejected_total += int(
                    slo.get("requests_rejected", 0) or 0)
                rate = slo.get("requests_per_sec")
                if rate:
                    sig.finish_rate_per_s = \
                        (sig.finish_rate_per_s or 0.0) + float(rate)
        return sig

    # -- the loop ----------------------------------------------------------
    def tick(self) -> Optional[str]:
        """One control iteration: returns ``"out"``/``"in"`` when it
        acted, else ``None``."""
        sig = self.signals()
        self._retry_orphans(sig)
        self._finish_stops(sig)
        shed, rej = sig.shed_overload_total, sig.rejected_total
        pressure = self._seeded and (shed > self._last_shed
                                     or rej > self._last_rejected)
        self._last_shed, self._last_rejected = shed, rej
        self._seeded = True
        acted = None
        if self._now() >= self._cool_until:
            direction, reason = self.policy.decide(sig, pressure=pressure)
            if direction == "out":
                acted = self._scale_out(sig, reason)
            elif direction == "in":
                acted = self._scale_in(sig, reason)
        self._publish(sig)
        return acted

    def _scale_out(self, sig: FleetSignals, reason: str) -> Optional[str]:
        target = min(self.policy.max_replicas,
                     max(sig.live + self.policy.step,
                         self.policy.min_replicas))
        if self.pool is None:
            return None
        res = self.pool.scale_to(target)
        if not res.get("spawned"):
            return None
        self.scale_outs += 1
        self._decided("out", target, reason, spawned=res["spawned"])
        return "out"

    def _scale_in(self, sig: FleetSignals, reason: str) -> Optional[str]:
        victims = [st for st in sig.statuses
                   if not st.draining and not st.warming
                   and not st.degraded]
        if len(victims) <= self.policy.min_replicas:
            return None
        victim = min(victims, key=lambda r: (r.load, r.name))
        target = max(self.policy.min_replicas,
                     sig.live - self.policy.step)
        if self.pool is not None:
            # retiring mark FIRST: from here a SIGKILL mid-drain is an
            # intentional stop (no relaunch, no budget burn) — the
            # frontend's failover owns the interrupted work
            self.pool.scale_to(target, victims=[victim.name])
        retirer = self._retirer or self._retire_rpc
        if not retirer(victim, sig.statuses):
            return None
        self.scale_ins += 1
        self._decided("in", target, reason, victim=victim.name)
        return "in"

    def _decided(self, direction: str, target: int, reason: str,
                 **extra) -> None:
        self._cool_until = self._now() + self.policy.cooldown_s
        self.last_decision = {"direction": direction, "target": int(target),
                              "reason": reason, "wall": self._wall(),
                              **extra}
        self.meter.autoscale(direction, target=target, reason=reason)
        _event("fleet_autoscale", direction, target=int(target),
               reason=reason, **{k: str(v) for k, v in extra.items()})

    # -- the default (RPC) drain protocol ----------------------------------
    def _retire_rpc(self, victim: ReplicaStatus,
                    statuses: List[ReplicaStatus]) -> bool:
        if ":" not in str(victim.address):
            return False
        h = RemoteReplica(victim.name, victim.address)
        try:
            handback = h.retire()
        except (OSError, ConnectionError):
            h.close()
            return False   # died under us: lease expiry → failover owns it
        unplaced = self._reroute(handback, statuses,
                                 exclude={victim.name})
        with self._lock:
            self._orphans.extend(unplaced)
            self._stopping.add(victim.name)
        # stop now: the victim finishes its ACTIVE requests, drains to
        # idle, exits 0 (lease released; the pool marks it done).  The
        # handed-back queue entries are already shed("drained") in its
        # journal, so its stop cannot race them.
        try:
            h.stop_replica()
        except (OSError, ConnectionError):
            pass           # SIGKILL mid-drain: failover path takes over
        finally:
            h.close()
        return True

    def _reroute(self, handback: List[dict],
                 statuses: List[ReplicaStatus],
                 exclude: Set[str] = frozenset()) -> List[dict]:
        """Re-home hand-back descriptors on survivors; returns the ones
        no survivor would take right now (parked, retried next tick)."""
        unplaced: List[dict] = []
        cands = [st for st in statuses
                 if st.name not in exclude and ":" in str(st.address)]
        for d in handback:
            deadline = Deadline.from_doc(d.get("deadline"))
            age = float(d.get("age_s", 0.0))
            placed = False
            for st in self.router.order(cands, deadline, age_s=age,
                                        trace_id=d.get("trace_id")):
                h = RemoteReplica(st.name, st.address)
                try:
                    h.submit(d["prompt"], d["max_new_tokens"],
                             d.get("eos_token_id"), deadline=deadline,
                             rid=d.get("rid"), age_s=age,
                             trace_id=d.get("trace_id"))
                    placed = True
                except ValueError:
                    placed = True   # rid already known there: an earlier
                    # reroute landed — idempotent
                except (Overloaded, OSError, ConnectionError):
                    pass
                finally:
                    h.close()
                if placed:
                    break
            if placed:
                _event("fleet_rehome", str(d.get("rid")),
                       trace=d.get("trace_id"))
            else:
                unplaced.append(d)
        return unplaced

    def _retry_orphans(self, sig: FleetSignals) -> None:
        with self._lock:
            orphans, self._orphans = self._orphans, []
        if orphans:
            left = self._reroute(orphans, sig.statuses,
                                 exclude=set(self._stopping))
            with self._lock:
                self._orphans.extend(left)

    def _finish_stops(self, sig: FleetSignals) -> None:
        live = {st.name for st in sig.statuses}
        with self._lock:
            self._stopping &= live   # lease gone = fully stopped

    # -- observability -----------------------------------------------------
    def _publish(self, sig: FleetSignals) -> None:
        self.meter.set_fleet_states(sig.serving, sig.warming, sig.draining,
                                    sig.degraded)
        if self.depot is None:
            return
        doc = {"src": self.src, "wall_time": self._wall(),
               "autoscale": self.autoscale_doc(sig)}
        try:
            self.depot.metrics_push(self.src, doc)
        except OSError:
            pass   # a flaky depot link must not kill the control loop

    def autoscale_doc(self, sig: FleetSignals) -> dict:
        return {"serving": sig.serving, "warming": sig.warming,
                "draining": sig.draining, "degraded": sig.degraded,
                "occupancy": round(sig.occupancy, 4),
                "queue_depth": sig.queue_depth,
                "scale_out_total": self.scale_outs,
                "scale_in_total": self.scale_ins,
                "last_decision": self.last_decision,
                "states": {st.name: _state_of(st)
                           for st in sig.statuses}}

    def summary(self) -> dict:
        with self._lock:
            return {"scale_outs": self.scale_outs,
                    "scale_ins": self.scale_ins,
                    "orphans": len(self._orphans),
                    "stopping": sorted(self._stopping),
                    "last_decision": self.last_decision}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()

            def _loop():
                while not self._stop.wait(self.interval_s):
                    try:
                        self.tick()
                    except Exception:
                        pass   # a flaky store/depot read must not kill
                        # the control loop; the next tick retries
            self._thread = threading.Thread(
                target=_loop, daemon=True, name="paddle-tpu-autoscaler")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
