"""Fleet fault domain: rank heartbeat leases, coordinated abort, gang epoch.

The cluster-level failure story the single-process resilience stack
(atomic checkpoints, ``Supervisor`` relaunch on exit 101, NaN skip-and-rewind)
was missing: on a pod, when ONE rank SIGKILLs or wedges mid-collective, every
other rank blocks forever inside a collective, and nothing above the process knows.
Three legs, all coordinated through the job's ``TCPStore``:

1. **Heartbeat leases** — each rank publishes ``fleet/<job>/hb/<rank>`` from
   a daemon thread every ``PADDLE_TPU_HB_INTERVAL`` seconds; a lease older
   than ``PADDLE_TPU_HB_TTL`` is dead.  The payload carries per-step stamps
   (fed by ``jit.TrainStep`` via :func:`note_step_current`), so a rank that
   is alive-but-stuck-in-step (fresh heartbeat, stale step) is a *straggler*
   — observed and reported — while a dead heartbeat is a *dead rank* —
   poisoned.  One heartbeat implementation (:class:`HeartbeatLease`) serves
   two backends: any KV with ``put/touch/age`` (``FileStore``,
   ``TCPKVStore`` — the ElasticManager path) or a raw ``TCPStore``-shaped
   client (``set/get/age``).

2. **Coordinated abort** — the detecting party (the :class:`LeaseMonitor`
   on the coordinator rank or the launcher, a fired ``CommWatchdog``, or a
   ``HealthGuard`` escalation) writes ``fleet/<job>/poison/<epoch>`` with a
   reason + culprit rank (first writer wins via compare_set).  Every rank's
   poison poll thread converts "wedged in a collective" into a bounded-time
   exit: dump the flight recorder, best-effort emergency checkpoint, then
   ``os._exit(101)`` — with a backstop timer that exits at
   ``PADDLE_TPU_ABORT_DEADLINE`` even if the dump itself hangs.  The whole
   gang fails in seconds instead of hanging for hours.

3. **Gang epoch** — poison keys and the pre-step-0 gang barrier are scoped
   by ``PADDLE_TPU_GANG_EPOCH`` (stamped by ``FleetSupervisor`` per launch
   attempt), so a stale poison from a previous incarnation can never kill
   the relaunched gang.

This module is deliberately **stdlib-only and standalone-loadable** (chaos
tests load it via importlib without importing torch); the store object is
duck-typed and telemetry is reached only when ``paddle_tpu_torch`` is already
imported.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "FLEET_EXIT_CODE", "HeartbeatLease", "LeaseMonitor", "FaultDomain",
    "heartbeat_interval", "lease_expired", "current", "set_current",
    "note_step_current", "poison_current", "from_env", "init_from_env",
    "smoke_check",
]

# numerically equal to fleet.elastic.ELASTIC_EXIT_CODE — every layer of the
# resilience stack exits 101 so the (Fleet)Supervisor relaunches; duplicated
# here so standalone loading needs no package import
FLEET_EXIT_CODE = 101

_HB_PREFIX = "hb/"
_POISON_PREFIX = "poison/"
_STRAGGLER_PREFIX = "straggler/"
# EMA weight for per-rank step wall time riding the heartbeat payload: new
# samples get 1/4 so one GC pause doesn't flag a rank, yet a genuinely
# degraded chip crosses the detection factor within a handful of steps
_STEP_EMA_ALPHA = 0.25


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


# -- lease TTL math ----------------------------------------------------------

def heartbeat_interval(ttl: float, interval: Optional[float] = None,
                       min_interval: float = 0.05) -> float:
    """Beat period for a ``ttl``-second lease: explicit ``interval`` when
    given, else ttl/3 (three missable beats before expiry — one lost write
    or a GC pause must not kill a rank), floored at ``min_interval``."""
    if interval is None:
        interval = ttl / 3.0
    return max(min_interval, float(interval))


def lease_expired(age: Optional[float], ttl: float) -> bool:
    """A lease is dead when its key exists but has not been renewed within
    ``ttl``.  ``age=None`` (key missing) is NOT expiry — a rank that never
    registered is a join problem (the gang barrier's job), not a death."""
    return age is not None and age > ttl


# -- telemetry seam (optional: only when paddle_tpu_torch is already imported)

def _telemetry():
    mod = sys.modules.get("paddle_tpu_torch.telemetry")
    if mod is not None:
        return mod
    if "paddle_tpu_torch" in sys.modules:  # in-package: import is cheap now
        try:
            from paddle_tpu_torch import telemetry

            return telemetry
        except Exception:
            return None
    return None  # standalone/light process: stay torch-free


def _record_event(kind: str, name: str, **data) -> None:
    t = _telemetry()
    if t is not None:
        try:
            t.record_event(kind, name, **data)
        except Exception:
            pass


def _set_gauge(name: str, value: float) -> None:
    t = _telemetry()
    if t is not None:
        try:
            t.set_gauge(name, value)
        except Exception:
            pass


def _dump_recorder(reason: str, extra: Optional[dict] = None) -> str:
    t = _telemetry()
    if t is not None:
        try:
            return t.dump_flight_recorder(reason=reason, extra=extra)
        except Exception:
            pass
    return ""


# -- KV adapters -------------------------------------------------------------

class _RawKV:
    """Duck-type a raw ``TCPStore``-shaped client (set/get/age/keys/
    compare_set/delete_key) into the put/get/age/keys/delete surface the
    lease layer speaks, with JSON values and non-blocking reads (``age``
    probes existence first so a missing key never parks on the server)."""

    def __init__(self, store, prefix: str = ""):
        self._store = store
        self._prefix = prefix

    def _k(self, key: str) -> str:
        return self._prefix + key

    def put(self, key: str, value) -> None:
        self._store.set(self._k(key), json.dumps(value))

    def get(self, key: str):
        if self._store.age(self._k(key)) is None:
            return None
        try:
            return json.loads(self._store.get(self._k(key), timeout=5.0))
        except (TimeoutError, ValueError):
            return None

    def put_if_absent(self, key: str, value) -> bool:
        """First writer wins.  Returns True when OUR value landed."""
        data = json.dumps(value)
        cs = getattr(self._store, "compare_set", None)
        if cs is not None:
            return cs(self._k(key), b"", data) == data.encode()
        if self._store.age(self._k(key)) is not None:
            return False
        self._store.set(self._k(key), data)
        return True

    def delete(self, key: str) -> None:
        self._store.delete_key(self._k(key))

    def keys(self, prefix: str = "") -> List[str]:
        n = len(self._prefix)
        return [k[n:] for k in self._store.keys(self._k(prefix))]

    def age(self, key: str) -> Optional[float]:
        return self._store.age(self._k(key))


class _PutTouchKV:
    """Normalize a put/touch/age KV (FileStore, TCPKVStore) — their ``age``
    reports ``inf`` for a missing key where the lease layer wants None."""

    def __init__(self, kv, prefix: str = ""):
        self._kv = kv
        self._prefix = prefix

    def _k(self, key: str) -> str:
        return self._prefix + key

    def put(self, key: str, value) -> None:
        self._kv.put(self._k(key), value)

    def get(self, key: str):
        return self._kv.get(self._k(key))

    def touch(self, key: str) -> None:
        self._kv.touch(self._k(key))

    def delete(self, key: str) -> None:
        self._kv.delete(self._k(key))

    def keys(self, prefix: str = "") -> List[str]:
        n = len(self._prefix)
        return [k[n:] for k in self._kv.keys(self._k(prefix))]

    def age(self, key: str) -> Optional[float]:
        a = self._kv.age(self._k(key))
        return None if a is None or a == float("inf") else a


def _adapt_kv(store, prefix: str = ""):
    """One heartbeat implementation, two backends: raw TCPStore-shaped
    clients get the JSON adapter, put/touch KVs pass through normalized.
    Idempotent: an already-adapted KV passes through (prefixes stack only
    at first adaptation — callers hand prefixed adapters around)."""
    if isinstance(store, (_RawKV, _PutTouchKV)):
        return store
    if hasattr(store, "put") and hasattr(store, "age"):
        return _PutTouchKV(store, prefix)
    return _RawKV(store, prefix)


# -- heartbeat lease ---------------------------------------------------------

class HeartbeatLease:
    """Daemon-thread lease renewal for one key.

    Beats every :func:`heartbeat_interval` seconds; each beat rewrites the
    payload when it changed (step stamps via :meth:`note_step`) and
    otherwise touches the key when the backend supports it.  Store errors
    are counted, not raised — but once writes have failed continuously for
    longer than ``ttl`` the lease is already dead cluster-wide, so
    ``on_store_lost`` fires (FaultDomain: self-abort — a rank that cannot
    reach the store cannot learn about poison either)."""

    def __init__(self, kv, key: str, ttl: Optional[float] = None,
                 interval: Optional[float] = None,
                 payload: Optional[Dict[str, Any]] = None,
                 min_interval: float = 0.05,
                 on_store_lost: Optional[Callable[[Exception], None]] = None):
        self._kv = _adapt_kv(kv)
        self.key = key
        self.ttl = float(ttl if ttl is not None
                         else _env_float("PADDLE_TPU_HB_TTL", 10.0))
        if interval is None and "PADDLE_TPU_HB_INTERVAL" in os.environ:
            interval = _env_float("PADDLE_TPU_HB_INTERVAL", self.ttl / 3.0)
        self.interval = heartbeat_interval(self.ttl, interval, min_interval)
        self._payload = dict(payload or {})
        self._payload.setdefault("ttl", self.ttl)
        self._dirty = True
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.on_store_lost = on_store_lost
        self.beats = 0
        self.failures = 0
        self._failing_since: Optional[float] = None

    # -- payload -----------------------------------------------------------
    def note_step(self, step: int, dt: Optional[float] = None) -> None:
        """Stamp training progress into the lease (fed by TrainStep): a
        monitor can now tell alive-but-stuck-in-step from dead.  ``dt``
        (this step's wall time, seconds) additionally maintains a
        ``step_dt_ema`` field in the payload — the per-rank signal the
        :class:`LeaseMonitor` compares against the gang median to flag a
        slow (alive, beating, but degraded) rank.  No extra writes: the
        stamp rides the existing beat."""
        with self._lock:
            self._payload["step"] = int(step)
            self._payload["step_ts"] = time.time()
            if dt is not None and dt >= 0:
                prev = self._payload.get("step_dt_ema")
                self._payload["step_dt_ema"] = float(dt) if prev is None \
                    else (1.0 - _STEP_EMA_ALPHA) * float(prev) + \
                    _STEP_EMA_ALPHA * float(dt)
            self._dirty = True

    def update_payload(self, **fields) -> None:
        with self._lock:
            self._payload.update(fields)
            self._dirty = True

    # -- beats -------------------------------------------------------------
    def beat_now(self) -> bool:
        """One renewal; True on success.  Full put when the payload changed
        since the last write, cheap touch otherwise (when supported)."""
        with self._lock:
            dirty = self._dirty
            payload = dict(self._payload, ts=time.time())
            self._dirty = False
        try:
            if not dirty and hasattr(self._kv, "touch"):
                self._kv.touch(self.key)
            else:
                self._kv.put(self.key, payload)
            self.beats += 1
            self._failing_since = None
            return True
        except Exception as e:
            self.failures += 1
            with self._lock:
                self._dirty = True  # the failed payload must retry as a put
            now = time.time()
            if self._failing_since is None:
                self._failing_since = now
            elif now - self._failing_since > self.ttl and \
                    self.on_store_lost is not None:
                cb, self.on_store_lost = self.on_store_lost, None  # once
                try:
                    cb(e)
                except Exception:
                    pass
            return False

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat_now()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "HeartbeatLease":
        if self._thread is None or not self._thread.is_alive():
            self.beat_now()  # registration is SYNCHRONOUS: a caller that
            # checks membership right after start() must see itself
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"paddle-tpu-hb-{self.key}")
            self._thread.start()
        return self

    def stop(self, release: bool = False) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if release:
            try:
                self._kv.delete(self.key)
            except Exception:
                pass


# -- lease monitor -----------------------------------------------------------

class LeaseMonitor:
    """Scan ``hb/<rank>`` leases; poison the gang on a dead one.

    Runs on the coordinator rank or the launcher.  Per scan:

    - a lease older than its ttl → **dead rank** → ``fleet_lease_expired``
      event + ``poison_fn(reason="lease_expired", culprit=rank)``;
    - a FRESH lease whose step stamp lags ``straggler_after`` seconds behind
      the gang's freshest step stamp → **straggler** →
      ``fleet_straggler`` event + gauge (observed, not poisoned — a wedged
      collective is the CommWatchdog's to escalate);
    - a fresh lease whose ``step_dt_ema`` payload (per-step wall time fed
      by :meth:`HeartbeatLease.note_step`) exceeds the gang *median* by
      ``slow_factor`` for ``slow_scans`` consecutive scans → **slow rank**
      → ``fleet_straggler_slow`` event + ``slow_fn(rank, ema, median)``
      (the straggler ladder's detect stage; relative to the median, so a
      uniformly slow gang — big model, cold caches — never flags anyone);
    - gauges: ``fleet_live_ranks``, ``fleet_max_step``.
    """

    def __init__(self, kv, world_size: int, *,
                 ttl: Optional[float] = None,
                 interval: Optional[float] = None,
                 straggler_after: Optional[float] = None,
                 slow_factor: Optional[float] = None,
                 slow_scans: Optional[int] = None,
                 poison_fn: Optional[Callable[..., Any]] = None,
                 slow_fn: Optional[Callable[..., Any]] = None):
        self._kv = _adapt_kv(kv)
        self.world_size = int(world_size)
        self.ttl = float(ttl if ttl is not None
                         else _env_float("PADDLE_TPU_HB_TTL", 10.0))
        self.interval = heartbeat_interval(self.ttl, interval)
        self.straggler_after = float(
            straggler_after if straggler_after is not None
            else _env_float("PADDLE_TPU_STRAGGLER_AFTER", 5.0 * self.ttl))
        self.slow_factor = float(
            slow_factor if slow_factor is not None
            else _env_float("PADDLE_TPU_STRAGGLER_FACTOR", 2.0))
        self.slow_scans = max(1, int(
            slow_scans if slow_scans is not None
            else _env_float("PADDLE_TPU_STRAGGLER_SCANS", 3)))
        self.poison_fn = poison_fn
        self.slow_fn = slow_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._poisoned_ranks: set = set()
        self._straggler_flagged: set = set()
        self._slow_streak: Dict[int, int] = {}
        self._slow_flagged: set = set()
        self.dead_ranks: List[int] = []
        self.stragglers: List[int] = []
        self.slow_ranks: List[int] = []

    def _leases(self) -> Dict[int, dict]:
        out = {}
        for key in self._kv.keys(_HB_PREFIX):
            try:
                rank = int(key[len(_HB_PREFIX):])
            except ValueError:
                continue
            age = self._kv.age(key)
            if age is None:
                continue
            doc = self._kv.get(key) or {}
            doc["_age"] = age
            out[rank] = doc
        return out

    def scan_once(self) -> Dict[str, List[int]]:
        """One pass; returns {"dead": [...], "stragglers": [...],
        "slow": [...]} and emits the corresponding events / poison
        writes."""
        try:
            leases = self._leases()
        except Exception:
            return {"dead": [], "stragglers": [], "slow": []}
        now = time.time()
        dead, stragglers = [], []
        step_stamps = [d.get("step_ts") for d in leases.values()
                       if d.get("step_ts")]
        freshest_step = max(step_stamps) if step_stamps else None
        for rank, doc in sorted(leases.items()):
            ttl = float(doc.get("ttl", self.ttl))
            if lease_expired(doc["_age"], ttl):
                dead.append(rank)
                if rank not in self._poisoned_ranks:
                    self._poisoned_ranks.add(rank)
                    _record_event("fleet_lease_expired", f"rank{rank}",
                                  rank=rank, age_s=round(doc["_age"], 3),
                                  ttl_s=ttl, last_step=doc.get("step"))
                    if self.poison_fn is not None:
                        try:
                            self.poison_fn(reason="lease_expired",
                                           culprit=rank,
                                           detail=f"hb age {doc['_age']:.1f}s"
                                                  f" > ttl {ttl:.1f}s")
                        except Exception:
                            pass
                continue
            # alive: stuck-in-step? fresh heartbeat, stale step stamp
            step_ts = doc.get("step_ts")
            if (freshest_step is not None and step_ts is not None
                    and self.straggler_after > 0
                    and freshest_step - step_ts > self.straggler_after
                    and now - step_ts > self.straggler_after):
                stragglers.append(rank)
                if rank not in self._straggler_flagged:
                    self._straggler_flagged.add(rank)
                    _record_event("fleet_straggler", f"rank{rank}",
                                  rank=rank, step=doc.get("step"),
                                  behind_s=round(freshest_step - step_ts, 3))
            else:
                self._straggler_flagged.discard(rank)
        slow = self._scan_slow(leases, dead)
        self.dead_ranks = dead
        self.stragglers = stragglers
        self.slow_ranks = slow
        _set_gauge("fleet_live_ranks", len(leases) - len(dead))
        _set_gauge("fleet_dead_ranks", len(dead))
        # the job rollup cross-checks its step-skew straggler against
        # these: aggregator.rollup names a straggler from snapshot skew,
        # and straggler_confirmed means the lease monitor agrees
        _set_gauge("fleet_straggler_count", len(stragglers))
        if stragglers:
            _set_gauge("fleet_straggler_rank", stragglers[0])
        _set_gauge("fleet_slow_rank_count", len(slow))
        if slow:
            _set_gauge("fleet_slow_rank", slow[0])
        steps = [d.get("step") or 0 for d in leases.values()]
        if steps:
            _set_gauge("fleet_max_step", max(steps))
        return {"dead": dead, "stragglers": stragglers, "slow": slow}

    def _scan_slow(self, leases: Dict[int, dict],
                   dead: List[int]) -> List[int]:
        """EMA-vs-gang-median slow-rank pass over fresh leases.  Flags a
        rank only after ``slow_scans`` CONSECUTIVE over-factor scans (a
        one-scan spike — host GC, page-cache miss — resets nothing but
        its own streak), un-flags as soon as the rank drops back under
        the factor, and never flags when fewer than 3 ranks publish an
        EMA (no meaningful median)."""
        emas = {r: d.get("step_dt_ema") for r, d in leases.items()
                if r not in dead and isinstance(
                    d.get("step_dt_ema"), (int, float))}
        slow: List[int] = []
        vals = sorted(float(v) for v in emas.values())
        if len(vals) < 3:
            self._slow_streak.clear()
            return slow
        mid = len(vals) // 2
        median = vals[mid] if len(vals) % 2 else \
            0.5 * (vals[mid - 1] + vals[mid])
        for rank in sorted(emas):
            ema = float(emas[rank])
            if median > 0 and ema > self.slow_factor * median:
                self._slow_streak[rank] = self._slow_streak.get(rank, 0) + 1
            else:
                self._slow_streak.pop(rank, None)
                if rank in self._slow_flagged:
                    self._slow_flagged.discard(rank)
                    _record_event("fleet_straggler_recovered", f"rank{rank}",
                                  rank=rank, ema_s=round(ema, 4),
                                  median_s=round(median, 4))
                continue
            if self._slow_streak[rank] < self.slow_scans:
                continue
            slow.append(rank)
            if rank not in self._slow_flagged:
                self._slow_flagged.add(rank)
                _record_event("fleet_straggler_slow", f"rank{rank}",
                              rank=rank, ema_s=round(ema, 4),
                              median_s=round(median, 4),
                              factor=self.slow_factor,
                              scans=self._slow_streak[rank])
                if self.slow_fn is not None:
                    try:
                        self.slow_fn(rank, ema, median)
                    except Exception:
                        pass
        return slow

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.scan_once()

    def start(self) -> "LeaseMonitor":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="paddle-tpu-lease-mon")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


# -- fault domain ------------------------------------------------------------

class FaultDomain:
    """Rank-side (or launcher-side) membership in the fleet fault domain.

    ``store`` is a raw TCPStore-shaped client or any put/touch/age KV.
    ``rank=None`` marks a non-participant observer (the launcher): no
    heartbeat lease is published, but the poison poll (and, with
    ``monitor=True``, the lease monitor) still runs.

    On poison (any epoch-matching ``poison/<epoch>`` key): dump the flight
    recorder, best-effort emergency checkpoint via ``state_provider``, then
    ``os._exit(exit_code)`` — all bounded by ``abort_deadline`` via a
    backstop timer armed BEFORE the dump, so a hang inside the abort path
    itself cannot re-wedge the rank.  ``on_abort`` (tests, launchers)
    replaces the exit."""

    def __init__(self, store, rank: Optional[int], world_size: int, *,
                 job_id: str = "default", epoch: int = 0,
                 hb_interval: Optional[float] = None,
                 hb_ttl: Optional[float] = None,
                 poison_poll: Optional[float] = None,
                 abort_deadline: Optional[float] = None,
                 straggler_after: Optional[float] = None,
                 monitor: Any = "auto",
                 on_abort: Optional[Callable[[dict], None]] = None,
                 state_provider: Optional[Callable[[], dict]] = None,
                 ckpt_root: Optional[str] = None,
                 exit_code: int = FLEET_EXIT_CODE):
        self.rank = rank
        self.world_size = int(world_size)
        self.job_id = job_id
        self.epoch = int(epoch)
        self.exit_code = int(exit_code)
        self.on_abort = on_abort
        self.state_provider = state_provider
        self.ckpt_root = ckpt_root
        self._store = store
        self._prefix = f"fleet/{job_id}/"
        self._kv = _adapt_kv(store, self._prefix)
        self.hb_ttl = float(hb_ttl if hb_ttl is not None
                            else _env_float("PADDLE_TPU_HB_TTL", 10.0))
        self.hb_interval = heartbeat_interval(
            self.hb_ttl,
            hb_interval if hb_interval is not None
            else (_env_float("PADDLE_TPU_HB_INTERVAL", self.hb_ttl / 3.0)
                  if "PADDLE_TPU_HB_INTERVAL" in os.environ else None))
        self.poison_poll = float(
            poison_poll if poison_poll is not None
            else _env_float("PADDLE_TPU_POISON_POLL",
                            max(0.05, min(1.0, self.hb_ttl / 4.0))))
        self.abort_deadline = float(
            abort_deadline if abort_deadline is not None
            else _env_float("PADDLE_TPU_ABORT_DEADLINE", 15.0))
        if monitor == "auto":
            monitor = (rank == 0)
        self.lease: Optional[HeartbeatLease] = None
        if rank is not None:
            self.lease = HeartbeatLease(
                store, f"{self._prefix}{_HB_PREFIX}{rank}",
                ttl=self.hb_ttl, interval=self.hb_interval,
                payload={"rank": rank, "pid": os.getpid(),
                         "host": socket.gethostname(), "epoch": self.epoch},
                on_store_lost=self._on_store_lost)
        self.monitor: Optional[LeaseMonitor] = None
        if monitor:
            self.monitor = LeaseMonitor(
                self._kv, world_size, ttl=self.hb_ttl,
                straggler_after=straggler_after, poison_fn=self.poison,
                slow_fn=self._note_slow_rank)
        self._slow_seq = 0
        self._stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self._abort_lock = threading.Lock()
        self.aborted = False
        self.last_poison: Optional[dict] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FaultDomain":
        if self.lease is not None:
            self.lease.start()
        if self.monitor is not None:
            self.monitor.start()
        if self._poll_thread is None or not self._poll_thread.is_alive():
            self._stop.clear()
            self._poll_thread = threading.Thread(
                target=self._poll_loop, daemon=True,
                name="paddle-tpu-poison-poll")
            self._poll_thread.start()
        set_current(self)
        _record_event("fleet_domain_start", f"rank{self.rank}",
                      rank=self.rank, world=self.world_size,
                      epoch=self.epoch, ttl_s=self.hb_ttl,
                      interval_s=self.hb_interval)
        return self

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        if self.lease is not None:
            self.lease.stop(release=release)
        if self.monitor is not None:
            self.monitor.stop()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=2)
            self._poll_thread = None
        if current() is self:
            set_current(None)

    # -- step stamps -------------------------------------------------------
    def note_step(self, step: int, dt: Optional[float] = None) -> None:
        if self.lease is not None:
            self.lease.note_step(step, dt=dt)

    # -- straggler flag (detect → confirm handoff) -------------------------
    def _note_slow_rank(self, rank: int, ema: float, median: float) -> None:
        """LeaseMonitor slow-rank callback: broadcast the flag through the
        store so the FLAGGED rank (which does not run the monitor) learns
        it must run the confirm/localize micro-probe at its next step
        boundary (:mod:`...health.straggler` polls this key).  Last write
        wins — re-flagging bumps ``seq`` so the probe protocol can tell a
        new episode from a stale one."""
        self._slow_seq += 1
        doc = {"rank": int(rank), "ema_s": float(ema),
               "median_s": float(median), "seq": self._slow_seq,
               "epoch": self.epoch, "ts": time.time()}
        try:
            self._kv.put(f"{_STRAGGLER_PREFIX}flag/{self.epoch}", doc)
        except Exception:
            pass

    def straggler_flag(self) -> Optional[dict]:
        """The current epoch's slow-rank flag doc, or None."""
        try:
            doc = self._kv.get(f"{_STRAGGLER_PREFIX}flag/{self.epoch}")
        except Exception:
            return None
        return doc if isinstance(doc, dict) else None

    def release_rank(self, rank: int) -> None:
        """Drop ``rank``'s heartbeat lease (launcher: a child that exited
        CLEANLY but never stopped its domain must not expire later and
        poison the survivors)."""
        try:
            self._kv.delete(f"{_HB_PREFIX}{int(rank)}")
        except Exception:
            pass

    # -- poison protocol ---------------------------------------------------
    def _poison_key(self, epoch: Optional[int] = None) -> str:
        return f"{_POISON_PREFIX}{self.epoch if epoch is None else epoch}"

    def poison(self, reason: str, culprit: Optional[int] = None,
               detail: str = "", **extra) -> bool:
        """Write this epoch's poison pill (first writer wins).  Returns True
        when OUR pill landed; either way the local abort path will fire on
        the next poll.  ``extra`` fields (JSON-serializable) ride along in
        the pill — the link-slow path uses this to name the degraded
        neighbor pair the relaunch must route around."""
        doc = {"reason": reason, "culprit": culprit, "detail": detail,
               "by": self.rank, "epoch": self.epoch, "ts": time.time(),
               "host": socket.gethostname(), "pid": os.getpid()}
        if extra:
            doc.update(extra)
        try:
            won = self._kv.put_if_absent(self._poison_key(), doc) \
                if hasattr(self._kv, "put_if_absent") else (
                    self._kv.put(self._poison_key(), doc) or True)
        except Exception:
            return False
        if won:
            _record_event("fleet_poison_set", reason, **{
                k: v for k, v in doc.items() if k != "ts"})
        return bool(won)

    def check_poison(self) -> Optional[dict]:
        """This epoch's poison pill, or None."""
        try:
            doc = self._kv.get(self._poison_key())
        except Exception:
            return None
        return doc if isinstance(doc, dict) else None

    def clear_poison(self, epoch: Optional[int] = None) -> None:
        """Administrative: remove a pill (FleetSupervisor hygiene between
        gang launches; normally epoch scoping already isolates them)."""
        try:
            self._kv.delete(self._poison_key(epoch))
        except Exception:
            pass

    # -- gang barrier ------------------------------------------------------
    def gang_barrier(self, timeout: Optional[float] = None) -> None:
        """Pre-step-0 rendezvous of the whole gang with a deadline: a rank
        that never spawns (or died during init) turns into a loud, bounded
        TimeoutError naming the missing ranks instead of a silent hang."""
        if timeout is None:
            timeout = _env_float("PADDLE_TPU_GANG_BARRIER_DEADLINE", 120.0)
        self._store.barrier(f"{self._prefix}gang/{self.epoch}",
                            self.world_size, timeout=timeout, rank=self.rank)
        _record_event("fleet_gang_barrier", f"epoch{self.epoch}",
                      rank=self.rank, world=self.world_size,
                      epoch=self.epoch)

    # -- abort path --------------------------------------------------------
    def poll_once(self) -> Optional[dict]:
        """One poison check (the CommWatchdog loop also calls this, so a
        rank parked inside a watchdog-wrapped wait learns about poison even
        between poll-thread ticks).  Triggers the abort when poisoned."""
        doc = self.check_poison()
        if doc is not None:
            self._abort(doc)
        return doc

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poison_poll):
            if self.poll_once() is not None:
                return

    def _on_store_lost(self, exc: Exception) -> None:
        """Heartbeat writes failed for > ttl: our lease is already expired
        cluster-wide and we cannot see poison either — leave with the same
        bounded abort instead of training split-brained."""
        self._abort({"reason": "store_lost", "culprit": self.rank,
                     "detail": repr(exc), "by": self.rank,
                     "epoch": self.epoch})

    def _abort(self, doc: dict) -> None:
        with self._abort_lock:
            if self.aborted:
                return
            self.aborted = True
            self.last_poison = doc
        hard = self.on_abort is None
        if hard:
            # backstop FIRST: even a hang inside dump/checkpoint below
            # cannot keep this rank alive past the deadline
            threading.Thread(
                target=self._backstop_exit, daemon=True,
                name="paddle-tpu-abort-backstop").start()
        _record_event("fleet_abort", doc.get("reason", "poisoned"),
                      rank=self.rank, culprit=doc.get("culprit"),
                      by=doc.get("by"), epoch=doc.get("epoch"))
        dump = _dump_recorder("fleet_abort", extra={"poison": doc})
        self._emergency_checkpoint(doc, dump)
        if self.monitor is not None:
            self.monitor.stop()
        if not hard:
            try:
                self.on_abort(doc)
            except Exception:
                pass
            return
        sys.stderr.write(
            f"[fleet] rank {self.rank} aborting (epoch {self.epoch}): "
            f"{doc.get('reason')} culprit={doc.get('culprit')} "
            f"by={doc.get('by')} — exit {self.exit_code}\n")
        os._exit(self.exit_code)

    def _backstop_exit(self) -> None:
        time.sleep(self.abort_deadline)
        sys.stderr.write(f"[fleet] abort deadline "
                         f"({self.abort_deadline:.0f}s) hit — forcing exit "
                         f"{self.exit_code}\n")
        os._exit(self.exit_code)

    def _emergency_checkpoint(self, doc: dict, dump: str) -> None:
        """Best-effort, only when a state provider was armed AND the culprit
        is not us (our own state may be the poison)."""
        if self.state_provider is None or not self.ckpt_root:
            return
        if doc.get("culprit") == self.rank and doc.get("reason") in (
                "health_escalation", "watchdog_hang", "sdc_suspect"):
            # sdc_suspect: a chip that silently computes wrong numbers has
            # wrong state by definition — an emergency checkpoint from the
            # suspect would preserve exactly the corruption being evicted
            return
        try:
            from ..checkpoint import save_state_dict
            from ..checkpoint.save_state_dict import _wait_pending

            path = os.path.join(
                self.ckpt_root,
                f"emergency_{int(time.time())}_rank{self.rank}")
            save_state_dict(self.state_provider(), path)
            _wait_pending()
            _record_event("emergency_checkpoint", path,
                          trigger="fleet_abort", saved=True, dump=dump)
        except Exception:
            pass


# -- process-global registry -------------------------------------------------

_current: Optional[FaultDomain] = None


def set_current(domain: Optional[FaultDomain]) -> None:
    global _current
    _current = domain


def current() -> Optional[FaultDomain]:
    return _current


def note_step_current(step: int, dt: Optional[float] = None) -> None:
    """TrainStep hook: stamp step progress (and optionally this step's wall
    time, which feeds the slow-rank EMA) into this process's lease (no-op
    without an active domain — must stay cheap on the hot path)."""
    d = _current
    if d is not None:
        try:
            d.note_step(step, dt=dt)
        except TypeError:
            # rolling upgrade: a domain (or test double) predating the
            # step-time EMA takes only the step number
            d.note_step(step)


def poison_current(reason: str, culprit: Optional[int] = None,
                   detail: str = "") -> bool:
    """Detector hook (CommWatchdog timeout, HealthGuard escalation): poison
    the gang through the active domain, if any."""
    d = _current
    if d is None:
        return False
    if culprit is None:
        culprit = d.rank
    return d.poison(reason, culprit=culprit, detail=detail)


# -- smoke check -------------------------------------------------------------

def smoke_check(deadline: float = 5.0) -> bool:
    """One lease + poison-pill round trip over a throwaway local TCPStore:
    the fast proof (bench detail, dryrun detail) that a gang on this build
    would detect a dead rank and abort in bounded time.  Returns False when
    the layer is disabled (``PADDLE_TPU_FAULT_DOMAIN=0``) or broken."""
    if os.environ.get("PADDLE_TPU_FAULT_DOMAIN", "1") in ("0", "false"):
        return False
    from ..store import TCPStore

    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=1,
                      timeout=deadline * 2)
    aborted: list = []
    try:
        d = FaultDomain(master, 0, 1, hb_interval=0.05, hb_ttl=1.0,
                        poison_poll=0.05, monitor=False,
                        on_abort=aborted.append).start()
        d.note_step(1)
        end = time.time() + deadline
        while master.age(f"fleet/default/{_HB_PREFIX}0") is None and \
                time.time() < end:
            time.sleep(0.02)
        d.poison("smoke_check", culprit=0)
        while not aborted and time.time() < end:
            time.sleep(0.02)
        ok = bool(aborted) and \
            master.age(f"fleet/default/{_HB_PREFIX}0") is not None
        d.stop()
        return ok
    finally:
        master.close()


# -- env wiring --------------------------------------------------------------

def from_env(store=None, **overrides) -> Optional[FaultDomain]:
    """Build a FaultDomain from the launch env contract.  Returns None when
    the fault domain is disabled (``PADDLE_TPU_FAULT_DOMAIN=0``) or no fleet
    store is addressable.  The launcher exports ``PADDLE_TPU_FLEET_STORE``
    (host:port of the job store) and ``PADDLE_TPU_GANG_EPOCH``."""
    if os.environ.get("PADDLE_TPU_FAULT_DOMAIN", "1") in ("0", "false"):
        return None
    addr = os.environ.get("PADDLE_TPU_FLEET_STORE")
    if store is None:
        if not addr:
            return None
        from ..store import TCPStore

        host, port = addr.rsplit(":", 1)
        store = TCPStore(host, int(port), is_master=False,
                         timeout=_env_float("PADDLE_TPU_HB_TTL", 10.0) * 3)
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    epoch = int(os.environ.get("PADDLE_TPU_GANG_EPOCH", "0"))
    job_id = os.environ.get("PADDLE_JOB_ID", "default")
    monitor = overrides.pop("monitor", None)
    if monitor is None:
        who = os.environ.get("PADDLE_TPU_FLEET_MONITOR", "rank0")
        monitor = (rank == 0) if who == "rank0" else False
    return FaultDomain(store, rank, world, job_id=job_id, epoch=epoch,
                       monitor=monitor, **overrides)


def init_from_env(**overrides) -> Optional[FaultDomain]:
    """``init_parallel_env`` hook: build + start + (optionally) barrier.
    Idempotent: an already-current domain is returned as-is."""
    if _current is not None:
        return _current
    d = from_env(**overrides)
    if d is None:
        return None
    d.start()
    if os.environ.get("PADDLE_TPU_GANG_BARRIER", "0") not in ("0", "false") \
            and d.rank is not None and hasattr(d._store, "barrier"):
        d.gang_barrier()
    return d
