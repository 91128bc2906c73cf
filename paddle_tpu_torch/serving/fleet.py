"""Multi-replica serving fleet: lease-routed frontend with journal
fail-over and exactly-once tokens across replica death.

The :class:`~paddle_tpu_torch.serving.engine.ServingEngine` is one process; the
north star's traffic needs N of them behind one front door.  This module
composes three things that already exist in-tree into that fleet:

- **Membership** rides :class:`~paddle_tpu_torch.distributed.fleet.fault_domain.
  HeartbeatLease` on the job's fleet store: every replica publishes
  ``serve/hb/<name>`` with its address, capacity, live queue depth,
  measured ``est_first_token_s`` and fencing *epoch*.  The frontend's
  scan declares death on **lease expiry** (or an epoch bump — a replica
  that died and relaunched between scans), never on a TCP error: a slow
  peer is not a dead peer.
- **Routing** (:class:`.router.Router`) is least-loaded with
  deadline-aware spill; a replica-side ``Overloaded`` refusal spills to
  the next candidate.
- **Durability**: each replica ships every journal segment to the
  launcher-hosted depot (:class:`~paddle_tpu_torch.distributed.checkpoint.
  replicator.SnapshotStore`, serving-journal record family) inside
  :meth:`ServingJournal._flush_locked` — the SAME flush boundary that
  gates token emission, so the depot's view of a replica's ledger is
  always >= what any client was shown.

Exactly-once across replica death, the full argument:

1. flush+ship gates emission — every token a client saw is covered by a
   depot segment;
2. on lease expiry the frontend **fences** the dead incarnation's epoch
   at the depot FIRST (``fence(name, epoch+1)``), so the fold that
   follows reads a high-water mark the zombie can never advance — its
   post-fence flush raises :class:`~paddle_tpu_torch.distributed.checkpoint.
   replicator.FencedEpoch`, the local segment is unwound, and (flush
   gating emission) it never shows another token to anyone;
3. the frontend folds the dead incarnation's journal from the depot and
   re-submits unfinished requests to survivors with the **delivered
   high-water mark primed** — the survivor regenerates deterministically
   (greedy decode) and suppresses everything at-or-below the mark;
4. the :class:`~paddle_tpu_torch.serving.journal.TokenSink` dedups the
   flush→emit window (journaled-but-not-yet-emitted tokens are re-offered
   by the failover fold; emitted-and-journaled ones drop here);
5. deadlines keep aging across the failover: the journal's wall-clock
   ``submit_wall`` backdates the survivor's meter.

Security note (satellite rule shared with ``distributed.rpc``): the lease
payloads and fencing epochs published here are *liveness metadata only* —
no key on the unauthenticated fleet store is ever derived from
``PADDLE_RPC_SECRET`` or any other secret.

Env knobs: ``PADDLE_TPU_SERVE_FLEET_TTL`` (replica lease ttl, default
``PADDLE_TPU_HB_TTL``), ``PADDLE_TPU_SERVE_FLEET_SCAN`` (frontend scan
period, default ttl/3), ``PADDLE_TPU_SERVE_FLEET_STATUS`` (replica status
republish period, default ttl/5), plus the launch env contract
(``PADDLE_TPU_FLEET_STORE``, ``PADDLE_TPU_SNAP_STORE``,
``PADDLE_TPU_SERVE_REPLICA``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..distributed.checkpoint import faults as _faults
from ..distributed.checkpoint.replicator import SnapshotClient, _recv, _send
from ..distributed.fleet.fault_domain import (HeartbeatLease, _adapt_kv,
                                              _env_float, lease_expired)
from ..telemetry import record_event as _event
from ..telemetry import tracing
from ..telemetry.aggregator import start_metrics_pusher
from .admission import Deadline, Overloaded, warming_retry_hint
from .engine import ServingEngine
from .journal import JournalState, ServingJournal
from .metrics import FleetMeter
from .router import ReplicaStatus, Router

__all__ = [
    "FLEET_HB_PREFIX", "LocalKV", "JournalShipper", "fold_depot_journal",
    "adopt_epoch", "EngineReplica", "ReplicaFlags", "ReplicaServer",
    "RemoteReplica", "TokenCollector", "ServingFrontend", "run_replica",
]

FLEET_HB_PREFIX = "serve/hb/"


def fleet_ttl(ttl: Optional[float] = None) -> float:
    if ttl is not None:
        return float(ttl)
    return _env_float("PADDLE_TPU_SERVE_FLEET_TTL",
                      _env_float("PADDLE_TPU_HB_TTL", 10.0))


def _scan_interval(ttl: float) -> float:
    return max(0.05, _env_float("PADDLE_TPU_SERVE_FLEET_SCAN", ttl / 3.0))


def _status_interval(ttl: float) -> float:
    return max(0.05, _env_float("PADDLE_TPU_SERVE_FLEET_STATUS", ttl / 5.0))


def _serve_tier() -> str:
    """This replica's serving tier (``PADDLE_TPU_SERVE_TIER``): the
    launcher tags dedicated prefill children ``prefill``; everything else
    is ``decode``.  Published on the lease so the router can land
    TTFT-bound work on prefill capacity (disaggregated serving)."""
    return os.environ.get("PADDLE_TPU_SERVE_TIER", "decode") or "decode"


# -- in-memory KV (single-process fleets: bench, unit tests) -----------------

class LocalKV:
    """A put/touch/age/keys/delete KV in process memory, with an
    injectable clock — the fake-clock lease-expiry tests and the bench's
    in-process fleet use this where a real deployment uses the launcher's
    ``TCPStore``."""

    def __init__(self, now: Callable[[], float] = time.monotonic):
        self._now = now
        self._lock = threading.Lock()
        self._vals: Dict[str, Any] = {}
        self._ts: Dict[str, float] = {}

    def put(self, key: str, value) -> None:
        with self._lock:
            self._vals[key] = json.loads(json.dumps(value))
            self._ts[key] = self._now()

    def get(self, key: str):
        with self._lock:
            return self._vals.get(key)

    def touch(self, key: str) -> None:
        with self._lock:
            if key in self._ts:
                self._ts[key] = self._now()

    def delete(self, key: str) -> None:
        with self._lock:
            self._vals.pop(key, None)
            self._ts.pop(key, None)

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._vals if k.startswith(prefix))

    def age(self, key: str) -> Optional[float]:
        with self._lock:
            t = self._ts.get(key)
            return None if t is None else max(0.0, self._now() - t)


# -- depot plumbing ----------------------------------------------------------

class JournalShipper:
    """``ship(seq, data)`` callable for :class:`ServingJournal`: one depot
    put per flushed segment, keyed by this incarnation's fencing epoch.
    :class:`FencedEpoch` propagates untouched — the journal unwinds the
    local segment and the zombie's step loop absorbs it as a permanent
    storage failure (no further emission, escalation after
    ``PADDLE_TPU_SERVE_MAX_STEP_FAILURES``)."""

    def __init__(self, depot: SnapshotClient, replica: str, epoch: int):
        self.depot = depot
        self.replica = str(replica)
        self.epoch = int(epoch)

    def __call__(self, seq: int, data: bytes) -> None:
        self.depot.journal_put(self.replica, self.epoch, int(seq), data)
        # black-box happens-before anchor: blackbox.merge orders this
        # ship BEFORE any fold of (replica, epoch) that consumed this seq
        _event("fleet_ship", self.replica, epoch=self.epoch, seq=int(seq),
               nbytes=len(data))


def adopt_epoch(depot: SnapshotClient, replica: str) -> int:
    """Start-of-life epoch for a replica incarnation: fence the previous
    incarnation (if any) and adopt the bumped epoch.  This makes a fast
    Supervisor relaunch safe even when the frontend never saw the death —
    the new incarnation's segments can never collide with (or be shadowed
    by) the old one's, and the old zombie is refused from here on."""
    epoch = depot.fence(replica, depot.fence_epoch(replica) + 1)
    _event("fleet_fence", str(replica), epoch=int(epoch))
    return epoch


def fold_depot_journal(depot: SnapshotClient, replica: str,
                       epoch: int) -> JournalState:
    """Fold one incarnation's depot-side journal into a
    :class:`JournalState`.  Stops at the first seq discontinuity (a
    pruned or torn segment): an EARLIER high-water mark is safe — the
    sink dedups and regeneration is deterministic."""
    st = JournalState()
    expect = 0
    for seq, data in sorted(depot.journal_fetch(replica, epoch)):
        if seq != expect:
            st.truncated = True
            break
        expect += 1
        try:
            records = json.loads(data)
        except ValueError:
            st.truncated = True
            break
        for rec in records:
            ServingJournal._fold(st, rec)
        st.segments_read += 1
    # high_seq names the last segment this fold consumed: blackbox.merge
    # draws ship(seq<=high_seq) -> this fold happens-before edges from it
    _event("fleet_fold", str(replica), epoch=int(epoch),
           high_seq=st.segments_read - 1, truncated=st.truncated)
    return st


# -- framed-TCP plumbing (reuses the replicator protocol) --------------------

class _FramedServer(threading.Thread):
    """Accept loop + per-connection ``_cmd_*`` dispatch over the
    replicator's framing — the same shape as :class:`SnapshotStore`, for
    the replica command server and the frontend token collector."""

    def __init__(self, name: str, host: str = "127.0.0.1", port: int = 0):
        super().__init__(daemon=True, name=name)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host = host if host not in ("", "0.0.0.0") else "127.0.0.1"
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                head, payload = _recv(conn)
                try:
                    resp, out = getattr(self, "_cmd_" + head["cmd"])(
                        head, payload)
                except Exception as e:
                    resp, out = {"error": f"{type(e).__name__}: {e}"}, b""
                _send(conn, resp, out)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


class _TokenPusher:
    """Replica-side ``on_token``: one acked frame per token to the
    frontend's :class:`TokenCollector`.  Transport failure raises
    ``OSError`` — the engine's ``_flush_delivery`` keeps the tokens
    pending and the step loop retries (the collector's sink dedups the
    replays)."""

    def __init__(self, address: str, timeout: Optional[float] = None):
        self._client = SnapshotClient.from_address(address, timeout=timeout)

    def __call__(self, rid: int, idx: int, tok: int) -> None:
        self._client._call({"cmd": "token", "rid": int(rid),
                            "idx": int(idx), "tok": int(tok)})

    def close(self) -> None:
        self._client.close()


class TokenCollector(_FramedServer):
    """Frontend-side token ingest: replicas push ``(rid, idx, tok)``
    frames here; each is applied to the frontend's sink (which dedups)
    before the ack, so a replica's emission ordering is preserved
    end-to-end."""

    def __init__(self, frontend: "ServingFrontend",
                 host: str = "127.0.0.1", port: int = 0):
        self._frontend = frontend
        super().__init__("paddle-tpu-token-collector", host, port)

    def _cmd_token(self, head, payload):
        self._frontend.emit(int(head["rid"]), int(head["idx"]),
                            int(head["tok"]))
        return {"ok": True}, b""

    def _cmd_ping(self, head, payload):
        return {"ok": True}, b""


# -- replica (both in-process and subprocess shapes) -------------------------

def _engine_status(engine: ServingEngine) -> dict:
    # a rid whose final tokens are still awaiting _flush_delivery must not
    # be reported finished: the frontend's wait_all would unblock on this
    # status before the emission reaches the sink (the next poll picks the
    # rid up once the flush lands)
    pending = {rid for rid, _i, _t in list(engine._pending_delivery)}
    prefix = getattr(engine, "prefix", None)
    return {"queue_depth": len(engine._queue),
            "active": len(engine._active),
            "est_first_token_s": engine.meter.est_first_token_s(),
            "finished": sorted(r for r in engine._results
                               if r not in pending),
            "shed": {int(r): v for r, v in engine.shed.items()},
            "tier": _serve_tier(),
            "prefix_hit_rate": (None if prefix is None
                                else prefix.hit_rate()),
            "summary": engine.meter.summary()}


def _decode_probe(scope: str, iters: int = 3) -> float:
    """Out-of-band decode-speed micro-probe: best-of-``iters`` timing of a
    fixed-size memory touch, routed through the ``slow_serve`` chaos seam
    at ``<scope>/probe`` so an injected replica slowdown shows up here the
    same way it shows up in the token stream.  The frontend compares a
    degraded replica's probe against a healthy reference to decide
    re-admission — an absolute measurement would drown in host noise."""
    buf = bytes(1 << 20)
    best: Optional[float] = None
    for _ in range(max(1, int(iters))):
        t0 = time.perf_counter()
        _faults.fire("slow_serve", f"{scope}/probe")
        bytearray(buf)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return float(best)


class ReplicaFlags:
    """Replica-local lifecycle flags shared between the command server
    (which flips them: ``retire`` sets :attr:`draining`) and the status
    loop (which publishes them onto the lease) — the lease payload is how
    EVERY frontend learns to route-exclude a draining replica, not just
    the one that asked for the drain.  ``degraded`` works the same way
    for the latency-outlier ejection: the frontend that detected the
    outlier flips it, the lease publishes it fleet-wide."""

    def __init__(self):
        self.draining = False
        self.degraded = False


class _StatusLoop(threading.Thread):
    """Republish live load + lifecycle state onto the replica's lease
    payload every ``PADDLE_TPU_SERVE_FLEET_STATUS`` seconds — the router
    reads these numbers, so staleness here is routing error, not
    correctness error.  ``warming`` flips false on the engine's first
    completed step; ``draining`` mirrors :class:`ReplicaFlags`."""

    def __init__(self, lease: HeartbeatLease, engine: ServingEngine,
                 interval: float, flags: Optional[ReplicaFlags] = None):
        super().__init__(daemon=True, name="paddle-tpu-serve-status")
        self._lease, self._engine = lease, engine
        self._interval = interval
        self._flags = flags
        self._stop = threading.Event()

    def publish_once(self) -> None:
        st = _engine_status(self._engine)
        ema = self._engine.meter.tpot_ema_s
        self._lease.update_payload(
            queue_depth=st["queue_depth"], active=st["active"],
            est_first_token_s=st["est_first_token_s"],
            tpot_ema_ms=None if ema is None else ema * 1e3,
            tier=st["tier"], prefix_hit_rate=st["prefix_hit_rate"],
            warming=self._engine.first_step_wall is None,
            draining=bool(self._flags.draining) if self._flags else False,
            degraded=bool(self._flags.degraded) if self._flags else False)

    def run(self) -> None:
        while not self._stop.wait(self._interval):
            self.publish_once()

    def stop(self) -> None:
        self._stop.set()


class EngineReplica:
    """In-process replica: a :class:`ServingEngine` + heartbeat lease +
    serve thread, driven by direct method calls.  The unit-test and bench
    vehicle; production replicas run :func:`run_replica` in their own
    process behind a :class:`ReplicaServer`."""

    def __init__(self, name: str, model, *, store, depot: SnapshotClient,
                 journal_root: str, on_token=None,
                 ttl: Optional[float] = None, start_lease: bool = True,
                 engine_kw: Optional[dict] = None):
        self.name = str(name)
        self.depot = depot
        self.epoch = adopt_epoch(depot, self.name)
        self.ttl = fleet_ttl(ttl)
        jroot = os.path.join(str(journal_root), self.name, f"e{self.epoch}")
        self.engine = ServingEngine(
            model, journal=jroot,
            journal_ship=JournalShipper(depot, self.name, self.epoch),
            on_token=on_token, **(engine_kw or {}))
        # per-replica chaos scope: in-process replicas share the global
        # fault table, so a "slow_serve" spec targets ONE replica by path
        self.engine.fault_scope = self.name
        self._start_lease = start_lease
        self.flags = ReplicaFlags()
        self.lease = HeartbeatLease(
            store, FLEET_HB_PREFIX + self.name, ttl=self.ttl,
            payload={"name": self.name, "address": "inproc",
                     "capacity": self.engine.admission.max_queue,
                     "epoch": self.epoch, "pid": os.getpid(),
                     "tier": _serve_tier(),
                     "warming": True, "draining": False})
        self._status = _StatusLoop(self.lease, self.engine,
                                   _status_interval(self.ttl),
                                   flags=self.flags)
        self._thread: Optional[threading.Thread] = None
        self.outputs: Dict[int, Any] = {}
        self.error: Optional[BaseException] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "EngineReplica":
        if self._start_lease:
            self.lease.start()
            self._status.start()

        def _serve():
            try:
                self.outputs = self.engine.serve_forever()
            except BaseException as e:   # crash simulation / real wedge
                self.error = e
        self._thread = threading.Thread(target=_serve, daemon=True,
                                        name=f"serve-{self.name}")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Clean shutdown: drain to idle, release the lease."""
        self.engine.stop()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._status.stop()
        self.lease.stop(release=True)

    def die(self) -> None:
        """Crash simulation: heartbeats stop but the lease is NOT
        released (it must expire), and the engine is left as-is — a still
        -running engine becomes the zombie whose post-fence flushes the
        depot refuses."""
        self._status.stop()
        self.lease.stop(release=False)

    # -- frontend handle surface -------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None, *,
               deadline: Optional[Deadline] = None,
               rid: Optional[int] = None,
               delivered_tokens: Optional[List[int]] = None,
               age_s: float = 0.0,
               trace_id: Optional[str] = None) -> int:
        return self.engine.submit(prompt, max_new_tokens, eos_token_id,
                                  deadline=deadline, rid=rid,
                                  delivered_tokens=delivered_tokens,
                                  age_s=age_s, trace_id=trace_id)

    def status(self) -> dict:
        return _engine_status(self.engine)

    def drain(self) -> List[dict]:
        return self.engine.handback_queued()

    def retire(self) -> List[dict]:
        """Autoscale scale-in hook: mark DRAINING on the lease (the next
        status beat publishes it fleet-wide) and hand back queued work."""
        self.flags.draining = True
        if self._start_lease:
            self._status.publish_once()
        return self.engine.handback_queued()

    def unretire(self) -> None:
        self.flags.draining = False

    def probe(self) -> float:
        return _decode_probe(self.name)

    def degrade(self) -> None:
        """Latency-outlier ejection: mark DEGRADED on the lease so every
        frontend route-excludes this replica (active work keeps running;
        queued work is the ejecting frontend's to re-home)."""
        self.flags.degraded = True
        if self._start_lease:
            self._status.publish_once()

    def undegrade(self) -> None:
        self.flags.degraded = False
        if self._start_lease:
            self._status.publish_once()

    def close(self) -> None:
        pass


class ReplicaServer(_FramedServer):
    """Subprocess replica's command endpoint (submit/status/drain/stop/
    ping) over the replicator framing.  Refusals are marshalled as data
    (``refused`` key), never as the ``error`` key — the frontend must
    tell an ``Overloaded`` spill from a broken replica."""

    def __init__(self, engine: ServingEngine, name: str,
                 host: str = "127.0.0.1", port: int = 0,
                 flags: Optional[ReplicaFlags] = None,
                 on_retire: Optional[Callable[[], None]] = None):
        self.engine = engine
        self.replica_name = name
        self.flags = flags if flags is not None else ReplicaFlags()
        self._on_retire = on_retire
        super().__init__(f"paddle-tpu-replica-{name}", host, port)

    def _cmd_submit(self, head, payload):
        try:
            rid = self.engine.submit(
                head["prompt"], int(head["max_new_tokens"]),
                head.get("eos_token_id"),
                deadline=Deadline.from_doc(head.get("deadline")),
                rid=head.get("rid"),
                delivered_tokens=head.get("delivered_tokens"),
                age_s=float(head.get("age_s", 0.0)),
                trace_id=head.get("trace_id"))
        except Overloaded as e:
            return {"refused": "overloaded", "msg": str(e),
                    "retry_after_s": e.retry_after_s,
                    "reason": e.reason}, b""
        except (ValueError, TypeError) as e:
            return {"refused": "value", "msg": str(e)}, b""
        return {"ok": True, "rid": rid}, b""

    def _cmd_status(self, head, payload):
        return dict(_engine_status(self.engine), ok=True,
                    warming=self.engine.first_step_wall is None,
                    draining=bool(self.flags.draining),
                    degraded=bool(self.flags.degraded)), b""

    def _cmd_drain(self, head, payload):
        return {"ok": True, "handback": self.engine.handback_queued()}, b""

    def _cmd_retire(self, head, payload):
        # scale-in step 1: flip DRAINING (published fleet-wide on the next
        # status beat, so every frontend route-excludes us) and hand back
        # queued-but-unstarted work for the caller to re-home.  The
        # replica keeps serving its ACTIVE requests until ``stop``.
        self.flags.draining = True
        if self._on_retire is not None:
            self._on_retire()
        return {"ok": True, "name": self.replica_name,
                "handback": self.engine.handback_queued()}, b""

    def _cmd_unretire(self, head, payload):
        # aborted scale-in (the handed-back work found no other home):
        # the replica goes back to taking traffic
        self.flags.draining = False
        return {"ok": True}, b""

    def _cmd_probe(self, head, payload):
        return {"ok": True,
                "probe_s": _decode_probe(self.replica_name)}, b""

    def _cmd_degrade(self, head, payload):
        self.flags.degraded = True
        if self._on_retire is not None:   # same fast-publish hook: the
            self._on_retire()             # lease must show DEGRADED now
        return {"ok": True}, b""

    def _cmd_undegrade(self, head, payload):
        self.flags.degraded = False
        if self._on_retire is not None:
            self._on_retire()
        return {"ok": True}, b""

    def _cmd_stop(self, head, payload):
        self.engine.stop()
        return {"ok": True}, b""

    def _cmd_ping(self, head, payload):
        return {"ok": True, "name": self.replica_name}, b""


class RemoteReplica:
    """Frontend-side handle for a subprocess replica, same duck-typed
    surface as :class:`EngineReplica` (submit/status/drain/close)."""

    def __init__(self, name: str, address: str,
                 timeout: Optional[float] = None):
        self.name = str(name)
        self.address = str(address)
        self._client = SnapshotClient.from_address(address, timeout=timeout)

    def submit(self, prompt, max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None, *,
               deadline: Optional[Deadline] = None,
               rid: Optional[int] = None,
               delivered_tokens: Optional[List[int]] = None,
               age_s: float = 0.0,
               trace_id: Optional[str] = None) -> int:
        resp, _ = self._client._call({
            "cmd": "submit", "prompt": [int(x) for x in prompt],
            "max_new_tokens": int(max_new_tokens),
            "eos_token_id": (None if eos_token_id is None
                             else int(eos_token_id)),
            "deadline": None if deadline is None else deadline.to_doc(),
            "rid": rid,
            "delivered_tokens": (None if not delivered_tokens else
                                 [int(t) for t in delivered_tokens]),
            "age_s": float(age_s),
            "trace_id": None if trace_id is None else str(trace_id)})
        if resp.get("ok"):
            return int(resp["rid"])
        if resp.get("refused") == "overloaded":
            raise Overloaded(resp.get("msg", "replica overloaded"),
                             retry_after_s=resp.get("retry_after_s"),
                             reason=resp.get("reason", "queue_full"))
        raise ValueError(resp.get("msg", "replica refused the request"))

    def status(self) -> dict:
        resp, _ = self._client._call({"cmd": "status"})
        return resp

    def drain(self) -> List[dict]:
        resp, _ = self._client._call({"cmd": "drain"})
        return list(resp.get("handback", []))

    def retire(self) -> List[dict]:
        resp, _ = self._client._call({"cmd": "retire"})
        return list(resp.get("handback", []))

    def unretire(self) -> None:
        self._client._call({"cmd": "unretire"})

    def probe(self) -> float:
        resp, _ = self._client._call({"cmd": "probe"})
        return float(resp.get("probe_s", 0.0))

    def degrade(self) -> None:
        self._client._call({"cmd": "degrade"})

    def undegrade(self) -> None:
        self._client._call({"cmd": "undegrade"})

    def stop_replica(self) -> None:
        self._client._call({"cmd": "stop"})

    def ping(self) -> bool:
        try:
            resp, _ = self._client._call({"cmd": "ping"})
            return bool(resp.get("ok"))
        except OSError:
            return False

    def close(self) -> None:
        self._client.close()


def run_replica(model, name: Optional[str] = None, *,
                store=None, store_addr: Optional[str] = None,
                depot_addr: Optional[str] = None,
                collector_addr: Optional[str] = None,
                journal_root: str, engine_kw: Optional[dict] = None,
                ttl: Optional[float] = None,
                host: str = "127.0.0.1") -> Dict[int, Any]:
    """Serve as one fleet replica until a frontend sends ``stop`` (clean
    exit releases the lease) or the process dies (lease expires and the
    frontend fails the work over).  The blocking entry a replica
    subprocess calls after building its model; the launcher exports the
    env contract (``PADDLE_TPU_FLEET_STORE``, ``PADDLE_TPU_SNAP_STORE``,
    ``PADDLE_TPU_SERVE_REPLICA``) that fills the defaults."""
    name = name or os.environ.get("PADDLE_TPU_SERVE_REPLICA") \
        or f"replica{os.getpid()}"
    if store is None:
        addr = store_addr or os.environ.get("PADDLE_TPU_FLEET_STORE")
        if not addr:
            raise RuntimeError("run_replica needs a fleet store "
                               "(store=, store_addr=, or "
                               "PADDLE_TPU_FLEET_STORE)")
        from ..distributed.store import TCPStore

        h, p = addr.rsplit(":", 1)
        store = TCPStore(h, int(p), is_master=False,
                         timeout=fleet_ttl(ttl) * 3)
    depot_addr = depot_addr or os.environ.get("PADDLE_TPU_SNAP_STORE")
    if not depot_addr:
        raise RuntimeError("run_replica needs the journal depot "
                           "(depot_addr= or PADDLE_TPU_SNAP_STORE)")
    depot = SnapshotClient.from_address(depot_addr)
    epoch = adopt_epoch(depot, name)
    # per-epoch journal dir: a relaunched incarnation starts a FRESH local
    # ledger (its predecessor's open work is the frontend's to fail over),
    # and its depot segments are keyed under the new epoch
    jroot = os.path.join(str(journal_root), name, f"e{epoch}")
    pusher = _TokenPusher(collector_addr) if collector_addr else None
    engine = ServingEngine(model, journal=jroot,
                           journal_ship=JournalShipper(depot, name, epoch),
                           on_token=pusher, **(engine_kw or {}))
    engine.fault_scope = name
    flags = ReplicaFlags()
    server = ReplicaServer(engine, name, host=host, flags=flags)
    t = fleet_ttl(ttl)
    lease = HeartbeatLease(
        store, FLEET_HB_PREFIX + name, ttl=t,
        payload={"name": name, "address": server.address,
                 "capacity": engine.admission.max_queue,
                 "epoch": epoch, "pid": os.getpid(),
                 "tier": _serve_tier(),
                 "warming": True, "draining": False})
    status = _StatusLoop(lease, engine, _status_interval(t), flags=flags)
    # a retire must hit the lease NOW, not a status beat later: the
    # faster every frontend sees DRAINING, the smaller the window in
    # which new work lands on a replica that is about to stop
    server._on_retire = status.publish_once
    lease.start()
    status.start()
    # push StepMeter/SLOMeter snapshots to the launcher's depot and spill
    # the flight-recorder ring to the epoch dir on the same cadence — a
    # SIGKILL'd replica still leaves its spans for blackbox.merge
    metrics = start_metrics_pusher(depot, engine, src=name)
    _event("serve_replica_up", name, epoch=epoch, address=server.address)
    clean = False
    try:
        outs = engine.serve_forever()
        clean = True
        return outs
    finally:
        status.stop()
        metrics.stop(final_push=clean)
        if clean and os.environ.get("PADDLE_TPU_EPOCH_DIR"):
            try:
                from ..telemetry import dump_flight_recorder
                dump_flight_recorder(reason=f"replica_{name}_stop")
            except Exception:
                pass
        # only a CLEAN exit releases the lease; a crash/wedge must leave
        # it to expire so the frontend fences and fails the work over
        lease.stop(release=clean)
        server.close()
        if pusher is not None:
            pusher.close()


# -- the frontend ------------------------------------------------------------

class ServingFrontend:
    """Client-facing submit across N replicas with journal fail-over.

    ``store`` is the fleet store (any KV :func:`_adapt_kv` accepts),
    ``depot`` a :class:`SnapshotClient` at the launcher's journal depot,
    ``sink`` the exactly-once client channel (a
    :class:`~paddle_tpu_torch.serving.journal.TokenSink` or any callable).
    Handles for in-process replicas are attached explicitly
    (:meth:`attach`); subprocess replicas are auto-attached from their
    lease address on scan (``auto_attach=True``)."""

    def __init__(self, store, depot: SnapshotClient, sink=None, *,
                 router: Optional[Router] = None,
                 ttl: Optional[float] = None, auto_attach: bool = True,
                 wall: Callable[[], float] = time.time):
        self._kv = _adapt_kv(store)
        self.depot = depot
        self.sink = sink
        self.router = router or Router()
        self.ttl = fleet_ttl(ttl)
        self.auto_attach = auto_attach
        self._wall = wall
        self._lock = threading.RLock()
        self.handles: Dict[str, Any] = {}
        self.requests: Dict[int, dict] = {}     # rid -> descriptor
        self.assignments: Dict[int, str] = {}   # rid -> replica name
        self.finished: Dict[int, List[int]] = {}
        self.shed: Dict[int, str] = {}
        self.first_token_wall: Dict[int, float] = {}
        self.failovers = 0
        self.replayed_requests = 0
        self._next_rid = 0
        self._epochs: Dict[str, int] = {}       # last epoch routed to
        self._fenced: Dict[str, int] = {}       # name -> last fenced epoch
        self._draining: Set[str] = set()
        # latency-outlier ejection (degraded-hardware defense): a replica
        # whose published EWMA TPOT exceeds the fleet median by the
        # straggler factor for N consecutive scans is marked DEGRADED and
        # route-excluded like DRAINING; re-admitted after a clean probe
        self._degraded: Set[str] = set()
        self._tpot_streak: Dict[str, int] = {}
        self._degrade_factor = max(
            1.0, _env_float("PADDLE_TPU_STRAGGLER_FACTOR", 2.0))
        self._degrade_scans = max(
            1, int(_env_float("PADDLE_TPU_STRAGGLER_SCANS", 3)))
        self._orphans: List[Tuple[int, dict, List[int]]] = []
        self.meter = FleetMeter()
        self._scan_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- membership --------------------------------------------------------
    def attach(self, handle) -> None:
        with self._lock:
            self.handles[handle.name] = handle

    def detach(self, name: str) -> None:
        with self._lock:
            h = self.handles.pop(name, None)
        if h is not None:
            try:
                h.close()
            except Exception:
                pass

    def _scan(self) -> Dict[str, Tuple[ReplicaStatus, float, dict]]:
        out: Dict[str, Tuple[ReplicaStatus, float, dict]] = {}
        for key in self._kv.keys(FLEET_HB_PREFIX):
            name = key[len(FLEET_HB_PREFIX):]
            if not name:
                continue
            age = self._kv.age(key)
            if age is None:
                continue
            doc = self._kv.get(key) or {}
            st = ReplicaStatus.from_doc(name, doc)
            st.draining = st.draining or name in self._draining
            st.degraded = st.degraded or name in self._degraded
            st.extra["prefix_hit_rate"] = doc.get("prefix_hit_rate")
            out[name] = (st, age, doc)
        return out

    def _routable(self, exclude: Set[str] = frozenset()
                  ) -> List[ReplicaStatus]:
        out = []
        for name, (st, age, doc) in self._scan().items():
            if name in exclude or name not in self.handles:
                continue
            if self._fenced.get(name, -1) >= st.epoch:
                continue   # every epoch we've seen of it is fenced
            if lease_expired(age, float(doc.get("ttl", self.ttl))):
                continue
            out.append(st)
        self.meter.set_live_replicas(len(out))
        tiers: Dict[str, List[float]] = {}
        rates: List[float] = []
        for st in out:
            self.meter.set_replica_queue_depth(st.name, st.queue_depth)
            tiers.setdefault(st.tier, []).append(st.load)
            r = st.extra.get("prefix_hit_rate")
            if isinstance(r, (int, float)):
                rates.append(float(r))
        for tier, loads in sorted(tiers.items()):
            self.meter.set_tier_occupancy(tier, sum(loads) / len(loads))
        self.meter.set_prefix_hit_rate(
            sum(rates) / len(rates) if rates else None)
        return out

    def live_replicas(self) -> List[str]:
        return sorted(st.name for st in self._routable())

    # -- client surface ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None, *,
               deadline: Optional[Deadline] = None,
               rid: Optional[int] = None) -> int:
        if deadline is not None and not isinstance(deadline, Deadline):
            raise TypeError("deadline must be a serving.Deadline")
        with self._lock:
            if rid is None:
                rid = self._next_rid
            rid = int(rid)
            self._next_rid = max(self._next_rid, rid + 1)
            if rid in self.requests:
                raise ValueError(f"rid {rid} already known to the fleet")
            desc = {"prompt": [int(x) for x in prompt],
                    "max_new_tokens": int(max_new_tokens),
                    "eos_token_id": (None if eos_token_id is None
                                     else int(eos_token_id)),
                    "deadline": (None if deadline is None
                                 else deadline.to_doc()),
                    "submit_wall": self._wall(),
                    # one trace per client request, minted HERE: the same
                    # id rides the route, the replica's journal, any
                    # failover replay, and the merged black box
                    "trace_id": tracing.mint()}
            self.requests[rid] = desc
        try:
            self._route_submit(desc, rid=rid, delivered=None, age_s=0.0)
        except (Overloaded, ValueError):
            with self._lock:
                self.requests.pop(rid, None)
            raise
        return rid

    def emit(self, rid: int, idx: int, tok: int) -> None:
        """Deliver one token to the client channel (the sink dedups); the
        token collector, the failover fold, and in-process replicas'
        ``on_token`` all land here."""
        with self._lock:
            if self.sink is not None:
                self.sink(rid, idx, tok)
            if idx == 0:
                self.first_token_wall.setdefault(rid, self._wall())

    def _route_submit(self, desc: dict, *, rid: int,
                      delivered: Optional[List[int]], age_s: float,
                      exclude: Set[str] = frozenset()) -> str:
        deadline = Deadline.from_doc(desc.get("deadline"))
        trace_id = desc.get("trace_id")
        # TTFT-bound work PREFERS the dedicated prefill tier when one
        # exists (the router falls back to the whole candidate set when it
        # does not — a homogeneous fleet routes exactly as before)
        tier = "prefill" if (deadline is not None
                             and deadline.ttft_s is not None) else None
        order = self.router.order(self._routable(exclude), deadline,
                                  age_s=age_s, tier=tier,
                                  trace_id=trace_id)
        if not order:
            raise Overloaded("no live serving replicas",
                             reason="no_replicas")
        last: Optional[Overloaded] = None
        for st in order:
            h = self.handles.get(st.name)
            if h is None:
                continue
            try:
                h.submit(desc["prompt"], desc["max_new_tokens"],
                         desc["eos_token_id"], deadline=deadline, rid=rid,
                         delivered_tokens=delivered, age_s=age_s,
                         trace_id=trace_id)
            except Overloaded as e:
                last = e          # replica-side refusal: spill onward
                continue
            except (OSError, ConnectionError) as e:
                # transport error is NOT death (the lease decides death)
                # but this replica can't take the request right now
                last = Overloaded(f"replica {st.name} unreachable: {e}",
                                  reason="replica_unreachable")
                continue
            with self._lock:
                self.assignments[rid] = st.name
            _event("serve_route", st.name, rid=int(rid), trace=trace_id,
                   replay=delivered is not None)
            return st.name
        err = last if last is not None else \
            Overloaded("all replicas refused", reason="queue_full")
        # capacity already warming up (a scale-out in flight) caps the
        # retry hint: clients should retry into the new replica, not wait
        # out the current fleet's drain-rate-only estimate
        warming = sum(1 for st in order if st.warming)
        if warming:
            err.retry_after_s = warming_retry_hint(err.retry_after_s,
                                                   warming)
        raise err

    # -- death detection / failover ----------------------------------------
    def scan_once(self) -> List[str]:
        """One membership pass: fence+fold expired leases, catch silent
        relaunches (epoch bumped under a fresh lease), auto-attach new
        replicas, retry orphaned re-submissions.  Returns the replica
        names failed over in this pass."""
        failed: List[str] = []
        snap = self._scan()
        for name, (st, age, doc) in sorted(snap.items()):
            expired = lease_expired(age, float(doc.get("ttl", self.ttl)))
            prev = self._epochs.get(name)
            if expired:
                if self._fenced.get(name, -1) < st.epoch:
                    self.failover(name, st.epoch)
                    failed.append(name)
                continue
            if prev is not None and st.epoch > prev:
                # died and relaunched between scans: the old incarnation
                # never showed an expired lease, but its epoch is gone
                self.failover(name, prev)
                failed.append(name)
            self._epochs[name] = st.epoch
            if self.auto_attach and name not in self.handles and \
                    ":" in str(st.address) and \
                    self._fenced.get(name, -1) < st.epoch:
                try:
                    self.attach(RemoteReplica(name, st.address))
                except (OSError, ValueError):
                    pass
        self._check_degraded(snap)
        self._retry_orphans()
        return failed

    # -- latency-outlier ejection (degraded-hardware defense) --------------
    def _check_degraded(self, snap) -> None:
        """One ejection/re-admission pass over the scan snapshot: compare
        each live replica's published EWMA TPOT against the fleet median
        (median-relative, so a uniformly slow fleet never ejects anyone),
        eject after N consecutive outlier scans, and probe already-ejected
        replicas for re-admission."""
        live = {name for name, (st, age, doc) in snap.items()
                if not lease_expired(age, float(doc.get("ttl", self.ttl)))}
        for gone in list(self._degraded - live):
            self._degraded.discard(gone)    # dead: failover owns it now
        for gone in list(set(self._tpot_streak) - live):
            self._tpot_streak.pop(gone, None)
        emas: Dict[str, float] = {}
        for name in live:
            st, _age, _doc = snap[name]
            if st.draining or name in self._degraded:
                continue
            if isinstance(st.tpot_ema_ms, (int, float)):
                emas[name] = float(st.tpot_ema_ms)
        for name in list(self._degraded & live):
            self._try_readmit(name, emas)
        if len(emas) < 3:
            # no meaningful median from fewer than three measurements —
            # never eject on a two-horse race
            self._tpot_streak.clear()
            return
        vals = sorted(emas.values())
        median = vals[len(vals) // 2]
        for name, ema in sorted(emas.items()):
            if median > 0 and ema > self._degrade_factor * median:
                self._tpot_streak[name] = self._tpot_streak.get(name, 0) + 1
                if self._tpot_streak[name] >= self._degrade_scans:
                    self._tpot_streak.pop(name, None)
                    self.eject_degraded(name, tpot_ema_ms=ema,
                                        median_ms=median)
            else:
                self._tpot_streak.pop(name, None)

    def eject_degraded(self, name: str, *,
                       tpot_ema_ms: Optional[float] = None,
                       median_ms: Optional[float] = None) -> int:
        """Mark ``name`` DEGRADED (locally at once, on its lease via the
        replica flag so every frontend sees it) and re-home its
        queued-but-unstarted work exactly like a drain; active requests
        keep running there.  Returns the number re-homed."""
        with self._lock:
            self._degraded.add(name)
            h = self.handles.get(name)
        if h is not None:
            try:
                h.degrade()
            except (OSError, ConnectionError, AttributeError):
                pass   # local route-exclusion still stands
        moved = self._rehome_queued(name, h)
        self.meter.degrade(name, tpot_ema_ms=tpot_ema_ms,
                           median_ms=median_ms)
        _event("serve_degraded", name, moved=moved,
               tpot_ema_ms=tpot_ema_ms, median_ms=median_ms)
        return moved

    def _try_readmit(self, name: str,
                     emas: Dict[str, float]) -> bool:
        """Probe a degraded replica against a healthy reference; a clean
        probe (within the straggler factor of the reference) re-admits
        it to routing."""
        with self._lock:
            h = self.handles.get(name)
            healthy = [n for n in emas if n in self.handles]
        if h is None or not hasattr(h, "probe"):
            return False
        ref_s = None
        for other in sorted(healthy):
            oh = self.handles.get(other)
            if oh is None or not hasattr(oh, "probe"):
                continue
            try:
                ref_s = oh.probe()
                break
            except (OSError, ConnectionError):
                continue
        if ref_s is None:
            return False
        try:
            probe_s = h.probe()
        except (OSError, ConnectionError):
            return False
        # relative test with a floor: host noise on a microsecond probe
        # must not read as degradation
        if probe_s > self._degrade_factor * max(ref_s, 1e-3):
            _event("serve_probe_dirty", name,
                   probe_s=round(probe_s, 6), ref_s=round(ref_s, 6))
            return False
        with self._lock:
            self._degraded.discard(name)
        try:
            h.undegrade()
        except (OSError, ConnectionError, AttributeError):
            pass
        self.meter.readmit(name)
        _event("serve_readmitted", name, probe_s=round(probe_s, 6),
               ref_s=round(ref_s, 6))
        return True

    def failover(self, name: str, epoch: int) -> int:
        """Fence ``name``'s incarnation ``epoch`` at the depot, fold its
        journal, close the flush→emit window through the sink, and
        re-submit its unfinished requests to survivors with delivered
        high-water marks primed.  Returns the number replayed."""
        with self._lock:
            if self._fenced.get(name, -1) >= epoch:
                return 0
            self._fenced[name] = epoch
            self._epochs.pop(name, None)
        # 1. fence FIRST: after this the fold's high-water mark is final —
        #    the zombie's late flushes are refused at the depot
        fence = self.depot.fence(name, epoch + 1)
        # 2. fold the dead incarnation's ledger from the depot
        st = fold_depot_journal(self.depot, name, epoch)
        self.detach(name)
        # 3. close the flush→emit window: re-offer every journaled token
        #    (the sink drops what the client already saw)
        for rid in sorted(st.delivered):
            if rid in st.shed:
                continue
            self._note_rid(rid)
            for idx, tok in enumerate(st.delivered[rid]):
                self.emit(rid, idx, tok)
        with self._lock:
            for rid in st.finished:
                self.finished[rid] = list(st.delivered.get(rid, []))
                self.assignments.pop(rid, None)
            for rid, reason in st.shed.items():
                # "drained" rids moved to another replica pre-death: they
                # are not dead work, their new home owns them
                if reason != "drained":
                    self.shed.setdefault(rid, reason)
                    self.assignments.pop(rid, None)
        # 4. replay open work on survivors, high-water marks primed and
        #    deadlines still aging from the ORIGINAL submit wall clock
        replayed = 0
        for rid in sorted(st.open_rids()):
            with self._lock:
                if rid in self.finished or rid in self.shed:
                    continue
            rec = st.requests[rid]
            desc = {"prompt": rec["prompt"],
                    "max_new_tokens": rec["max_new_tokens"],
                    "eos_token_id": rec.get("eos_token_id"),
                    "deadline": rec.get("deadline"),
                    "submit_wall": rec.get("submit_wall", self._wall()),
                    "trace_id": rec.get("trace_id")}
            with self._lock:
                self.requests.setdefault(rid, desc)
            delivered = list(st.delivered.get(rid, []))
            if self._replay_one(rid, desc, delivered, exclude={name}):
                replayed += 1
        self.failovers += 1
        self.replayed_requests += replayed
        self.meter.failover(name, replayed=replayed)
        _event("serve_failover", name, epoch=epoch, fence=fence,
               replayed=replayed, finished=len(st.finished),
               truncated=st.truncated)
        return replayed

    def _replay_one(self, rid: int, desc: dict, delivered: List[int],
                    exclude: Set[str] = frozenset()) -> bool:
        age = max(0.0, self._wall() - desc.get("submit_wall", self._wall()))
        try:
            self._route_submit(desc, rid=rid, delivered=delivered or None,
                               age_s=age, exclude=exclude)
            return True
        except Overloaded:
            # survivors are full RIGHT NOW: the request is accepted work,
            # park it and retry on the next scan rather than dropping it
            with self._lock:
                self._orphans.append((rid, desc, delivered))
            return False
        except ValueError:
            return False   # duplicate re-submission (already replayed)

    def _retry_orphans(self) -> None:
        with self._lock:
            orphans, self._orphans = self._orphans, []
        for rid, desc, delivered in orphans:
            with self._lock:
                if rid in self.finished or rid in self.shed:
                    continue
            self._replay_one(rid, desc, delivered)

    def _note_rid(self, rid: int) -> None:
        with self._lock:
            self._next_rid = max(self._next_rid, int(rid) + 1)

    # -- drain / join ------------------------------------------------------
    def drain(self, name: str) -> int:
        """Stop routing to ``name`` and re-home its queued-but-unstarted
        work on the other replicas.  Active requests keep running there;
        returns the number handed back and re-routed."""
        with self._lock:
            self._draining.add(name)
            h = self.handles.get(name)
        moved = self._rehome_queued(name, h)
        self.meter.handback(name, moved)
        _event("serve_drain", name, moved=moved)
        return moved

    def _rehome_queued(self, name: str, h) -> int:
        """Hand back ``name``'s queued-but-unstarted work and re-route it
        on the other replicas (the drain path; the degraded ejection
        re-homes through the same seam)."""
        if h is None:
            return 0
        try:
            handback = h.drain()
        except (OSError, ConnectionError):
            return 0
        moved = 0
        for d in handback:
            rid = int(d["rid"])
            desc = {"prompt": d["prompt"],
                    "max_new_tokens": d["max_new_tokens"],
                    "eos_token_id": d.get("eos_token_id"),
                    "deadline": d.get("deadline"),
                    "submit_wall": self._wall() - float(d.get("age_s", 0.0)),
                    "trace_id": d.get("trace_id")}
            if self._replay_one(rid, desc, [], exclude={name}):
                moved += 1
        return moved

    def undrain(self, name: str) -> None:
        with self._lock:
            self._draining.discard(name)

    # -- frontend restart (double fault) -----------------------------------
    def recover(self) -> dict:
        """Rebuild the fleet view after a frontend restart: every lease
        key names a replica; live ones have their depot ledgers folded
        into bookkeeping (and their delivered tokens re-offered to the
        sink, which dedups), expired ones are failed over exactly as if
        the running frontend had caught them — covering the double fault
        where a replica SIGKILL and the frontend crash share a window.
        Attach surviving in-process handles BEFORE calling this."""
        folded, failed = 0, []
        for name, (st, age, doc) in sorted(self._scan().items()):
            if lease_expired(age, float(doc.get("ttl", self.ttl))):
                if self.failover(name, st.epoch):
                    pass
                failed.append(name)
                continue
            self._epochs[name] = st.epoch
            if self.auto_attach and name not in self.handles and \
                    ":" in str(st.address):
                try:
                    self.attach(RemoteReplica(name, st.address))
                except (OSError, ValueError):
                    pass
            jstate = fold_depot_journal(self.depot, name, st.epoch)
            folded += 1
            for rid in sorted(jstate.delivered):
                if rid in jstate.shed:
                    continue
                self._note_rid(rid)
                for idx, tok in enumerate(jstate.delivered[rid]):
                    self.emit(rid, idx, tok)
            with self._lock:
                for rid, rec in jstate.requests.items():
                    self.requests.setdefault(rid, {
                        "prompt": rec["prompt"],
                        "max_new_tokens": rec["max_new_tokens"],
                        "eos_token_id": rec.get("eos_token_id"),
                        "deadline": rec.get("deadline"),
                        "submit_wall": rec.get("submit_wall",
                                               self._wall()),
                        "trace_id": rec.get("trace_id")})
                    if rid not in jstate.finished and \
                            rid not in jstate.shed:
                        self.assignments[rid] = name
                for rid in jstate.finished:
                    self.finished[rid] = list(
                        jstate.delivered.get(rid, []))
                for rid, reason in jstate.shed.items():
                    if reason != "drained":
                        self.shed.setdefault(rid, reason)
        info = {"replicas_folded": folded, "failed_over": failed,
                "requests_known": len(self.requests)}
        _event("serve_frontend_recover", "frontend", **info)
        return info

    # -- completion tracking ----------------------------------------------
    def finished_rids(self) -> Set[int]:
        """Requests known complete (finished or shed), merging frontend
        bookkeeping with live replica statuses."""
        with self._lock:
            done = set(self.finished) | set(self.shed)
            handles = dict(self.handles)
        for name, h in handles.items():
            try:
                st = h.status()
            except (OSError, ConnectionError):
                continue   # the lease scan decides whether it's dead
            with self._lock:
                for rid in st.get("finished", []):
                    done.add(int(rid))
                    self.finished.setdefault(int(rid), [])
                for rid, reason in (st.get("shed") or {}).items():
                    if reason == "drained":
                        continue
                    done.add(int(rid))
                    self.shed.setdefault(int(rid), reason)
        return done

    def wait_all(self, rids, timeout: float = 120.0,
                 poll: float = 0.05) -> bool:
        """Wait until every rid is finished or shed, scanning for deaths
        while waiting (this drives the failover when no scan thread
        runs)."""
        want = {int(r) for r in rids}
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.scan_once()
            if want <= self.finished_rids():
                return True
            time.sleep(poll)
        return want <= self.finished_rids()

    def publish_disagg(self) -> None:
        """Push the frontend's disaggregation self-report (prefix hit
        rate, per-tier occupancy, prefill-tier counters) to the metrics
        depot as the ``disagg`` extra — the report CLI folds it with
        latest-``wall_time``-wins, mirroring the autoscaler's doc."""
        try:
            self.depot.metrics_push("frontend", {
                "src": "frontend", "wall_time": self._wall(),
                "disagg": self.meter.disagg_doc()})
        except (OSError, AttributeError):
            pass   # a flaky depot link must not kill the scan loop

    # -- background scanning ----------------------------------------------
    def start(self) -> "ServingFrontend":
        """Run :meth:`scan_once` on a daemon thread every
        ``PADDLE_TPU_SERVE_FLEET_SCAN`` seconds."""
        if self._scan_thread is None or not self._scan_thread.is_alive():
            self._stop.clear()
            interval = _scan_interval(self.ttl)

            def _loop():
                while not self._stop.wait(interval):
                    try:
                        self.scan_once()
                        self.publish_disagg()
                    except Exception:
                        pass   # a flaky store read must not kill the scan
            self._scan_thread = threading.Thread(
                target=_loop, daemon=True, name="paddle-tpu-fleet-scan")
            self._scan_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._scan_thread is not None:
            self._scan_thread.join(timeout=2)
            self._scan_thread = None
        with self._lock:
            handles = list(self.handles)
        for name in handles:
            self.detach(name)

    def summary(self) -> dict:
        with self._lock:
            return {"replicas": sorted(self.handles),
                    "requests": len(self.requests),
                    "finished": len(self.finished),
                    "shed": len(self.shed),
                    "failovers": self.failovers,
                    "replayed_requests": self.replayed_requests,
                    "orphans": len(self._orphans)}
