"""Elastic training / fault tolerance (reference
`python/paddle/distributed/fleet/elastic/manager.py`: ElasticManager:126,
ElasticStatus:48, ElasticLevel:43, watch loop; `collective_elastic.py`).

The reference coordinates through etcd: each rank writes a TTL'd heartbeat
node, the manager watches the peer set and restarts the pod (exit code 101)
when membership changes, resuming from checkpoint. This package's translation
(a copy of the reference package's, which is framework-free):

- the coordination store is pluggable (:class:`FileStore` — a shared-
  filesystem KV with mtime heartbeats, the natural medium on a cluster where
  every host mounts the same NFS/GCS path; any KV with put/get/delete/keys
  works);
- the watch loop is the same state machine (HOLD while under ``np_min``,
  RESTART on membership change, COMPLETED on a done-flag);
- recovery composes with :mod:`paddle_tpu_torch.distributed.checkpoint`: the
  ``pre_hook``/restart path saves a sharded checkpoint, the relaunched job
  loads it under the NEW mesh (reshard-on-load makes scale in/out work);
- the **supervisor path** (``supervisor.py``) closes the loop on one host:
  :class:`Supervisor` relaunches the job with bounded restarts + seeded
  backoff whenever it exits :data:`ELASTIC_EXIT_CODE` (101). The child
  side produces that exit from either direction — a
  :class:`PreemptionGuard` SIGTERM (async checkpoint + flight-recorder
  dump, then 101) or a :class:`~paddle_tpu_torch.distributed.CommWatchdog` hang
  (recorder dump, then :func:`emergency_handler` saves a committed
  emergency checkpoint and exits 101) — and on relaunch resumes from
  ``checkpoint.latest_checkpoint(root)``, which only ever returns a
  checkpoint whose atomic commit finished. ``keep_n`` retention GC between
  restarts stops a crash loop from filling the disk.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Callable, List, Optional

from ..fault_domain import FLEET_EXIT_CODE, HeartbeatLease

__all__ = ["ElasticManager", "ElasticStatus", "ElasticLevel", "FileStore",
           "ELASTIC_EXIT_CODE", "PreemptionGuard", "Supervisor",
           "RestartPolicy", "emergency_handler", "FleetSupervisor",
           "GangPolicy", "HeartbeatLease"]

ELASTIC_EXIT_CODE = FLEET_EXIT_CODE  # 101 everywhere in the stack


class ElasticLevel:
    FAULT_TOLERANCE = 1  # fixed np: restart only when a peer dies
    ELASTIC = 2          # np range: also rescale on join/leave


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class FileStore:
    """Shared-filesystem KV with heartbeat semantics (the etcd stand-in).
    A key is a file ``<root>/<key>``; its freshness is the file mtime; a
    value is the file content (JSON)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__"))

    def put(self, key: str, value) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(value, f)
        os.replace(tmp, self._path(key))

    def get(self, key: str):
        try:
            with open(self._path(key)) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self, prefix: str = "") -> List[str]:
        pref = prefix.replace("/", "__")
        return [k.replace("__", "/") for k in os.listdir(self.root)
                if k.startswith(pref) and not k.endswith(".tmp")]

    def touch(self, key: str) -> None:
        os.utime(self._path(key))

    def age(self, key: str) -> float:
        try:
            return time.time() - os.path.getmtime(self._path(key))
        except FileNotFoundError:
            return float("inf")


class ElasticManager:
    """Membership watcher + restart decision (reference :126).

    ``np``: int (fault-tolerance level: fixed size) or "min:max" string /
    (min, max) tuple (elastic level). Each host registers
    ``nodes/<host_id>`` and heartbeats it every ``ttl/3`` seconds; a node
    whose heartbeat is older than ``ttl`` is dead."""

    def __init__(self, store: FileStore, job_id: str = "default", np=1,
                 host: Optional[str] = None, ttl: float = 60.0,
                 timeout: float = 120.0,
                 pre_hook: Optional[Callable] = None,
                 post_hook: Optional[Callable] = None):
        if isinstance(np, str) and ":" in np:
            lo, hi = np.split(":")
            self.np_min, self.np_max = int(lo), int(hi)
        elif isinstance(np, (tuple, list)):
            self.np_min, self.np_max = int(np[0]), int(np[1])
        else:
            self.np_min = self.np_max = int(np)
        self.elastic_level = ElasticLevel.ELASTIC if self.np_max > self.np_min \
            else ElasticLevel.FAULT_TOLERANCE
        self.store = store
        self.job_id = job_id
        self.host_id = host or f"{socket.gethostname()}-{os.getpid()}"
        self.ttl = ttl
        self.timeout = timeout
        self.pre_hook = pre_hook
        self.post_hook = post_hook
        self._key = f"{job_id}/nodes/{self.host_id}"
        self._world_key = f"{job_id}/world"
        self._lease: Optional[HeartbeatLease] = None
        self.register()

    # -- membership --------------------------------------------------------
    def register(self) -> None:
        # one heartbeat implementation for the whole stack: the same
        # HeartbeatLease the fleet fault domain publishes rank leases with,
        # here over the elastic store backend (FileStore or TCPKVStore) —
        # beat period matches the reference's ttl/3, floored at 0.5s
        self._lease = HeartbeatLease(
            self.store, self._key, ttl=self.ttl, interval=self.ttl / 3,
            min_interval=0.5,
            payload={"host": self.host_id, "ts": time.time()})
        self._lease.start()

    def hosts(self) -> List[str]:
        """Live peers (heartbeat fresher than ttl)."""
        prefix = f"{self.job_id}/nodes/"
        alive = []
        for key in self.store.keys(prefix):
            if self.store.age(key) <= self.ttl:
                alive.append(key[len(prefix):])
        return sorted(alive)

    def commit_world(self) -> List[str]:
        """Record the current membership as the agreed world (done once
        training (re)starts; the watch loop compares against it)."""
        world = self.hosts()
        self.store.put(self._world_key, world)
        return world

    # -- watch loop --------------------------------------------------------
    def watch_once(self) -> str:
        """One membership check → ElasticStatus (reference watch loop body)."""
        status = self._watch_once()
        if status != ElasticStatus.HOLD:
            try:  # flight recorder: elastic transitions bracket restarts —
                # one `elastic_<status>` event kind per transition (e.g.
                # elastic_restart / elastic_completed / elastic_error), so
                # dumps and the chrome-trace merge can filter them directly
                from .... import telemetry

                telemetry.record_event(f"elastic_{status}", self.host_id,
                                       live=len(self.hosts()),
                                       job_id=self.job_id)
            except Exception:
                pass
        return status

    def _watch_once(self) -> str:
        if self.store.get(f"{self.job_id}/completed"):
            return ElasticStatus.COMPLETED
        world = self.store.get(self._world_key) or []
        live = self.hosts()
        if len(live) < self.np_min:
            return ElasticStatus.HOLD  # under-provisioned: wait (or time out)
        if not world:
            return ElasticStatus.RESTART  # quorum reached, no world yet: start
        if set(live) != set(world):
            return ElasticStatus.RESTART  # died/joined/replaced peers
        return ElasticStatus.HOLD  # steady state

    def watch(self, interval: float = 1.0, max_wait: Optional[float] = None) -> str:
        """Block until the state machine leaves steady-state: returns
        COMPLETED / RESTART / ERROR (HOLD longer than ``timeout`` while
        under-provisioned → ERROR, as the reference's elastic_timeout)."""
        t0 = time.time()
        hold_since: Optional[float] = None
        while True:
            status = self.watch_once()
            if status in (ElasticStatus.COMPLETED, ElasticStatus.RESTART):
                if status == ElasticStatus.RESTART and self.pre_hook:
                    self.pre_hook()
                return status
            live = self.hosts()
            if len(live) < self.np_min:
                hold_since = hold_since or time.time()
                if time.time() - hold_since > self.timeout:
                    return ElasticStatus.ERROR
            else:
                hold_since = None
            if max_wait is not None and time.time() - t0 >= max_wait:
                return ElasticStatus.HOLD
            time.sleep(interval)

    # -- lifecycle ---------------------------------------------------------
    def ready(self) -> bool:
        return len(self.hosts()) >= self.np_min

    def exit(self, completed: bool = False) -> None:
        if completed:
            self.store.put(f"{self.job_id}/completed", True)
        if self._lease is not None:
            self._lease.stop(release=True)
        try:  # flight recorder: leaving is a transition too
            from .... import telemetry

            telemetry.record_event("elastic_exit", self.host_id,
                                   completed=completed, job_id=self.job_id)
        except Exception:
            pass
        if self.post_hook:
            self.post_hook(completed)


from .preemption import PreemptionGuard  # noqa: E402
from .supervisor import (RestartPolicy, Supervisor,  # noqa: E402
                         emergency_handler)
from .gang import FleetSupervisor, GangPolicy  # noqa: E402
