"""Communication watchdog (port of the reference's ``distributed/watchdog.py``;
reference `paddle/phi/core/distributed/comm_task_manager.h:37`
CommTaskManager: a loop thread that detects collectives exceeding their
timeout and dumps diagnostics before the job is aborted).

A hung collective shows up on the host as a wait that never returns (a
``torch.cuda.synchronize``, a ``Work.wait``, a step call).
:class:`CommWatchdog` arms a timer around such waits; on expiry it dumps
every Python thread's stack and calls ``on_timeout``, which by default
logs; pass e.g. ``lambda info: os._exit(101)`` to end the rank.

Each armed wait is a ``watch_armed`` event in the flight recorder; on
expiry the watchdog records ``watchdog_timeout``, dumps the recorder and
hands the dump's path to ``on_timeout`` as ``flight_recorder_dump`` (``''``
with telemetry off), as the reference does.  A fault domain (``poll_once``,
``poison``, ``rank``), or ``"current"`` for the process-global one that
``fleet.fault_domain.init_from_env`` sets, resolved at every tick, is
polled and poisoned as in the reference.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

__all__ = ["CommWatchdog"]


class _Watch:
    __slots__ = ("name", "started", "deadline")

    def __init__(self, name: str, timeout: float):
        self.name = name
        self.started = time.time()
        self.deadline = self.started + timeout


class CommWatchdog:
    """Arm/disarm a timeout around communication waits.

    ``with watchdog.watch("all_reduce"): torch.cuda.synchronize()``

    One monitor thread serves all watches (the reference keeps one loop
    thread for all comm tasks).  ``on_timeout(info)`` fires ONCE per expired
    watch with ``{"name", "elapsed", "stacks", "flight_recorder_dump"}``
    (and ``"poisoned"`` when a fault domain was poisoned).

    ``fault_domain`` makes a hang cluster-fatal: on expiry the watchdog
    poisons it (reason ``watchdog_hang``, culprit = this rank) BEFORE
    calling ``on_timeout``, and the monitor loop polls it every tick."""

    def __init__(self, timeout: float = 120.0,
                 on_timeout: Optional[Callable[[dict], None]] = None,
                 poll_interval: float = 0.5, fault_domain=None):
        self.timeout = timeout
        self.on_timeout = on_timeout or self._default_handler
        self.poll_interval = poll_interval
        self.fault_domain = fault_domain
        self._watches: Dict[int, _Watch] = {}
        self._fired: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.timeout_count = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "CommWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="paddle-tpu-comm-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        with self._lock:  # fired-marks must not leak across start/stop cycles
            self._fired.clear()

    # -- watches -----------------------------------------------------------
    def watch(self, name: str = "comm", timeout: Optional[float] = None):
        """Context manager arming one watch."""
        wd = self

        class _Ctx:
            def __enter__(self_ctx):
                self_ctx._id = wd._arm(name, timeout)
                return self_ctx

            def __exit__(self_ctx, *exc):
                wd._disarm(self_ctx._id)

        return _Ctx()

    def _arm(self, name: str, timeout: Optional[float]) -> int:
        self.start()
        w = _Watch(name, timeout if timeout is not None else self.timeout)
        wid = id(w)
        with self._lock:
            self._watches[wid] = w
        try:  # flight recorder: a hang dump must show what was in flight
            from .. import telemetry

            telemetry.record_event("watch_armed", name, timeout_s=w.deadline - w.started)
        except Exception:
            pass
        return wid

    def _disarm(self, wid: int) -> None:
        with self._lock:
            self._watches.pop(wid, None)
            self._fired.discard(wid)

    def attach_fault_domain(self, domain) -> None:
        """Join a fault domain after construction (the ``fault_domain=``
        ctor arg is equivalent)."""
        self.fault_domain = domain

    def _resolve_domain(self):
        fd = self.fault_domain
        if fd == "current":
            from .fleet import fault_domain as _fd_mod

            return _fd_mod.current()
        return fd

    # -- monitor -----------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            fd = self._resolve_domain()
            if fd is not None:
                try:  # coordinated abort: a poisoned gang must not keep
                    # waiting out local timeouts — poll_once aborts the rank
                    fd.poll_once()
                except Exception:
                    traceback.print_exc()
            now = time.time()
            expired: List[tuple] = []
            with self._lock:
                # a fired-mark only matters while its watch is armed; prune
                # marks whose watch is gone so the set stays bounded even if
                # a caller _arm()s directly and never _disarm()s
                self._fired &= self._watches.keys()
                for wid, w in self._watches.items():
                    if now > w.deadline and wid not in self._fired:
                        self._fired.add(wid)
                        expired.append((wid, w))
            for wid, w in expired:
                self.timeout_count += 1
                info = {"name": w.name, "elapsed": now - w.started,
                        "stacks": self._all_stacks()}
                if fd is not None:
                    try:  # the detecting party poisons FIRST: siblings
                        # wedged in the same collective start their bounded
                        # exits while this rank is still dumping stacks
                        fd.poison("watchdog_hang", culprit=fd.rank,
                                  detail=f"{w.name} exceeded "
                                         f"{w.deadline - w.started:.1f}s")
                        info["poisoned"] = True
                    except Exception:
                        traceback.print_exc()
                info["flight_recorder_dump"] = self._dump_flight_recorder(w, now)
                try:
                    self.on_timeout(info)
                except Exception:
                    traceback.print_exc()

    @staticmethod
    def _dump_flight_recorder(w, now: float) -> str:
        """Record the timeout as the ring's last event, so that the dump's
        tail names the hung wait, then write the dump.  Returns its path
        ('' when telemetry is off or the write fails)."""
        try:
            from .. import telemetry

            telemetry.bump("watchdog_timeouts_total")
            telemetry.record_event("watchdog_timeout", w.name, elapsed_s=now - w.started)
            return telemetry.dump_flight_recorder(reason="watchdog_hang")
        except Exception:
            return ""

    @staticmethod
    def _all_stacks() -> str:
        out = []
        for tid, frame in sys._current_frames().items():
            out.append(f"--- thread {tid} ---\n" +
                       "".join(traceback.format_stack(frame)))
        return "\n".join(out)

    @staticmethod
    def _default_handler(info: dict) -> None:
        print(f"[comm watchdog] '{info['name']}' exceeded timeout "
              f"({info['elapsed']:.1f}s elapsed); thread stacks:\n"
              f"{info['stacks']}", file=sys.stderr)
