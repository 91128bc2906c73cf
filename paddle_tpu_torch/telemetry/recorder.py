"""Flight recorder: a bounded per-rank ring buffer of recent events (a copy
of the reference's ``telemetry/recorder.py``, which imports nothing of
JAX).

When a rank hangs or crashes, the last things it did (steps taken,
collectives issued, checkpoints written) tell where it was.  Events are
plain dicts appended to a ``deque(maxlen=N)``; ``dump()`` writes them as
JSON on demand (``dump_flight_recorder()``) and on an unhandled exception
(a chaining ``sys.excepthook``, installed at the first recorded event;
``PADDLE_TPU_FLIGHT_RECORDER=0`` opts out).  The port's ``StepMeter``
records a ``step`` event a step, and the checkpoint (saves, loads,
retries, injected faults, snapshots, resumes, preemption exits) records
its own; the other producers (collectives, the elastic and health
layers) arrive with ROADMAP A7b and A8.

Ring size: ``PADDLE_TPU_FLIGHT_RECORDER_SIZE`` (default 512). Dump dir:
``PADDLE_TPU_FLIGHT_RECORDER_DIR``, else ``PADDLE_TPU_EPOCH_DIR``, else
``flight_recorder/``.
"""

from __future__ import annotations

import collections
import json
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from . import runtime

__all__ = ["FlightRecorder", "get_flight_recorder", "record_event",
           "dump_flight_recorder", "kernel_fallback"]

_DEFAULT_SIZE = 512


class FlightRecorder:
    """Thread-safe bounded event ring. One global instance per process
    (per-rank under multi-process launch); tests may build their own."""

    def __init__(self, maxlen: Optional[int] = None):
        if maxlen is None:
            try:
                maxlen = int(os.environ.get("PADDLE_TPU_FLIGHT_RECORDER_SIZE",
                                            _DEFAULT_SIZE))
            except ValueError:
                maxlen = _DEFAULT_SIZE
            if maxlen < 1:  # a bad env value must not break import
                maxlen = _DEFAULT_SIZE
        self._events: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._dropped = 0

    def record(self, kind: str, name: str, **data) -> None:
        if not runtime.enabled():
            return
        ev = {"kind": kind, "name": name}
        ev.update(runtime.now())
        if data:
            ev.update(data)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)
        _install_excepthook()

    def events(self, since_mono_ns: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        if since_mono_ns is not None:
            evs = [e for e in evs if e.get("mono_ns", 0) >= since_mono_ns]
        return evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def dump(self, path: Optional[str] = None, reason: str = "on_demand",
             extra: Optional[dict] = None) -> str:
        """Write the ring (oldest first) as one JSON document; returns the
        path ('' when telemetry is disabled). Never raises — a crash-path
        dump must not mask the crash."""
        if not runtime.enabled():
            return ""
        try:
            if path is None:
                # default dir preference: explicit recorder dir > the
                # launcher's epoch dir (PADDLE_TPU_EPOCH_DIR, where
                # blackbox.merge folds all per-rank dumps) > ./flight_recorder
                d = os.environ.get("PADDLE_TPU_FLIGHT_RECORDER_DIR") \
                    or os.environ.get("PADDLE_TPU_EPOCH_DIR") \
                    or "flight_recorder"
                os.makedirs(d, exist_ok=True)
                stamp = time.strftime("%Y%m%d_%H%M%S")
                # rank/replica-qualify the name: N ranks dumping into one
                # epoch dir must never collide (host+pid alone recycles
                # across relaunches)
                ident = runtime.identity()
                tag = ""
                if ident.get("replica"):
                    tag = f"_{ident['replica']}"
                elif ident.get("rank") is not None:
                    tag = f"_rank{ident['rank']}"
                path = os.path.join(
                    d, f"flight_{socket.gethostname()}{tag}"
                       f"_pid{os.getpid()}"
                       f"_{reason}_{stamp}_{time.time_ns() % 1_000_000}.json")
            doc = {
                "reason": reason,
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "identity": runtime.identity(),
                "dumped_at": time.time(),
                "dropped_events": self._dropped,
                "counters": runtime.counters(),
                "events": self.events(),
            }
            if extra:
                doc["extra"] = extra
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
            runtime.bump("flight_recorder_dumps_total")
            return path
        except Exception as e:  # pragma: no cover - crash-path safety
            sys.stderr.write(f"[telemetry] flight recorder dump failed: {e!r}\n")
            return ""


_recorder = FlightRecorder()
runtime.on_reset(_recorder.clear)


def get_flight_recorder() -> FlightRecorder:
    return _recorder


def record_event(kind: str, name: str, **data) -> None:
    """Append one event to the global flight recorder."""
    _recorder.record(kind, name, **data)


def dump_flight_recorder(path: Optional[str] = None, reason: str = "on_demand",
                         extra: Optional[dict] = None) -> str:
    return _recorder.dump(path, reason, extra)


def kernel_fallback(kernel: str, reason: str, **shape_info) -> None:
    """A kernel gate rejected a call and the caller took the plain path:
    a ``kernel_fallback`` flight-recorder event naming the kernel and the
    reason (``mask`` / ``dropout`` / ``shape``) plus
    ``kernel_fallback.<kernel>.<reason>`` counters readable via
    ``telemetry.counters()``."""
    runtime.bump(f"kernel_fallback.{kernel}.{reason}")
    runtime.bump("kernel_fallback.total")
    record_event("kernel_fallback", kernel, reason=reason, **shape_info)


# -- crash dump -------------------------------------------------------------

_hook_installed = False
_hook_lock = threading.Lock()


def _install_excepthook() -> None:
    """Chain a dump onto sys.excepthook once, lazily (first event recorded),
    so importing the package never mutates interpreter state for processes
    that record nothing. ``PADDLE_TPU_FLIGHT_RECORDER=0`` opts out."""
    global _hook_installed
    if _hook_installed or \
            os.environ.get("PADDLE_TPU_FLIGHT_RECORDER", "1") in ("0", "false"):
        return
    with _hook_lock:
        if _hook_installed:
            return
        prev = sys.excepthook

        def hook(exc_type, exc, tb):
            if len(_recorder) and not issubclass(exc_type, KeyboardInterrupt):
                _recorder.dump(reason="unhandled_exception",
                               extra={"exception": repr(exc)[:500]})
            prev(exc_type, exc, tb)

        sys.excepthook = hook
        _hook_installed = True
