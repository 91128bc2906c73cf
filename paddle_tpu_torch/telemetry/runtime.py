"""Telemetry global state: counters, the event ring buffer handle, and the
enable switch.

Everything here is host-side and cheap (a lock + dict/deque updates per
event); recording is ON by default so a crashing run always has a flight
recorder to dump. ``PADDLE_TPU_TELEMETRY=0`` disables all recording at
import time; :func:`enable` / :func:`disable` flip it at runtime.

A copy of the reference's ``telemetry/runtime.py``, which holds no JAX; it
imports nothing of the package, so any module may import it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict

_lock = threading.RLock()
_enabled = os.environ.get("PADDLE_TPU_TELEMETRY", "1") not in ("0", "false", "")

# monotonically increasing counters, exported by prometheus_text()
_counters: Dict[str, float] = {}


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def bump(name: str, value: float = 1.0) -> None:
    """Increment a named counter (no-op when telemetry is disabled)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + value


def set_gauge(name: str, value: float) -> None:
    if not _enabled:
        return
    with _lock:
        _counters[name] = float(value)


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def get_counter(name: str, default: float = 0.0) -> float:
    with _lock:
        return _counters.get(name, default)


def now() -> dict:
    """One event timestamp: wall clock (for humans / JSONL) + monotonic ns
    (comparable with the profiler's perf_counter_ns timeline)."""
    return {"ts": time.time(), "mono_ns": time.perf_counter_ns()}


def identity() -> Dict[str, object]:
    """Who this process is, from the launch env: the self-identification
    stamp pushed metric snapshots and flight-recorder dumps carry so the
    launcher-side rollup / black-box merge can attribute them without
    guessing from filenames.  Keys appear only when known."""
    out: Dict[str, object] = {"pid": os.getpid()}
    rank = os.environ.get("PADDLE_TRAINER_ID")
    if rank is not None:
        try:
            out["rank"] = int(rank)
        except ValueError:
            pass
    replica = os.environ.get("PADDLE_TPU_SERVE_REPLICA")
    if replica:
        out["replica"] = replica
    return out


def reset() -> None:
    """Clear counters (tests). The flight recorder and collective registry
    register their own reset hooks here."""
    with _lock:
        _counters.clear()
    for fn in list(_reset_hooks):
        fn()


_reset_hooks: list = []


def on_reset(fn) -> None:
    _reset_hooks.append(fn)
