"""Deterministic fault injection for the checkpoint/restart stack.

The reference proves its fault tolerance operationally (kill an etcd
lease, watch ElasticManager restart the pod); a growing codebase needs the
same proof as a *unit test*. This module is a seeded, scope-based injector
that the checkpoint storage layer (``storage.py``) and commit protocol
(``commit.py``) consult at every I/O step. A test arms one or more
:class:`FaultSpec`\\ s inside a ``with`` block and the next matching
operations fail in a controlled, reproducible way:

``mode``
    - ``"error"``     raise :class:`InjectedIOError` (an ``OSError`` — the
      retriable class, so it exercises the backoff path; a spec with
      ``times=2`` flakes the first two attempts and lets the third pass);
    - ``"crash"``     raise :class:`InjectedCrash` (NOT retriable — models
      the process dying at this exact point; whatever bytes are on disk
      stay there);
    - ``"truncate"``  write only ``truncate_frac`` of the payload to the
      destination, then raise :class:`InjectedCrash` (a kill mid-``write``:
      a torn file at the final path);
    - ``"delay"``     sleep ``delay_s`` then continue (storage flake /
      slow NFS; pairs with the comm watchdog).  ``delay_s`` may be a
      ``(lo, hi)`` pair: each fire then draws its sleep uniformly from
      the range, seeded per-fire (``seed``, ``fired``) — soak campaigns
      don't phase-lock, yet replay identically;
    - ``"sigterm"``   deliver a real ``SIGTERM`` to this process and
      continue (synthetic preemption notice; pairs with
      :class:`~paddle_tpu_torch.distributed.fleet.elastic.PreemptionGuard`).

``op`` selects the protocol step (``"write"``, ``"read"``, ``"rename"``,
``"commit"`` — the marker write — ``"snap"`` — the in-memory snapshot
capture/ship path — or ``"any"``); ``pattern`` is an
``fnmatch`` over the file's basename (or full path). ``after``/``times``
window which matching calls fire, and ``p``/``seed`` make probabilistic
campaigns reproducible.

The ``sdc`` op models a *silently* defective chip: mode ``"bitflip"``
flips ONE seeded mantissa bit in the tensor payload handed to ``fire``
and returns the corrupted copy — no exception, no crash, just wrong
numbers, exactly the failure the fingerprint/vote ladder in
:mod:`..health.sdc` exists to catch. The flip seed advances with every
fire (``seed + fired``), so a sticky spec corrupts *differently* on each
re-execution — a replaying suspect cannot accidentally reproduce the
majority answer, matching real sticky-ALU behavior. Same scope / seed /
``after`` / ``times`` discipline as every other spec; chaos tests route a
grad through ``fire("sdc", f"grad_rank{rank}", data=grad)`` on the rank
under test.

The ``net`` op family covers the replicator's framed-TCP *client* path
(:class:`~.replicator.SnapshotClient` — journal shipping, metrics push,
fleet RPC): ``"net_connect"`` fires before a (re)connect,
``"net_write"`` before a request frame is sent, ``"net_read"`` before a
response is awaited; ``op="net"`` matches the whole family and
``pattern`` globs the peer address (``"127.0.0.1:9999"``).  Modes
``delay`` (slow link), ``error`` (refused/reset — note the client
transparently reconnects ONCE per call, so ``times=2`` is the smallest
spec that surfaces an ``OSError`` to the caller) and ``drop`` (the
connection dies mid-exchange: raises ``ConnectionResetError``, which the
same single-reconnect absorbs) let autoscale/drain chaos tests inject
flaky depot links instead of only process kills.

The ``slow`` op family models *degraded hardware* — a chip or link that
is alive but slow, the failure class the straggler ladder in
:mod:`..health.straggler` exists to catch: ``"slow_step"`` fires in the
train-step hot path (the fleet step note in :mod:`paddle_tpu_torch.jit`),
``"slow_collective"`` in the ring/neighbor collective path (the
straggler micro-probes announce their ppermute legs here, ``pattern``
globbing the ``link<a>-<b>`` pair name), and ``"slow_serve"`` in the
serving decode loop (per-token, so an armed delay inflates TPOT the way
a degraded replica would).  ``op="slow"`` matches the whole family.
Armed with ``mode="delay"``, this is the SIGSTOP-free way to make one
rank N× slow — the process keeps heartbeating, keeps computing, and
keeps being *late*, exactly the signature the detector must separate
from dead/wedged.

The ``serve`` op family covers the serving engine's hot path:
``"serve_prefill"`` / ``"serve_decode"`` fire before the compiled
prefill/decode programs run (state untouched — the engine's step loop
absorbs the failure and retries), ``"serve_pool"`` before KV-page
allocations, and ``"serve_journal"`` is the op the serving journal's
segment writes announce through ``storage.write_bytes`` (so a flaky
journal exercises the retry + circuit-breaker path).  A spec with
``op="serve"`` matches the whole family.

usage::

    from paddle_tpu_torch.distributed.checkpoint import faults

    with faults.inject(op="write", pattern="*.distcp", mode="error", times=2):
        save_state_dict(state, path)        # retries absorb the flakes

    with faults.inject(op="commit", mode="crash"):
        save_state_dict(state, path)        # dies between rename and marker
"""

from __future__ import annotations

import fnmatch
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["FaultSpec", "InjectedIOError", "InjectedCrash", "inject",
           "scope", "fire", "active", "reset"]

_MODES = ("error", "crash", "truncate", "delay", "sigterm", "bitflip",
          "drop")
_OPS = ("write", "read", "rename", "commit", "snap", "serve",
        "serve_prefill", "serve_decode", "serve_pool", "serve_journal",
        "sdc", "net", "net_connect", "net_read", "net_write",
        "slow", "slow_step", "slow_collective", "slow_serve",
        "disagg_stream", "any")


class InjectedIOError(OSError):
    """Retriable injected failure (models disk-full / GCS flake)."""


class InjectedCrash(RuntimeError):
    """Non-retriable injected failure (models the process dying here).
    Deliberately NOT an OSError so the retry wrapper never absorbs it."""


@dataclass
class FaultSpec:
    """One armed fault. Mutable counters live on the spec so a test can
    assert how often it actually fired (``spec.fired``)."""

    op: str = "write"
    pattern: str = "*"
    mode: str = "error"
    times: int = 1            # fire at most N times; -1 = unbounded
    after: int = 0            # skip the first `after` matching calls
    p: float = 1.0            # per-call fire probability
    seed: int = 0             # seeds the p-draws (reproducible campaigns)
    delay_s: object = 0.05    # float, or (lo, hi) for seeded per-fire draw
    truncate_frac: float = 0.5
    message: str = "injected fault"
    matched: int = 0          # matching calls seen (diagnostic)
    fired: int = 0            # times actually fired
    _rng: random.Random = field(default=None, repr=False)

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.op not in _OPS:
            raise ValueError(f"op must be one of {_OPS}, got {self.op!r}")
        if isinstance(self.delay_s, (tuple, list)):
            if len(self.delay_s) != 2 or \
                    float(self.delay_s[0]) > float(self.delay_s[1]):
                raise ValueError(
                    f"delay_s range must be (lo, hi) with lo <= hi, "
                    f"got {self.delay_s!r}")
        self._rng = random.Random(self.seed)

    # -- matching ----------------------------------------------------------
    def _matches(self, op: str, path: str) -> bool:
        if self.op == "serve":          # family spec: any serve_* step
            if not op.startswith("serve"):
                return False
        elif self.op == "net":          # family spec: any net_* step
            if not op.startswith("net"):
                return False
        elif self.op == "slow":         # family spec: any slow_* seam
            if not op.startswith("slow"):
                return False
        elif self.op != "any" and op != self.op:
            return False
        return fnmatch.fnmatch(os.path.basename(path), self.pattern) or \
            fnmatch.fnmatch(path, self.pattern)

    def _should_fire(self) -> bool:
        # caller holds the module lock: counters (incl. the fired budget)
        # advance atomically so a times=N spec cannot over-fire when the
        # main thread and an async writer hit the seam concurrently
        self.matched += 1
        if self.matched <= self.after:
            return False
        if self.times >= 0 and self.fired >= self.times:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    # -- action ------------------------------------------------------------
    def _act(self, op: str, path: str, data):
        """Perform the armed action; returns the (possibly transformed)
        payload — only ``bitflip`` transforms, every other mode returns
        ``data`` unchanged or raises."""
        _record(self, op, path)
        if self.mode == "bitflip":
            return self._bitflip(data)
        if self.mode == "delay":
            time.sleep(self._delay())
            return data
        if self.mode == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return data
        if self.mode == "truncate":
            if data is not None:
                cut = max(1, int(len(data) * self.truncate_frac))
                with open(path, "wb") as f:   # torn file at the FINAL path
                    f.write(data[:cut])
            raise InjectedCrash(
                f"{self.message}: crashed mid-write of {path} "
                f"(truncated to {self.truncate_frac:.0%})")
        if self.mode == "drop":
            # a dropped connection, not a refused one: the peer (or a
            # middlebox) killed the socket mid-exchange.  ConnectionError
            # so transparent-reconnect paths treat it as they would a
            # real RST
            raise ConnectionResetError(
                f"{self.message}: connection dropped at {op} {path}")
        if self.mode == "crash":
            raise InjectedCrash(f"{self.message}: crashed at {op} {path}")
        raise InjectedIOError(f"{self.message}: {op} {path} failed "
                              f"(fire {self.fired}/{self.times})")

    def _delay(self) -> float:
        """Resolved sleep for one ``delay`` fire: a scalar sleeps exactly
        ``delay_s`` (legacy fixed-delay specs unchanged); a ``(lo, hi)``
        pair draws uniformly from the range with a per-fire seed
        (``seed``, ``fired`` — same discipline as ``bitflip``), so soak
        runs don't phase-lock yet replay identically."""
        d = self.delay_s
        if isinstance(d, (tuple, list)):
            lo, hi = float(d[0]), float(d[1])
            return random.Random(
                self.seed * 1_000_003 + self.fired).uniform(lo, hi)
        return float(d)

    def _bitflip(self, data):
        """Flip one seeded bit in the payload and return the corrupted
        copy. Float arrays get a MANTISSA bit (a silently-wrong value of
        the same magnitude class, the classic SDC signature); other arrays
        and raw bytes get an arbitrary bit. The element/bit draw is seeded
        ``seed + fired`` so every fire of the same spec flips differently."""
        import numpy as np

        if data is None:
            return None
        rng = np.random.default_rng(self.seed + self.fired)
        if isinstance(data, (bytes, bytearray)):
            buf = bytearray(data)
            pos = int(rng.integers(0, len(buf))) if buf else 0
            if buf:
                buf[pos] ^= 1 << int(rng.integers(0, 8))
            return bytes(buf)
        arr = np.array(data, copy=True)
        if arr.size == 0:
            return arr
        idx = int(rng.integers(0, arr.size))
        flat = arr.reshape(-1)
        if arr.dtype == np.float32:
            bits = flat.view(np.uint32)
            bits[idx] ^= np.uint32(1 << int(rng.integers(0, 23)))
        elif arr.dtype == np.float64:
            bits = flat.view(np.uint64)
            bits[idx] ^= np.uint64(1 << int(rng.integers(0, 52)))
        elif arr.dtype == np.float16:
            bits = flat.view(np.uint16)
            bits[idx] ^= np.uint16(1 << int(rng.integers(0, 10)))
        else:
            bits = arr.reshape(-1).view(np.uint8)
            pos = int(rng.integers(0, bits.size))
            bits[pos] ^= np.uint8(1 << int(rng.integers(0, 8)))
        return arr


_active: List[FaultSpec] = []
_lock = threading.Lock()


def _record(spec: FaultSpec, op: str, path: str) -> None:
    try:  # flight recorder: injected faults must be visible in post-mortems
        from ... import telemetry

        telemetry.record_event("fault_injected", spec.mode, op=op,
                               path=os.path.basename(path),
                               fired=spec.fired)
    except Exception:
        pass


class scope:
    """Context manager arming one or more specs for its duration."""

    def __init__(self, *specs: FaultSpec):
        self.specs = list(specs)

    def __enter__(self):
        with _lock:
            _active.extend(self.specs)
        return self.specs[0] if len(self.specs) == 1 else self.specs

    def __exit__(self, *exc):
        with _lock:
            for s in self.specs:
                if s in _active:
                    _active.remove(s)
        return False


def inject(**kw) -> scope:
    """``with faults.inject(op="write", mode="error", times=2): ...``"""
    return scope(FaultSpec(**kw))


def fire(op: str, path: str, data=None):
    """Injection point — called by the storage layer before each I/O step
    (and by chaos seams like the SDC grad tap). Returns the payload,
    transformed by any armed ``bitflip`` spec that fired; existing callers
    that pass bytes-for-truncate and ignore the return are unaffected.
    No-op (and near-zero cost) when nothing is armed."""
    if not _active:
        return data
    with _lock:
        specs = [s for s in _active if s._matches(op, path)]
        # counters are advanced under the lock; actions run outside it so a
        # delay/sleep doesn't serialize unrelated I/O
        to_fire = [s for s in specs if s._should_fire()]
    for s in to_fire:
        data = s._act(op, path, data)
    return data


def active() -> List[FaultSpec]:
    with _lock:
        return list(_active)


def reset() -> None:
    """Disarm everything (test teardown safety net)."""
    with _lock:
        _active.clear()
