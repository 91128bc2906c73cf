"""Collective tracing and the analytic link cost model (port of the
reference's ``telemetry/collectives.py``), with the chip tables.

Two recording modes, as in the reference:

- **eager**: ``distributed.all_reduce(x)`` and the other collectives of
  ``distributed/communication.py`` call :func:`record_collective` once a
  call, with the payload in hand;
- **per step**: an engine whose collectives run inside its step
  (``DistributedTrainStep``'s gradient reductions, the 1F1B engine's
  sends) registers a :class:`TracedProgram`, the analytic collective
  profile of one step, once, and bumps its execution counter each step,
  so the executed bytes stay right without recording each call.

Wire cost uses the ring formulas: all-reduce moves ``2(n-1)/n * S`` bytes a
member, gather/scatter ``(n-1)/n * S``, permute ``S``; the time estimate
prices those bytes at the device's one-way link rate.

``PEAK_TFLOPS`` (dense bf16 TFLOP/s), ``PEAK_HBM_GBPS`` (device memory
GB/s) and ``ICI_GBPS_ONEWAY`` (GB/s a direction over the chip-to-chip link)
keep the reference's TPU rows and its nominal CPU row, and add the H100's
from NVIDIA's H100 data sheet: the SXM card at 989 TFLOP/s, 3350 GB/s and
NVLink 4's 900 GB/s both ways (450 a direction), the PCIe card at 756, 2000
and the NVLink bridge's 600 GB/s (300 a direction). The PCIe rows come
first so that the name does not match the SXM rows. :func:`chip_lookup`
matches substrings of a device's name (``torch.cuda.get_device_name``)
against a table.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import torch

from . import runtime
from .recorder import record_event

__all__ = ["record_collective", "collective_stats", "ici_cost_estimate",
           "ring_wire_bytes", "TracedProgram", "register_traced_program",
           "PEAK_TFLOPS", "ICI_GBPS_ONEWAY", "PEAK_HBM_GBPS", "chip_lookup"]

# chip kind -> peak dense bf16 TFLOP/s
PEAK_TFLOPS = {
    "h100 pcie": 756.0, "h100": 989.0,
    "v5 lite": 197.0, "v5e": 197.0, "v5litepod": 197.0,
    "v5p": 459.0, "v4": 275.0, "v6e": 918.0, "v6": 918.0,
    "cpu": 0.5,  # nominal, so CPU smoke runs still report
}

# chip kind -> one-directional chip-to-chip link bandwidth, GB/s (the TPU
# rows are the reference's ICI figures; the H100 rows NVLink's)
ICI_GBPS_ONEWAY = {
    "h100 pcie": 300.0, "h100": 450.0,
    "v5 lite": 45.0, "v5e": 45.0, "v5litepod": 45.0,
    "v5p": 90.0, "v4": 45.0, "v6e": 90.0, "v6": 90.0,
    "cpu": 10.0,
}

# chip kind -> peak device-memory bandwidth GB/s
PEAK_HBM_GBPS = {
    "h100 pcie": 2000.0, "h100": 3350.0,
    "v5 lite": 819.0, "v5e": 819.0, "v5litepod": 819.0,
    "v5p": 2765.0, "v4": 1228.0, "v6e": 1640.0, "v6": 1640.0,
    "cpu": 50.0,
}


def _device_kind(device) -> str:
    """The name of ``device``: a card's from ``torch.cuda.get_device_name``;
    a string that names no device type is taken as the name itself."""
    if isinstance(device, str) and device.split(":")[0] not in ("cuda", "cpu", "gpu"):
        return device
    dev = torch.device(device.replace("gpu", "cuda") if isinstance(device, str) else device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def chip_lookup(device, table: dict) -> float:
    """The first row of ``table`` whose key is a substring of the device's
    lower-cased name; the ``"cpu"`` row if none is."""
    kind = _device_kind(device).lower()
    for key, val in table.items():
        if key in kind:
            return val
    return table["cpu"]


# ring-cost wire factor per participant count n
_RING_FACTORS = {
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "reduce": lambda n: 2.0 * (n - 1) / n,          # lowered to all_reduce
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "broadcast": lambda n: (n - 1) / n,
    "scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
    "psum": lambda n: 2.0 * (n - 1) / n,
}


def ring_wire_bytes(kind: str, nbytes: int, group_size: int) -> float:
    """Per-chip wire bytes for one collective over a ring of group_size.
    A single-participant group moves nothing over the wire."""
    n = int(group_size)
    if n <= 1:
        return 0.0
    factor = _RING_FACTORS.get(kind, lambda n: 1.0)(n)
    return factor * float(nbytes)


_ici_gbps_cache: Optional[float] = None


def _ici_gbps() -> float:
    # the card is fixed for the process lifetime: read its name once, not
    # per eager collective (and not at import, which would start CUDA)
    global _ici_gbps_cache
    if _ici_gbps_cache is None:
        try:
            dev = "cuda" if torch.cuda.is_available() else "cpu"
            _ici_gbps_cache = chip_lookup(dev, ICI_GBPS_ONEWAY)
        except Exception:
            return ICI_GBPS_ONEWAY["cpu"]
    return _ici_gbps_cache


def ici_cost_estimate(kind: str, nbytes: int, group_size: int,
                      ici_gbps: Optional[float] = None) -> dict:
    """Analytic {wire_bytes, est_s} for one collective call."""
    wire = ring_wire_bytes(kind, nbytes, group_size)
    bw = (ici_gbps if ici_gbps is not None else _ici_gbps()) * 1e9
    return {"wire_bytes": wire, "est_s": wire / bw if bw > 0 else 0.0}


# ---------------------------------------------------------------------------
# aggregate registry

class _Agg:
    __slots__ = ("calls", "trace_records", "bytes", "wire_bytes", "est_s")

    def __init__(self):
        self.calls = 0          # executed collectives (eager + program execs)
        self.trace_records = 0  # trace-time records (once per trace)
        self.bytes = 0.0        # payload bytes of executed collectives
        self.wire_bytes = 0.0
        self.est_s = 0.0


_aggs: Dict[str, _Agg] = {}
_agg_lock = threading.Lock()


def _agg(kind: str) -> _Agg:
    # caller holds _agg_lock
    a = _aggs.get(kind)
    if a is None:
        a = _aggs[kind] = _Agg()
    return a


def record_collective(kind: str, nbytes: int, axes: Sequence[str] = (),
                      group_size: int = 1, trace_time: bool = False,
                      source: str = "eager") -> None:
    """Record one collective call (see module docstring for modes)."""
    if not runtime.enabled():
        return
    cost = ici_cost_estimate(kind, nbytes, group_size)
    with _agg_lock:
        a = _agg(kind)
        if trace_time:
            a.trace_records += 1
        else:
            a.calls += 1
            a.bytes += nbytes
            a.wire_bytes += cost["wire_bytes"]
            a.est_s += cost["est_s"]
    record_event("collective", kind, nbytes=int(nbytes),
                 axes=list(axes), group_size=int(group_size),
                 wire_bytes=int(cost["wire_bytes"]),
                 ici_est_s=round(cost["est_s"], 9),
                 trace_time=bool(trace_time), source=source)


def collective_stats() -> Dict[str, dict]:
    """Aggregate per-kind stats: executed calls, payload/wire bytes, the
    analytic ICI seconds, and trace-time record counts."""
    with _agg_lock:
        return {k: {"calls": a.calls, "trace_records": a.trace_records,
                    "bytes": int(a.bytes), "wire_bytes": int(a.wire_bytes),
                    "ici_est_s": a.est_s}
                for k, a in _aggs.items()}


def total_collective_bytes() -> float:
    with _agg_lock:
        return sum(a.bytes for a in _aggs.values())


# ---------------------------------------------------------------------------
# compiled programs with known collective profiles

class TracedProgram:
    """Analytic per-execution collective profile of one compiled program
    (e.g. the 1F1B pipeline step: 2 ppermutes x T ticks + 1 scalar psum).
    ``record_execution()`` folds the profile into the global aggregates and
    bumps the execution counter — the 'counter of executions' for
    collectives that only exist inside a jit."""

    def __init__(self, tag: str,
                 collectives: Sequence[dict]):  # {kind, nbytes, group_size, count}
        self.tag = tag
        self.collectives = [dict(c) for c in collectives]
        self.executions = 0
        # measured comm/compute overlap: the fraction of this program's
        # collective wall-time hidden under concurrent compute. None until
        # someone MEASURES it (chrome-trace interval intersection or the
        # HLO-bytes analytic bound — distributed/overlap/measure.py);
        # never guessed here.
        self.overlap_fraction: Optional[float] = None
        self._overlap_source: Optional[str] = None
        # profile is static: price it once, not per step (and never under
        # the aggregate lock: ici_cost_estimate may read the card's name)
        self._per_exec = []
        for c in self.collectives:
            n = int(c.get("count", 1))
            cost = ici_cost_estimate(c["kind"], int(c["nbytes"]),
                                     int(c.get("group_size", 1)))
            self._per_exec.append(
                (c["kind"], n, int(c["nbytes"]) * n,
                 cost["wire_bytes"] * n, cost["est_s"] * n))

    def set_overlap_fraction(self, fraction: float,
                             source: str = "measured") -> None:
        """Attach a MEASURED comm/compute overlap fraction (collective
        time ∧ compute time over collective time) to this program —
        exported through StepMeter summaries, the prometheus gauge, and
        bench detail. ``source`` names the measurement path
        ("chrome_trace" | "hlo_bytes" | custom)."""
        self.overlap_fraction = max(0.0, min(1.0, float(fraction)))
        self._overlap_source = source
        runtime.set_gauge("overlap_fraction_last", self.overlap_fraction)
        record_event("overlap", self.tag,
                     overlap_fraction=round(self.overlap_fraction, 4),
                     source=source)

    def wire_bytes_per_execution(self) -> float:
        return sum(w for _, _, _, w, _ in self._per_exec)

    def record_execution(self) -> None:
        if not runtime.enabled():
            return
        self.executions += 1
        with _agg_lock:
            for kind, n, nbytes, wire, est in self._per_exec:
                a = _agg(kind)
                a.calls += n
                a.bytes += nbytes
                a.wire_bytes += wire
                a.est_s += est
        runtime.bump(f"traced_program_executions_total:{self.tag}")
        record_event("collective_program", self.tag,
                     executions=self.executions,
                     collectives=self.collectives, trace_time=True,
                     source="compiled")


_programs: Dict[str, TracedProgram] = {}


def register_traced_program(tag: str, collectives: Sequence[dict]) -> TracedProgram:
    """Register (or replace) a compiled program's analytic collective
    profile; the registration itself is recorded as a trace-time event."""
    prog = TracedProgram(tag, collectives)
    _programs[tag] = prog
    if runtime.enabled():
        with _agg_lock:
            for c in prog.collectives:
                _agg(c["kind"]).trace_records += 1
        record_event("collective_trace", tag, collectives=prog.collectives,
                     trace_time=True, source="compiled")
    return prog


def traced_programs() -> Dict[str, TracedProgram]:
    return dict(_programs)


def _reset() -> None:
    with _agg_lock:
        _aggs.clear()
    _programs.clear()


runtime.on_reset(_reset)
