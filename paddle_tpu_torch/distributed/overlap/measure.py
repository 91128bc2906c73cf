"""Measured communication/computation overlap (port of the reference's
``distributed/overlap/measure.py``).

- :func:`overlap_fraction_from_trace`: from a Chrome trace (what
  ``torch.profiler``'s ``export_chrome_trace`` writes), the share of the
  collectives' time that ran while computation ran on the device: the
  collective intervals intersected with the merged compute intervals.
  NCCL kernels count as collectives.  When the trace holds device events
  (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``), only those count,
  so host-side operator spans are not taken for device work; a trace
  without them is read as the reference reads its own: every duration
  event outside the ``telemetry`` category.
- :func:`hidden_comm_seconds`: the analytic bound for when no trace
  exists: ring-decomposed bytes can hide under the compute there is.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["overlap_fraction_from_trace", "hidden_comm_seconds",
           "COLLECTIVE_EVENT_RE"]

# names the profilers give collective work on a device track (NCCL's kernels
# are ncclDevKernel_* / ncclKernel_*)
COLLECTIVE_EVENT_RE = re.compile(
    r"all-gather|all-reduce|reduce-scatter|collective-permute|all-to-all"
    r"|all_gather|all_reduce|reduce_scatter|ppermute|psum|nccl", re.IGNORECASE)

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intersection(span: Tuple[float, float], merged: List[Tuple[float, float]]) -> float:
    s, e = span
    covered = 0.0
    for ms, me in merged:
        if me <= s:
            continue
        if ms >= e:
            break
        covered += min(e, me) - max(s, ms)
    return covered


def overlap_fraction_from_trace(events: Iterable[Dict]) -> Optional[float]:
    """Fraction of collective time hidden under concurrent compute, from
    Chrome-trace ``"ph": "X"`` events (``ts``/``dur`` in us); None when the
    trace has no collective event."""
    spans = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        dur = float(ev.get("dur", 0) or 0)
        if dur <= 0:
            continue
        ts = float(ev.get("ts", 0) or 0)
        spans.append(((ts, ts + dur), str(ev.get("name", "")), ev.get("cat")))
    device = any(cat in _DEVICE_CATS for _, _, cat in spans)
    collectives: List[Tuple[float, float]] = []
    compute: List[Tuple[float, float]] = []
    for span, name, cat in spans:
        if device and cat not in _DEVICE_CATS:
            continue
        if COLLECTIVE_EVENT_RE.search(name):
            collectives.append(span)
        elif cat != "telemetry":
            compute.append(span)
    if not collectives:
        return None
    merged = _merge(compute)
    total = sum(e - s for s, e in collectives)
    hidden = sum(_intersection(c, merged) for c in collectives)
    return min(1.0, hidden / total) if total > 0 else None


def hidden_comm_seconds(overlappable_s: float, exposed_s: float,
                        compute_s: float) -> Dict[str, float]:
    """Analytic overlap of a step whose collectives split into
    ring-decomposed (overlappable) and boundary (exposed) seconds, against
    ``compute_s`` of schedulable compute: ``{hidden_s, exposed_s,
    overlap_fraction}`` with ``hidden_s = min(overlappable_s,
    compute_s)`` and the fraction over the whole collective time."""
    overlappable_s = max(0.0, float(overlappable_s))
    exposed_s = max(0.0, float(exposed_s))
    compute_s = max(0.0, float(compute_s))
    hidden = min(overlappable_s, compute_s)
    total = overlappable_s + exposed_s
    frac = (hidden / total) if total > 0 else None
    return {"hidden_s": hidden,
            "exposed_s": exposed_s + (overlappable_s - hidden),
            "overlap_fraction": frac}
