"""Job-level metrics aggregation: ranks/replicas push, the launcher rolls up.

Each process's telemetry is its own; the fleet's interesting numbers are not.
This module is the plane between them, in three parts:

- :class:`Histogram` — fixed-bucket latency histogram with *mergeable*
  counts.  Aggregate percentiles are computed from the **merged buckets**
  (sum the counts, then walk the cumulative distribution) — never by
  averaging per-replica percentiles, which is statistically meaningless.
- :class:`MetricsPusher` — a daemon thread each rank/replica runs: every
  ``PADDLE_TPU_METRICS_PUSH_S`` seconds (default 10) it snapshots its
  local meters (``SLOMeter.summary()`` / ``StepMeter`` rates / runtime
  counters + histograms), stamps the snapshot with
  :func:`runtime.identity`, and pushes it to the depot.  It also spills
  the flight-recorder ring to a stable per-process file in the epoch dir,
  so a SIGKILL'd replica still leaves its spans for
  :func:`blackbox.merge` to fold.
- :func:`rollup` — the launcher-side fold over pulled snapshots: fleet
  req/s (sum), aggregate p99 TTFT/TPOT/latency (merged histograms),
  per-rank step-time skew naming the straggler (cross-checked against the
  :class:`LeaseMonitor`'s ``fleet_straggler`` verdict), MFU spread, and
  exact summed counters.  :func:`prometheus_rollup_text` renders the
  rollup in scrape-ready exposition format; ``python -m
  paddle_tpu_torch.telemetry.report`` prints it as a text dashboard.

Transport: the depot rides the existing launcher infrastructure — the
framed-TCP :class:`SnapshotStore`/:class:`SnapshotClient` pair grew
``metrics_push``/``metrics_pull`` commands, and :class:`KVTransport` (the
fleet-store fallback) mirrors the same two methods, so any object with
``metrics_push(src, doc)`` + ``metrics_pull()`` works.  This module is
stdlib-only (like ``fault_domain.py``): it never imports torch and only
lazily touches sibling telemetry modules.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["Histogram", "DEFAULT_BUCKETS", "MetricsPusher", "MemoryDepot",
           "push_interval_s", "local_snapshot", "rollup",
           "prometheus_rollup_text", "start_metrics_pusher"]

# seconds; spans sub-ms CPU-lane TTFTs up through minute-scale tails.
# The +Inf bucket is implicit (count - cum(last)).
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def push_interval_s(default: float = 10.0) -> float:
    try:
        return float(os.environ.get("PADDLE_TPU_METRICS_PUSH_S", default))
    except (TypeError, ValueError):
        return default


class Histogram:
    """Fixed-bucket histogram with mergeable counts.

    ``buckets`` are upper bounds (``le``) in ascending order; observations
    above the last bound land in the implicit +Inf bucket.  ``merge``
    requires identical bucket layouts (schema is part of the doc, so a
    depot fed by heterogeneous pushers fails loudly, not silently).
    """

    __slots__ = ("buckets", "counts", "inf", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be ascending")
        self.counts = [0] * len(self.buckets)
        self.inf = 0
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                return
        self.inf += 1

    def merge(self, other: "Histogram") -> "Histogram":
        if isinstance(other, dict):
            other = Histogram.from_doc(other)
        if other.buckets != self.buckets:
            raise ValueError("cannot merge histograms with different "
                             f"buckets: {other.buckets} vs {self.buckets}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.inf += other.inf
        self.sum += other.sum
        self.count += other.count
        return self

    def percentile(self, q: float) -> Optional[float]:
        """Aggregate quantile from the cumulative bucket counts, linearly
        interpolated inside the bucket containing the rank (the classic
        Prometheus ``histogram_quantile`` estimate: exact to within one
        bucket's width).  ``q`` in percent (p99 -> 99)."""
        if self.count == 0:
            return None
        rank = (q / 100.0) * self.count
        cum = 0
        lo = 0.0
        for i, ub in enumerate(self.buckets):
            c = self.counts[i]
            if cum + c >= rank and c > 0:
                frac = (rank - cum) / c
                return lo + (ub - lo) * min(max(frac, 0.0), 1.0)
            cum += c
            lo = ub
        # rank lands in +Inf: the best honest answer is the last finite
        # bound (we know nothing about the tail's shape)
        return self.buckets[-1] if self.buckets else None

    def to_doc(self) -> Dict[str, Any]:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "inf": self.inf, "sum": self.sum, "count": self.count}

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "Histogram":
        h = cls(doc.get("buckets", DEFAULT_BUCKETS))
        counts = list(doc.get("counts", ()))
        if len(counts) != len(h.buckets):
            raise ValueError("histogram doc counts/buckets length mismatch")
        h.counts = [int(c) for c in counts]
        h.inf = int(doc.get("inf", 0))
        h.sum = float(doc.get("sum", 0.0))
        h.count = int(doc.get("count", 0))
        return h

    @classmethod
    def merged(cls, docs: Sequence[Any]) -> Optional["Histogram"]:
        """Merge histogram docs/instances; None when nothing to merge."""
        out: Optional[Histogram] = None
        for d in docs:
            if d is None:
                continue
            h = d if isinstance(d, Histogram) else cls.from_doc(d)
            if out is None:
                out = cls(h.buckets)
            out.merge(h)
        return out


# -- snapshots ---------------------------------------------------------------

def local_snapshot(slo_summary: Optional[dict] = None,
                   step_summary: Optional[dict] = None,
                   hists: Optional[Dict[str, Any]] = None,
                   extra: Optional[dict] = None) -> Dict[str, Any]:
    """One push document: self-identifying (rank/replica/pid), wall-
    stamped, carrying the local meters' summaries, runtime counters and
    histogram docs.  Everything optional — a trainer pushes step_summary,
    a serving replica slo_summary."""
    from . import runtime

    doc: Dict[str, Any] = dict(runtime.identity())
    doc["wall_time"] = time.time()
    doc["counters"] = runtime.counters()
    if slo_summary is not None:
        doc["slo"] = dict(slo_summary)
    if step_summary is not None:
        doc["step"] = dict(step_summary)
    if hists:
        doc["hists"] = {k: (h.to_doc() if isinstance(h, Histogram) else
                            dict(h)) for k, h in hists.items()}
    if extra:
        doc.update(extra)
    return doc


def _source_name(doc: Dict[str, Any]) -> str:
    if doc.get("replica"):
        return str(doc["replica"])
    if doc.get("rank") is not None:
        return f"rank{doc['rank']}"
    return f"pid{doc.get('pid', '?')}"


class MemoryDepot:
    """In-process depot double (tests; single-process launches): the same
    ``metrics_push``/``metrics_pull`` surface the SnapshotClient and
    KVTransport grew, minus the wire."""

    def __init__(self):
        self._lock = threading.Lock()
        self._docs: Dict[str, Dict[str, Any]] = {}

    def metrics_push(self, src: str, doc: Dict[str, Any]) -> None:
        # round-trip through JSON so tests see exactly what the wire sees
        with self._lock:
            self._docs[str(src)] = json.loads(json.dumps(doc))

    def metrics_pull(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._docs.items()}


class MetricsPusher(threading.Thread):
    """Per-process push loop: every interval, build a snapshot from the
    registered sources and push it; optionally spill the flight recorder
    to a stable file in the epoch dir (the black box a SIGKILL can't
    erase).  ``push_once()`` is the deterministic entry tests (and
    shutdown paths) call directly; push failures are counted, never
    raised — losing a metrics beat must not hurt serving."""

    def __init__(self, transport=None,
                 slo_source: Optional[Callable[[], dict]] = None,
                 step_source: Optional[Callable[[], dict]] = None,
                 hists_source: Optional[Callable[[], Dict[str, Any]]] = None,
                 *, src: Optional[str] = None,
                 epoch_dir: Optional[str] = None,
                 interval_s: Optional[float] = None):
        super().__init__(daemon=True, name="paddle-tpu-metrics-push")
        self.transport = transport
        self.slo_source = slo_source
        self.step_source = step_source
        self.hists_source = hists_source
        self.epoch_dir = epoch_dir if epoch_dir is not None else \
            os.environ.get("PADDLE_TPU_EPOCH_DIR")
        self.interval_s = push_interval_s() if interval_s is None \
            else float(interval_s)
        self._src = src
        self._stop = threading.Event()
        self.pushes = 0
        self.push_failures = 0

    @property
    def src(self) -> str:
        if self._src is None:
            from . import runtime

            self._src = _source_name(runtime.identity())
        return self._src

    def snapshot(self) -> Dict[str, Any]:
        def _call(fn):
            if fn is None:
                return None
            try:
                return fn()
            except Exception:
                return None

        return local_snapshot(slo_summary=_call(self.slo_source),
                              step_summary=_call(self.step_source),
                              hists=_call(self.hists_source))

    def push_once(self) -> bool:
        ok = True
        if self.transport is not None:
            try:
                self.transport.metrics_push(self.src, self.snapshot())
                self.pushes += 1
            except Exception:
                self.push_failures += 1
                ok = False
        self.spill_blackbox()
        return ok

    def spill_blackbox(self) -> Optional[str]:
        """Overwrite this process's black-box file in the epoch dir with
        the current flight-recorder ring.  A stable name (no timestamp)
        on purpose: the newest spill supersedes the previous one, and a
        replica SIGKILL'd between beats still leaves its last ring."""
        if not self.epoch_dir:
            return None
        try:
            from . import recorder

            os.makedirs(self.epoch_dir, exist_ok=True)
            path = os.path.join(self.epoch_dir,
                                f"flight_{self.src}_periodic.json")
            tmp = path + ".tmp"
            out = recorder.get_flight_recorder().dump(tmp, reason="periodic")
            if out:
                os.replace(tmp, path)
                return path
        except Exception:
            pass
        return None

    def run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.push_once()

    def stop(self, final_push: bool = True) -> None:
        self._stop.set()
        if final_push:
            self.push_once()


def start_metrics_pusher(transport=None, engine=None, step_meter=None,
                         **kw) -> MetricsPusher:
    """Wire a pusher to a serving engine's SLOMeter and/or a StepMeter and
    start it.  Convenience for ``run_replica`` / training loops."""
    slo = hists = step = None
    if engine is not None:
        slo = engine.meter.summary
        hists = getattr(engine.meter, "hist_docs", None)
    if step_meter is not None:
        step = step_meter.summary
    p = MetricsPusher(transport, slo_source=slo, step_source=step,
                      hists_source=hists, **kw)
    p.start()
    return p


# -- launcher-side rollup ----------------------------------------------------

_HIST_KINDS = ("ttft_s", "tpot_s", "latency_s")


def rollup(snapshots: Dict[str, Dict[str, Any]],
           monitor_stragglers: Optional[Sequence[int]] = None
           ) -> Dict[str, Any]:
    """Fold pulled snapshots into the job view.

    - ``fleet_agg_req_s`` / ``requests_finished_total``: exact sums over
      per-replica SLO summaries.
    - ``ttft_p99_agg_ms`` (and tpot/latency): p99 of the *merged*
      histograms — never an average of per-replica p99s.
    - ``step_skew`` / ``straggler``: per-rank mean step time spread; the
      slowest rank is named, and ``straggler_confirmed`` records whether
      the LeaseMonitor's ``fleet_straggler`` scan agrees (cross-check, so
      a skew blip and a wedged rank are distinguishable).
    - ``mfu_min/max/spread`` over pushing ranks.
    - ``autoscale``: the newest autoscaler self-report (replica states,
      occupancy, last decision) — latest ``wall_time`` wins, so a stale
      doc from a dead controller never shadows the live one.
    - ``disagg``: the newest frontend disaggregation self-report (prefix
      hit rate, per-tier occupancy, prefill-tier route/fallback totals);
      same latest-``wall_time``-wins fold.
    """
    out: Dict[str, Any] = {"wall_time": time.time(),
                           "sources": sorted(snapshots),
                           "replicas": [], "ranks": []}
    req_s = 0.0
    finished = shed = rejected = 0
    merged: Dict[str, Optional[Histogram]] = {k: None for k in _HIST_KINDS}
    step_dt: Dict[str, float] = {}
    mfu: Dict[str, float] = {}
    autoscale_wall = float("-inf")
    disagg_wall = float("-inf")
    for src, doc in sorted(snapshots.items()):
        if doc.get("autoscale"):
            wall = float(doc.get("wall_time") or 0.0)
            if wall >= autoscale_wall:
                autoscale_wall = wall
                out["autoscale"] = dict(doc["autoscale"])
        if doc.get("disagg"):
            wall = float(doc.get("wall_time") or 0.0)
            if wall >= disagg_wall:
                disagg_wall = wall
                out["disagg"] = dict(doc["disagg"])
        slo = doc.get("slo") or {}
        if slo:
            out["replicas"].append(src)
            req_s += float(slo.get("requests_per_sec") or 0.0)
            finished += int(slo.get("requests_finished") or 0)
            shed += int(slo.get("requests_shed") or 0)
            rejected += int(slo.get("requests_rejected") or 0)
        for kind, h in (doc.get("hists") or {}).items():
            if kind in merged and h:
                cur = Histogram.from_doc(h)
                merged[kind] = cur if merged[kind] is None \
                    else merged[kind].merge(cur)
        step = doc.get("step") or {}
        if step:
            out["ranks"].append(src)
            steps, total = step.get("steps"), step.get("total_s")
            if steps and total:
                step_dt[src] = float(total) / float(steps)
            if step.get("mfu") is not None:
                mfu[src] = float(step["mfu"])
    out["fleet_agg_req_s"] = round(req_s, 3)
    out["requests_finished_total"] = finished
    out["requests_shed_total"] = shed
    out["requests_rejected_total"] = rejected
    for kind, h in merged.items():
        key = kind[:-2] if kind.endswith("_s") else kind
        p99 = h.percentile(99) if h is not None else None
        p50 = h.percentile(50) if h is not None else None
        out[f"{key}_p99_agg_ms"] = None if p99 is None \
            else round(p99 * 1e3, 3)
        out[f"{key}_p50_agg_ms"] = None if p50 is None \
            else round(p50 * 1e3, 3)
        if h is not None:
            out.setdefault("hists", {})[kind] = h.to_doc()
    if step_dt:
        slowest = max(step_dt, key=step_dt.get)
        fastest = min(step_dt.values())
        out["step_time_mean_s"] = round(
            sum(step_dt.values()) / len(step_dt), 6)
        out["step_skew"] = round(step_dt[slowest] / fastest - 1.0, 4) \
            if fastest > 0 else None
        out["straggler"] = slowest
        if monitor_stragglers is not None:
            named = {f"rank{r}" for r in monitor_stragglers} \
                | {str(r) for r in monitor_stragglers}
            out["straggler_confirmed"] = slowest in named
    if mfu:
        out["mfu_min"] = round(min(mfu.values()), 6)
        out["mfu_max"] = round(max(mfu.values()), 6)
        out["mfu_spread"] = round(out["mfu_max"] - out["mfu_min"], 6)
    return out


def prometheus_rollup_text(snapshots: Dict[str, Dict[str, Any]],
                           monitor_stragglers: Optional[Sequence[int]] = None
                           ) -> str:
    """Job-level Prometheus exposition: summed fleet counters, the merged
    TTFT/TPOT/latency histograms (real ``_bucket``/``_sum``/``_count``
    series), and per-source labeled gauges so replica lines never collide."""
    from .prometheus import render_histogram, _esc

    agg = rollup(snapshots, monitor_stragglers=monitor_stragglers)
    lines: List[str] = []

    def gauge(name, help_, samples):
        lines.append(f"# HELP paddle_tpu_{name} {help_}")
        lines.append(f"# TYPE paddle_tpu_{name} gauge")
        for labels, v in samples:
            if v is None:
                continue
            lab = "" if not labels else "{" + ",".join(
                f'{k}="{_esc(str(x))}"' for k, x in sorted(labels.items())) \
                + "}"
            lines.append(f"paddle_tpu_{name}{lab} {v}")

    gauge("fleet_requests_per_second",
          "Aggregate finished-request rate across the fleet",
          [(None, agg.get("fleet_agg_req_s"))])
    gauge("fleet_requests_finished_total",
          "Sum of per-replica finished requests",
          [(None, agg.get("requests_finished_total"))])
    for kind in _HIST_KINDS:
        doc = (agg.get("hists") or {}).get(kind)
        if doc:
            render_histogram(lines, f"fleet_{kind.rsplit('_', 1)[0]}_seconds",
                             f"Merged fleet {kind} histogram", doc)
    if agg.get("step_skew") is not None:
        gauge("fleet_step_time_skew",
              "Slowest/fastest mean step-time ratio minus one",
              [(None, agg["step_skew"])])
    per_src = []
    for src, doc in sorted(snapshots.items()):
        slo = doc.get("slo") or {}
        if slo.get("requests_per_sec") is not None:
            per_src.append(({"replica": src}, slo["requests_per_sec"]))
    if per_src:
        gauge("fleet_replica_requests_per_second",
              "Per-replica finished-request rate", per_src)
    mfus = [({"source": src}, (doc.get("step") or {}).get("mfu"))
            for src, doc in sorted(snapshots.items())
            if (doc.get("step") or {}).get("mfu") is not None]
    if mfus:
        gauge("fleet_mfu", "Per-rank achieved MFU", mfus)
    return "\n".join(lines) + "\n"
