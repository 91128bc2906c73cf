"""Prometheus text-format export of the telemetry state.

``prometheus_text()`` renders the exposition format (text/plain version
0.0.4) from the process-wide counters, the collective aggregates, and the
current device-memory watermarks — scrape-ready for a node exporter sidecar, or just
diff-able in logs. No HTTP server here: serving one line of text is the
deployment's job; producing it is ours.

Fleet-awareness: pass ``labels={"replica": ..., "rank": ...}`` (or let it
default from the launch env — ``PADDLE_TPU_SERVE_REPLICA`` /
``PADDLE_TRAINER_ID``) and every sample is stamped with them, so N
processes' scrapes aggregate instead of colliding names.  Serving TTFT /
TPOT / latency export as REAL histograms (``_bucket``/``_sum``/``_count``
with ``le`` labels, observations bumped by :class:`SLOMeter` into runtime
counters under ``<base>_hist.*``) — aggregate p99s come from summing
buckets across scrapes, never from averaging per-process percentiles.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from . import runtime
from .collectives import collective_stats
from .memory import hbm_stats
from .recorder import get_flight_recorder

__all__ = ["prometheus_text", "render_histogram"]

_PREFIX = "paddle_tpu"


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _labels_str(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_esc(str(v))}"'
                          for k, v in labels.items()) + "}"


def _metric(lines: List[str], name: str, mtype: str, help_: str,
            samples: List[tuple], base_labels: Optional[dict] = None) -> None:
    """samples: [(labels_dict_or_None, value), ...]"""
    full = f"{_PREFIX}_{name}"
    lines.append(f"# HELP {full} {help_}")
    lines.append(f"# TYPE {full} {mtype}")
    for labels, value in samples:
        merged = dict(base_labels or {})
        if labels:
            merged.update(labels)
        lines.append(f"{full}{_labels_str(merged)} {value}")


def render_histogram(lines: List[str], name: str, help_: str, doc: dict,
                     labels: Optional[dict] = None) -> None:
    """Append one real Prometheus histogram: cumulative ``_bucket`` lines
    with ``le`` labels (``+Inf`` included), then ``_sum`` and ``_count``.
    ``doc`` is a :class:`telemetry.aggregator.Histogram` doc
    (``{"buckets", "counts", "inf", "sum", "count"}``)."""
    full = f"{_PREFIX}_{name}"
    lines.append(f"# HELP {full} {help_}")
    lines.append(f"# TYPE {full} histogram")
    base = dict(labels or {})
    cum = 0
    for ub, c in zip(doc.get("buckets", ()), doc.get("counts", ())):
        cum += int(c)
        lab = _labels_str(dict(base, le=repr(float(ub))))
        lines.append(f"{full}_bucket{lab} {cum}")
    lab = _labels_str(dict(base, le="+Inf"))
    lines.append(f"{full}_bucket{lab} {int(doc.get('count', 0))}")
    lines.append(f"{full}_sum{_labels_str(base)} {doc.get('sum', 0.0)}")
    lines.append(f"{full}_count{_labels_str(base)} "
                 f"{int(doc.get('count', 0))}")


def _env_labels() -> Dict[str, str]:
    """Default sample labels from the launch env: a fleet child scrapes
    self-identified; a bare process (tests, notebooks) stays unlabeled."""
    out: Dict[str, str] = {}
    replica = os.environ.get("PADDLE_TPU_SERVE_REPLICA")
    if replica:
        out["replica"] = replica
    rank = os.environ.get("PADDLE_TRAINER_ID")
    if rank:
        out["rank"] = rank
    return out


def _hist_docs(ctr: Dict[str, float]) -> Dict[str, dict]:
    """Reassemble histogram docs from the ``<base>_hist.*`` counters
    :class:`SLOMeter` bumps (``.bucket.<le>`` / ``.sum`` / ``.count``)."""
    out: Dict[str, dict] = {}
    for key, v in ctr.items():
        if "_hist." not in key:
            continue
        base, _, field = key.partition("_hist.")
        doc = out.setdefault(base, {"buckets": [], "counts": {},
                                    "inf": 0, "sum": 0.0, "count": 0})
        if field.startswith("bucket."):
            try:
                le = float(field.split(".", 1)[1])
            except ValueError:
                continue
            doc["counts"][le] = doc["counts"].get(le, 0) + int(v)
        elif field == "bucket_inf":
            doc["inf"] = int(v)
        elif field == "sum":
            doc["sum"] = float(v)
        elif field == "count":
            doc["count"] = int(v)
    for doc in out.values():
        les = sorted(doc["counts"])
        doc["buckets"] = les
        doc["counts"] = [doc["counts"][le] for le in les]
    return out


def prometheus_text(labels: Optional[dict] = None) -> str:
    base = _env_labels() if labels is None else dict(labels)
    lines: List[str] = []
    ctr = runtime.counters()

    # every emission below goes through the module-level _metric with the
    # process's base labels stamped on (shadowing keeps the body readable)
    mod_metric = globals()["_metric"]

    def _metric(lines_, name, mtype, help_, samples):
        mod_metric(lines_, name, mtype, help_, samples, base_labels=base)

    _metric(lines, "steps_total", "counter", "Training steps metered",
            [(None, int(ctr.get("steps_total", 0)))])
    _metric(lines, "tokens_total", "counter", "Tokens processed",
            [(None, int(ctr.get("tokens_total", 0)))])
    _metric(lines, "samples_total", "counter", "Samples processed",
            [(None, int(ctr.get("samples_total", 0)))])
    _metric(lines, "train_step_calls_total", "counter",
            "Compiled TrainStep invocations",
            [(None, int(ctr.get("train_step_calls_total", 0)))])
    for gauge, help_ in (("tokens_per_second_last", "Last step tokens/s"),
                         ("mfu_last", "Last step achieved MFU"),
                         ("mbu_last", "Last step achieved MBU"),
                         ("step_duration_seconds_last", "Last step duration")):
        if gauge in ctr:
            _metric(lines, gauge, "gauge", help_, [(None, ctr[gauge])])

    coll = collective_stats()
    kinds = sorted(coll)
    _metric(lines, "collective_calls_total", "counter",
            "Executed collectives by kind",
            [({"kind": k}, coll[k]["calls"]) for k in kinds] or [(None, 0)])
    _metric(lines, "collective_bytes_total", "counter",
            "Payload bytes of executed collectives by kind",
            [({"kind": k}, coll[k]["bytes"]) for k in kinds] or [(None, 0)])
    _metric(lines, "collective_wire_seconds_total", "counter",
            "Analytic link wire seconds by kind",
            [({"kind": k}, round(coll[k]["ici_est_s"], 9)) for k in kinds]
            or [(None, 0.0)])
    _metric(lines, "collective_trace_records_total", "counter",
            "Trace-time collective records by kind",
            [({"kind": k}, coll[k]["trace_records"]) for k in kinds]
            or [(None, 0)])

    # device-memory watermarks: per card when the allocator has counters, else a
    # single zero sample so the metric names are stable across backends
    mem = hbm_stats()
    _metric(lines, "hbm_bytes_in_use", "gauge", "Live device-memory bytes per device",
            [({"device": s["device"]}, s["bytes_in_use"]) for s in mem]
            or [(None, 0)])
    _metric(lines, "hbm_peak_bytes", "gauge", "Peak device-memory bytes per device",
            [({"device": s["device"]}, s["peak_bytes_in_use"]) for s in mem]
            or [(None, 0)])
    _metric(lines, "hbm_bytes_limit", "gauge", "Device-memory capacity per device",
            [({"device": s["device"]}, s["bytes_limit"]) for s in mem]
            or [(None, 0)])

    _metric(lines, "flight_recorder_events", "gauge",
            "Events currently in the flight-recorder ring",
            [(None, len(get_flight_recorder()))])
    _metric(lines, "watchdog_timeouts_total", "counter",
            "Comm-watchdog timeouts fired",
            [(None, int(ctr.get("watchdog_timeouts_total", 0)))])

    # fleet fault domain: lease-monitor view of the gang (only present once
    # a monitor has scanned — absent metrics mean "no fault domain here")
    for gauge, help_ in (
            ("fleet_live_ranks", "Ranks with a fresh heartbeat lease"),
            ("fleet_dead_ranks", "Ranks whose heartbeat lease expired"),
            ("fleet_max_step", "Freshest per-step stamp across the gang")):
        if gauge in ctr:
            _metric(lines, gauge, "gauge", help_, [(None, ctr[gauge])])

    # serving SLO surface (absent until a ServingEngine has run; dots are
    # not legal in exposition-format metric names)
    for name, mtype, help_ in (
            ("serving.requests_submitted", "counter", "Requests submitted"),
            ("serving.requests_admitted", "counter",
             "Requests admitted (re-admits after eviction included)"),
            ("serving.requests_finished", "counter", "Requests finished"),
            ("serving.tokens_generated", "counter",
             "Tokens delivered to clients"),
            ("serving.tokens_replayed", "counter",
             "Tokens recomputed by eviction replay"),
            ("serving.evictions", "counter",
             "Mid-flight evictions under KV-pool pressure"),
            ("serving.requests_shed_total", "counter",
             "Queued requests shed (deadline unreachable/expired)"),
            ("serving.requests_rejected_total", "counter",
             "Requests refused at submit (queue full / breaker open)"),
            ("serving.requests_replayed_total", "counter",
             "In-flight requests replayed from the journal after relaunch"),
            ("serving.deadline_misses_total", "counter",
             "Finished requests that missed an attached deadline"),
            ("serving.step_failures_total", "counter",
             "Serving steps that failed transiently and were retried"),
            ("serving.deadline_miss_rate", "gauge",
             "Deadline misses / deadline-carrying finishes (SLO window)"),
            ("serving.queue_depth", "gauge",
             "Requests waiting for admission"),
            ("serving.kv_pool_occupancy", "gauge",
             "Fraction of allocatable KV pages in use"),
            ("serving.fleet_live_replicas", "gauge",
             "Serving replicas with a fresh heartbeat lease"),
            ("serving.fleet_failovers_total", "counter",
             "Replica deaths fenced and failed over by the frontend"),
            ("serving.fleet_requests_replayed_total", "counter",
             "Requests replayed onto survivors after a replica death"),
            ("serving.fleet_handbacks_total", "counter",
             "Queued requests re-homed by drain"),
            ("serving.journal_corrupt_segments", "counter",
             "Serve-journal segments quarantined as corrupt")):
        if name in ctr:
            val = ctr[name] if mtype == "gauge" else int(ctr[name])
            _metric(lines, name.replace(".", "_"), mtype, help_,
                    [(None, val)])

    # per-replica queue depth, labeled by replica name (fleet frontend)
    qd = sorted((k.split(".", 1)[1].split("fleet_queue_depth.", 1)[1], v)
                for k, v in ctr.items()
                if k.startswith("serving.fleet_queue_depth."))
    if qd:
        _metric(lines, "serving_fleet_queue_depth", "gauge",
                "Queue depth per serving replica (from its lease payload)",
                [({"replica": name}, v) for name, v in qd])

    # kernel gate rejections, labeled by kernel and reason — a silent
    # plain-path fallback must be visible on the scrape, not just in a
    # bench regression
    fb = sorted((k.split(".", 2), v) for k, v in ctr.items()
                if k.startswith("kernel_fallback.") and k.count(".") == 2)
    if "kernel_fallback.total" in ctr:
        _metric(lines, "kernel_fallback_total", "counter",
                "Kernel gate rejections (fell back to the plain path)",
                [({"kernel": parts[1], "reason": parts[2]}, int(v))
                 for parts, v in fb]
                or [(None, int(ctr["kernel_fallback.total"]))])

    # serving SLO histograms (real _bucket/_sum/_count series): SLOMeter
    # bumps observations into `serving.<kind>_hist.*` counters; reassemble
    # and render them so a fleet scrape can merge buckets, not percentiles
    for base_key, doc in sorted(_hist_docs(ctr).items()):
        name = base_key.replace(".", "_") + "_seconds"
        render_histogram(lines, name,
                         f"Observed {base_key.split('.')[-1]} distribution",
                         doc, labels=base)
    return "\n".join(lines) + "\n"
