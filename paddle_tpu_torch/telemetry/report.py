"""``python -m paddle_tpu_torch.telemetry.report`` — the job dashboard CLI.

Pulls every rank/replica's pushed snapshot from the metrics depot
(``--depot host:port``, default ``$PADDLE_TPU_SNAP_STORE``), folds them
with :func:`aggregator.rollup`, and prints a text dashboard: fleet req/s,
merged-histogram p99 TTFT/TPOT/latency, per-rank step-time skew with the
straggler named, MFU spread, per-source lines.  ``--prometheus`` prints
the job-level exposition text instead; ``--blackbox DIR`` additionally
merges the epoch dir's flight-recorder dumps and summarizes the timeline.

``--smoke`` runs the whole pipeline against two synthetic in-process
snapshots (no network, no card) — the suite exercises it so the CLI can't
rot.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional

from .aggregator import (Histogram, MemoryDepot, local_snapshot, rollup,
                         prometheus_rollup_text)

__all__ = ["main", "dashboard_text"]


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def dashboard_text(snapshots: Dict[str, Dict[str, Any]],
                   agg: Optional[Dict[str, Any]] = None) -> str:
    agg = rollup(snapshots) if agg is None else agg
    lines = ["== paddle_tpu job rollup =="]
    lines.append(f"sources: {', '.join(agg['sources']) or '(none pushed)'}")
    if agg["replicas"]:
        lines.append(
            f"fleet: req/s={_fmt(agg['fleet_agg_req_s'])} "
            f"finished={agg['requests_finished_total']} "
            f"shed={agg['requests_shed_total']} "
            f"rejected={agg['requests_rejected_total']}")
        lines.append(
            "agg p99 (merged hist): "
            f"ttft={_fmt(agg.get('ttft_p99_agg_ms'))}ms "
            f"tpot={_fmt(agg.get('tpot_p99_agg_ms'))}ms "
            f"latency={_fmt(agg.get('latency_p99_agg_ms'))}ms")
    auto = agg.get("autoscale")
    if auto:
        serving = int(auto.get("serving") or 0)
        warming = int(auto.get("warming") or 0)
        draining = int(auto.get("draining") or 0)
        degraded = int(auto.get("degraded") or 0)
        lines.append(
            f"autoscale: replicas={serving + warming} "
            f"(SERVING={serving} WARMING={warming} DRAINING={draining} "
            f"DEGRADED={degraded}) "
            f"occupancy={_fmt(auto.get('occupancy'))} "
            f"out={auto.get('scale_out_total', 0)} "
            f"in={auto.get('scale_in_total', 0)}")
        last = auto.get("last_decision")
        if last:
            lines.append(
                f"  last decision: {last.get('direction')} -> "
                f"target={last.get('target')} ({last.get('reason')})")
        states = auto.get("states") or {}
        if states:
            lines.append("  states: " + " ".join(
                f"{n}={s}" for n, s in sorted(states.items())))
    dis = agg.get("disagg")
    if dis:
        tiers = dis.get("tier_occupancy") or {}
        tier_txt = " ".join(f"{t}={_fmt(o)}"
                            for t, o in sorted(tiers.items())) or "-"
        lines.append(
            f"disagg: prefix_hit_rate={_fmt(dis.get('prefix_hit_rate'))} "
            f"tier_occupancy: {tier_txt} "
            f"prefill_routed={dis.get('prefill_routed_total', 0)} "
            f"fallbacks={dis.get('prefill_fallbacks_total', 0)}")
    if agg["ranks"]:
        straggler = agg.get("straggler")
        conf = agg.get("straggler_confirmed")
        tail = "" if conf is None else \
            (" (lease-monitor confirmed)" if conf else " (unconfirmed)")
        lines.append(
            f"steps: mean={_fmt(agg.get('step_time_mean_s'))}s "
            f"skew={_fmt(agg.get('step_skew'))} "
            f"straggler={straggler}{tail}")
        if agg.get("mfu_spread") is not None:
            lines.append(f"mfu: min={_fmt(agg['mfu_min'])} "
                         f"max={_fmt(agg['mfu_max'])} "
                         f"spread={_fmt(agg['mfu_spread'])}")
    lines.append("-- per source --")
    for src, doc in sorted(snapshots.items()):
        slo = doc.get("slo") or {}
        step = doc.get("step") or {}
        if slo:
            lines.append(
                f"  {src}: req/s={_fmt(slo.get('requests_per_sec'))} "
                f"finished={_fmt(slo.get('requests_finished'))} "
                f"p99 ttft={_fmt(slo.get('ttft_ms_p99'))}ms "
                f"latency={_fmt(slo.get('latency_ms_p99'))}ms "
                f"tpot_ema={_fmt(slo.get('tpot_ema_ms'))}ms")
        if step:
            lines.append(
                f"  {src}: steps={_fmt(step.get('steps'))} "
                f"total={_fmt(step.get('total_s'))}s "
                f"mfu={_fmt(step.get('mfu'))}")
        if not slo and not step:
            lines.append(f"  {src}: counters only")
    return "\n".join(lines)


def _smoke_snapshots() -> Dict[str, Dict[str, Any]]:
    """Two synthetic pushers through a real (in-memory) depot."""
    depot = MemoryDepot()
    for i, name in enumerate(("r0", "r1")):
        h = Histogram()
        for k in range(20):
            h.observe(0.002 * (i + 1) * (1 + k % 5))
        depot.metrics_push(name, local_snapshot(
            slo_summary={"requests_per_sec": 2.0 + i,
                         "requests_finished": 10 * (i + 1),
                         "requests_shed": 0, "requests_rejected": 0,
                         "ttft_ms_p99": 4.0 + i, "latency_ms_p99": 40.0,
                         "tpot_ema_ms": 5.0 + 10.0 * i},
            hists={"ttft_s": h},
            extra={"replica": name}))
    depot.metrics_push("autoscaler", local_snapshot(extra={
        "autoscale": {"serving": 1, "warming": 1, "draining": 0,
                      "degraded": 1,
                      "occupancy": 0.62, "queue_depth": 5,
                      "scale_out_total": 1, "scale_in_total": 0,
                      "last_decision": {"direction": "out", "target": 2,
                                        "reason": "occupancy_high"},
                      "states": {"r0": "SERVING", "r1": "WARMING",
                                 "r2": "DEGRADED"}}}))
    depot.metrics_push("frontend", local_snapshot(extra={
        "disagg": {"prefix_hit_rate": 0.4,
                   "tier_occupancy": {"decode": 0.3, "prefill": 0.7},
                   "prefill_routed_total": 3,
                   "prefill_fallbacks_total": 1}}))
    depot.metrics_push("rank0", local_snapshot(
        step_summary={"steps": 8, "total_s": 4.0, "mfu": 0.41},
        extra={"rank": 0}))
    depot.metrics_push("rank1", local_snapshot(
        step_summary={"steps": 8, "total_s": 5.0, "mfu": 0.33},
        extra={"rank": 1}))
    return depot.metrics_pull()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.telemetry.report",
        description="Job-level metrics dashboard from the metrics depot")
    ap.add_argument("--depot", default=None,
                    help="host:port of the launcher's SnapshotStore "
                         "(default: $PADDLE_TPU_SNAP_STORE)")
    ap.add_argument("--prometheus", action="store_true",
                    help="print job-level Prometheus exposition text")
    ap.add_argument("--json", action="store_true",
                    help="print the raw rollup as JSON")
    ap.add_argument("--blackbox", metavar="DIR", default=None,
                    help="also merge flight-recorder dumps under DIR")
    ap.add_argument("--smoke", action="store_true",
                    help="run against synthetic snapshots (no network)")
    args = ap.parse_args(argv)

    if args.smoke:
        snapshots = _smoke_snapshots()
    else:
        import os

        from ..distributed.checkpoint.replicator import SnapshotClient

        addr = args.depot or os.environ.get("PADDLE_TPU_SNAP_STORE")
        if not addr:
            print("no depot: pass --depot host:port or set "
                  "PADDLE_TPU_SNAP_STORE (or use --smoke)",
                  file=sys.stderr)
            return 2
        try:
            snapshots = SnapshotClient.from_address(addr).metrics_pull()
        except OSError as e:
            print(f"depot {addr} unreachable: {e}", file=sys.stderr)
            return 2

    if args.prometheus:
        sys.stdout.write(prometheus_rollup_text(snapshots))
    elif args.json:
        print(json.dumps(rollup(snapshots), indent=1, default=repr))
    else:
        print(dashboard_text(snapshots))

    if args.blackbox:
        from . import blackbox

        merged = blackbox.merge(args.blackbox)
        print(f"blackbox: {len(merged['processes'])} dumps, "
              f"{len(merged['events'])} events -> {merged.get('path')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
