"""The port's request tracing, metrics aggregation, black box and report
(``telemetry/tracing.py``, ``aggregator.py``, ``blackbox.py``,
``report.py``) against the JAX package's, on the CPU.

- The reference's ``tests/test_tracing.py`` unit classes run on the port
  through ``port_reference``: trace ids, the histogram, span propagation
  through the journal, hand-backs and fail-overs, the engine's spans, the
  aggregator over the depot, the black-box merge, the report CLI (its one
  subprocess runs ``python -m paddle_tpu_torch.telemetry.report``) and the
  recorder's dump path.  Its SIGKILL chaos run (``TestTraceChaosE2E``) is
  left out: the unit classes hold its verdict.
- The same inputs give the reference's roll-up, Prometheus roll-up text,
  merged timeline, chrome-trace events, trace coverage and histogram
  percentiles.
"""

import json

import numpy as np
import pytest
import torch

from paddle_tpu import telemetry as jtel
from paddle_tpu.telemetry import aggregator as jagg
from paddle_tpu.telemetry import blackbox as jbb
from paddle_tpu.telemetry import report as jreport
from paddle_tpu.telemetry import tracing as jtr

from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.telemetry import aggregator as tagg
from paddle_tpu_torch.telemetry import blackbox as tbb
from paddle_tpu_torch.telemetry import report as treport
from paddle_tpu_torch.telemetry import tracing as ttr

from test_torch_telemetry import _port_on_cpu, port_reference  # noqa: F401

torch.set_num_threads(1)

port_reference("test_tracing", globals(), drop=("TestTraceChaosE2E",))


def _snapshots(agg, seed):
    """A depot of pushed snapshots built from one seed: replicas with
    histograms, ranks with step summaries, an autoscaler and a frontend."""
    rng = np.random.default_rng(seed)
    depot = agg.MemoryDepot()
    for i in range(3):
        h = agg.Histogram()
        for v in rng.exponential(0.05 * (i + 1), 40):
            h.observe(float(v))
        t = agg.Histogram()
        for v in rng.exponential(0.01, 30):
            t.observe(float(v))
        doc = {"replica": f"r{i}", "pid": 100 + i, "wall_time": 10.0 + i, "counters": {},
               "slo": {"requests_per_sec": float(rng.random() * 4),
                       "requests_finished": int(rng.integers(1, 50)),
                       "requests_shed": int(rng.integers(0, 3)), "requests_rejected": 0},
               "hists": {"ttft_s": h.to_doc(), "tpot_s": t.to_doc()}}
        depot.metrics_push(f"r{i}", doc)
    for r in range(2):
        depot.metrics_push(f"rank{r}", {"rank": r, "wall_time": 11.0, "counters": {},
                                        "step": {"steps": 8, "total_s": 4.0 + r,
                                                 "mfu": 0.4 - 0.05 * r}})
    depot.metrics_push("autoscaler", {"wall_time": 12.0, "autoscale": {
        "serving": 2, "warming": 1, "draining": 0, "degraded": 0, "occupancy": 0.5,
        "queue_depth": 3, "scale_out_total": 1, "scale_in_total": 0,
        "last_decision": {"direction": "out", "target": 3, "reason": "occupancy_high"},
        "states": {"r0": "SERVING", "r1": "SERVING", "r2": "WARMING"}}})
    depot.metrics_push("frontend", {"wall_time": 12.5, "disagg": {
        "prefix_hit_rate": 0.25, "tier_occupancy": {"decode": 0.5},
        "prefill_routed_total": 2, "prefill_fallbacks_total": 0}})
    return depot.metrics_pull()


def _strip_wall(d):
    return {k: v for k, v in d.items() if k != "wall_time"}


@pytest.mark.parametrize("seed", range(4))
def test_rollup_and_its_text_equal_the_reference(seed):
    mine, theirs = _snapshots(tagg, seed), _snapshots(jagg, seed)
    assert mine == theirs
    for stragglers in (None, [1], [0]):
        assert _strip_wall(tagg.rollup(mine, monitor_stragglers=stragglers)) == \
            _strip_wall(jagg.rollup(theirs, monitor_stragglers=stragglers))
        assert tagg.prometheus_rollup_text(mine, monitor_stragglers=stragglers) == \
            jagg.prometheus_rollup_text(theirs, monitor_stragglers=stragglers)
    assert treport.dashboard_text(mine).replace("paddle_tpu_torch", "paddle_tpu") == \
        jreport.dashboard_text(theirs)


@pytest.mark.parametrize("q", [1, 25, 50, 90, 99, 99.9])
def test_histogram_percentiles_equal_the_reference(q):
    vals = np.random.default_rng(int(q * 10)).lognormal(-3, 1.5, 500)
    a, b = ttel.Histogram(), jtel.Histogram()
    for v in vals:
        a.observe(float(v))
        b.observe(float(v))
    assert a.to_doc() == b.to_doc()
    assert a.percentile(q) == b.percentile(q)
    assert ttel.Histogram.merged([a, a.to_doc()]).to_doc() == \
        jtel.Histogram.merged([b, b.to_doc()]).to_doc()


def _dumps(tmp, rng):
    """Three processes' dumps with skewed wall clocks, ships and folds."""
    tid = "ab" * 8
    for i, (name, skew) in enumerate((("r0", 0.0), ("r1", 5.0), ("fe", -3.0))):
        evs = []
        for k in range(6):
            mono = float(k + i * 0.3 + rng.random() * 0.1)
            evs.append({"kind": ["serve_submit", "serve_admit", "fleet_ship", "serve_token",
                                 "fleet_fold", "serve_finish"][k],
                        "name": name if k in (2, 4) else str(k), "ts": 100.0 + mono + skew,
                        "mono_ns": int(mono * 1e9), "trace": tid, "epoch": 1, "seq": 0,
                        "high_seq": 0})
        with open(tmp / f"flight_{name}.json", "w") as f:
            json.dump({"reason": "t", "host": "h", "pid": i, "identity": {"replica": name},
                       "events": evs}, f)


def test_blackbox_merge_equals_the_reference(tmp_path):
    _dumps(tmp_path, np.random.default_rng(3))
    mine = tbb.merge(str(tmp_path), out_path=str(tmp_path / "mine.json"))
    theirs = jbb.merge(str(tmp_path), out_path=str(tmp_path / "theirs.json"))
    for d in (mine, theirs):
        d.pop("path", None)
    assert mine == theirs
    assert tbb.order_events({"a": [{"ts": 1.0, "mono_ns": 1, "kind": "x", "name": "y"}]}) == \
        jbb.order_events({"a": [{"ts": 1.0, "mono_ns": 1, "kind": "x", "name": "y"}]})


def test_trace_helpers_equal_the_reference():
    rng = np.random.default_rng(0)
    tids = [ttr.mint() for _ in range(3)]
    evs = []
    for i, kind in enumerate(["serve_submit", "serve_admit", "serve_first_token",
                              "serve_token", "serve_finish"] * 3):
        t = tids[i % 3]
        if kind == "serve_admit" and t == tids[2]:
            continue      # a lost waypoint: that trace's chain is incomplete
        evs.append({"kind": kind, "name": str(i % 3), "trace": t, "mono_ns": 1000 * i,
                    "ts": float(i), "x": int(rng.integers(0, 9))})
    evs.append({"kind": "step", "name": "s", "mono_ns": 5, "ts": 0.0})
    assert ttr.spans(evs) == jtr.spans(evs)
    assert ttr.spans(evs, tids[1]) == jtr.spans(evs, tids[1])
    assert ttr.trace_ids(evs) == jtr.trace_ids(evs) == tids
    assert ttr.trace_coverage(evs) == jtr.trace_coverage(evs) == pytest.approx(2 / 3)
    assert ttr.trace_coverage(evs, finished_rids=[0, 1]) == \
        jtr.trace_coverage(evs, finished_rids=[0, 1])
    assert ttr.chrome_trace_events(evs, pid=7) == jtr.chrome_trace_events(evs, pid=7)
    assert ttr.mint(tids[0]) == jtr.mint(tids[0]) == tids[0]
    assert len(ttr.mint()) == 16 and ttr.TRACE_KEY == jtr.TRACE_KEY
