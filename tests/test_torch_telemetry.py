"""The port's telemetry against the JAX package's, on the CPU: the
collective recording and its cost model, traced programs, the flight
recorder and the watchdog's dump, the Prometheus text, the kernel-fallback
events of the decode gate.

It also holds :func:`port_reference`, which the other A8 files use to run
the reference's own unit classes on the port: the reference test module's
source with its imports of ``paddle_tpu`` pointed at ``paddle_tpu_torch``
(and the listed substitutions where a case reads JAX), executed into the
calling test module, so that the same inputs, fake clocks and assertions
run through the port.  Models there are built on the CPU
(``set_device("cpu")`` before any module fixture).
"""

import json
import os
import re
import time

import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import telemetry as jtel
from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_sharded_supported as jax_sharded_supported

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.distributed import CommWatchdog
from paddle_tpu_torch.ops.decode_attention import decode_attention_sharded_supported

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))


def port_reference(name: str, namespace: dict, *, drop=(), subs=(), own_globals=False) -> None:
    """Run the reference test module ``tests/<name>.py`` on the port: its
    ``paddle_tpu`` imports and ``-m paddle_tpu.`` entry points name
    ``paddle_tpu_torch``; ``subs`` are further ``(old, new)`` replacements
    (each must match); its classes named in ``drop`` are left out.  With
    ``own_globals`` the module runs in a namespace of its own and only its
    ``Test*`` classes join ``namespace`` (its helpers keep their names
    apart from another replayed module's)."""
    src = open(os.path.join(TESTS, name + ".py")).read()
    src = re.sub(r"\bpaddle_tpu(?=\.|\s+as\b|\s*$|\s*\n|,)", "paddle_tpu_torch", src)
    for old, new in subs:
        assert old in src, (name, old)
        src = src.replace(old, new)
    target = {"__file__": namespace["__file__"], "__name__": namespace["__name__"]} \
        if own_globals else namespace
    exec(compile(src, os.path.join(TESTS, name + ".py") + " [port]", "exec"), target)
    for cls in drop:
        del target[cls]
    if own_globals:
        namespace.update({k: v for k, v in target.items()
                          if k.startswith("Test") and isinstance(v, type)})


@pytest.fixture(scope="module", autouse=True)
def _port_on_cpu():
    ptt.set_device("cpu")
    yield


@pytest.fixture(autouse=True)
def fresh_telemetry():
    telemetry.reset()
    jtel.reset()
    yield
    telemetry.reset()
    jtel.reset()


def _stacked(rows, cols=4):
    return dist.scatter_stack(torch.ones((rows, cols), dtype=torch.float32))


# ---------------------------------------------------------------------------
# collective recording (reference tests/test_telemetry.py TestCollectiveTracing)
# ---------------------------------------------------------------------------
class TestCollectiveTracing:
    def test_eager_collectives_recorded_with_cost(self):
        x = _stacked(8)
        dist.all_reduce(x)
        dist.reduce_scatter(_stacked(64))
        stats = telemetry.collective_stats()
        assert stats["all_reduce"]["calls"] == 1
        assert stats["all_reduce"]["bytes"] == 8 * 4 * 4
        n = dist.get_world_size()
        assert stats["all_reduce"]["wire_bytes"] == \
            pytest.approx(2 * (n - 1) / n * 8 * 4 * 4)
        assert stats["reduce_scatter"]["calls"] == 1
        evs = [e for e in telemetry.get_flight_recorder().events()
               if e["kind"] == "collective"]
        names = [e["name"] for e in evs]
        assert "all_reduce" in names and "reduce_scatter" in names
        ar = next(e for e in evs if e["name"] == "all_reduce")
        assert ar["trace_time"] is False and ar["group_size"] == n

    def test_every_kind_records_once_after_it_ran(self):
        g = dist.new_group()
        dist.all_gather(_stacked(8), group=g)
        dist.broadcast(_stacked(8), src=0, group=g)
        dist.all_to_all(_stacked(8 * g.nranks), group=g)
        dist.ppermute(_stacked(8), [(0, 0)], group=g)
        stats = telemetry.collective_stats()
        assert {k: v["calls"] for k, v in stats.items()} == {
            "all_gather": 1, "broadcast": 1, "all_to_all": 1, "ppermute": 1}

    @pytest.mark.parametrize("kind,nbytes,n", [
        ("all_reduce", 1024, 4), ("all_gather", 800, 8), ("ppermute", 100, 8),
        ("reduce_scatter", 4096, 2), ("psum", 12, 3), ("broadcast", 64, 1),
        ("unknown_kind", 77, 5)])
    def test_cost_model_equals_the_reference(self, kind, nbytes, n):
        assert telemetry.ring_wire_bytes(kind, nbytes, n) == \
            jtel.ring_wire_bytes(kind, nbytes, n)
        assert telemetry.ici_cost_estimate(kind, nbytes, n, ici_gbps=45.0) == \
            jtel.ici_cost_estimate(kind, nbytes, n, ici_gbps=45.0)

    def test_link_table_keeps_the_reference_rows_and_adds_the_h100(self):
        for key, val in jtel.ICI_GBPS_ONEWAY.items():
            assert telemetry.ICI_GBPS_ONEWAY[key] == val
        assert telemetry.chip_lookup("NVIDIA H100 80GB HBM3", telemetry.ICI_GBPS_ONEWAY) == 450.0
        assert telemetry.chip_lookup("NVIDIA H100 PCIe", telemetry.ICI_GBPS_ONEWAY) == 300.0
        assert telemetry.chip_lookup("cpu", telemetry.ICI_GBPS_ONEWAY) == 10.0

    def test_link_rate_resolves_once_a_process(self, monkeypatch):
        from paddle_tpu_torch.telemetry import collectives as C

        monkeypatch.setattr(C, "_ici_gbps_cache", None)
        calls = []
        monkeypatch.setattr(C, "chip_lookup", lambda d, t: calls.append(d) or 7.0)
        assert C._ici_gbps() == 7.0 and C._ici_gbps() == 7.0
        assert calls == ["cpu"]

    def test_traced_program_execution_counter(self):
        prog = telemetry.register_traced_program(
            "pipe_step", [{"kind": "ppermute", "nbytes": 10, "group_size": 4, "count": 3}])
        jprog = jtel.register_traced_program(
            "pipe_step", [{"kind": "ppermute", "nbytes": 10, "group_size": 4, "count": 3}])
        for p in (prog, jprog, prog, jprog):
            p.record_execution()
        assert telemetry.collective_stats() == jtel.collective_stats()
        s = telemetry.collective_stats()["ppermute"]
        assert prog.executions == 2 and s["calls"] == 6 and s["bytes"] == 60
        assert s["trace_records"] == 1
        ev = [e for e in telemetry.get_flight_recorder().events()
              if e["kind"] == "collective_program"]
        assert ev and ev[-1]["executions"] == 2
        assert telemetry.total_collective_bytes() == jtel.total_collective_bytes() == 60

    def test_disabled_records_nothing(self):
        telemetry.disable()
        try:
            dist.all_reduce(_stacked(8))
            assert telemetry.collective_stats() == {}
            assert len(telemetry.get_flight_recorder()) == 0
        finally:
            telemetry.enable()

    def test_overlap_fraction_reaches_the_step_meter(self):
        prog = telemetry.register_traced_program(
            "ring", [{"kind": "ppermute", "nbytes": 1000, "group_size": 2}])
        jprog = jtel.register_traced_program(
            "ring", [{"kind": "ppermute", "nbytes": 1000, "group_size": 2}])
        meter = telemetry.StepMeter("m", tokens_per_step=8, peak_tflops=1.0, peak_hbm_gbps=1.0)
        jmeter = jtel.StepMeter("m", tokens_per_step=8)
        meter.step()
        jmeter.step()
        assert "overlap_fraction" not in meter.summary()
        prog.set_overlap_fraction(0.625, source="chrome_trace")
        jprog.set_overlap_fraction(0.625, source="chrome_trace")
        assert meter.summary()["overlap_fraction"] == jmeter.summary()["overlap_fraction"] \
            == 0.625
        assert telemetry.counters()["overlap_fraction_last"] == 0.625


class TestEngineProfiles:
    def test_distributed_train_step_registers_its_reduction(self):
        from paddle_tpu_torch.distributed.engine import DistributedTrainStep
        from paddle_tpu_torch.distributed.topology import build_mesh
        from paddle_tpu_torch.optimizer import SGD

        mesh = build_mesh(dp=2, devices=["cpu"] * 2)
        lin = torch.nn.Linear(4, 3)
        step = DistributedTrainStep(lin, lambda m, x, y: ((m(x) - y) ** 2).mean(),
                                    SGD(0.1, parameters=list(lin.parameters())), mesh)
        progs = telemetry.traced_programs()
        prog = progs["DistributedTrainStep_stage0"]
        assert prog.collectives == [{"kind": "all_reduce", "nbytes": (12 + 3) * 4,
                                     "group_size": 2, "count": 1, "axes": ["data"]}]
        x, y = torch.ones(4, 4), torch.zeros(4, 3)
        step(x, y)
        step(x, y)
        assert prog.executions == 2
        assert telemetry.collective_stats()["all_reduce"]["calls"] >= 2

    def test_collective_matmul_records_trace_time_permutes(self):
        from paddle_tpu_torch.distributed.overlap.collective_matmul import all_gather_matmul
        from paddle_tpu_torch.distributed.topology import build_mesh

        mesh = build_mesh(mp=2, devices=["cpu"] * 2)
        x, w = torch.randn(8, 4), torch.randn(4, 6)
        torch.testing.assert_close(all_gather_matmul(x, w, mesh), x @ w)
        s = telemetry.collective_stats()["ppermute"]
        assert s["trace_records"] == 1 and s["calls"] == 0
        ev = [e for e in telemetry.get_flight_recorder().events() if e["kind"] == "collective"]
        assert ev[-1]["source"] == "collective_matmul" and ev[-1]["nbytes"] == 8 * 4 * 4 // 2


# ---------------------------------------------------------------------------
# flight recorder and the watchdog's dump (reference TestFlightRecorder)
# ---------------------------------------------------------------------------
class TestFlightRecorder:
    def test_ring_is_bounded(self):
        fr = telemetry.FlightRecorder(maxlen=4)
        for i in range(10):
            fr.record("k", f"e{i}")
        assert [e["name"] for e in fr.events()] == ["e6", "e7", "e8", "e9"]
        assert fr._dropped == 6

    def test_dump_on_demand(self, tmp_path):
        telemetry.record_event("checkpoint_save", "/ckpt/step100", rank=0)
        path = telemetry.dump_flight_recorder(path=str(tmp_path / "d.json"), reason="test")
        doc = json.load(open(path))
        assert doc["reason"] == "test"
        assert doc["events"][-1]["name"] == "/ckpt/step100"
        assert doc["pid"] == os.getpid()

    def test_watchdog_hang_writes_dump_identifying_inflight(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_FLIGHT_RECORDER_DIR", str(tmp_path))
        fired = []
        wd = CommWatchdog(timeout=0.2, poll_interval=0.05, on_timeout=fired.append)
        with wd.watch("all_reduce"):
            time.sleep(0.6)
        wd.stop()
        assert len(fired) == 1
        dump = fired[0]["flight_recorder_dump"]
        assert dump and os.path.exists(dump)
        evs = json.load(open(dump))["events"]
        assert evs[-1]["kind"] == "watchdog_timeout" and evs[-1]["name"] == "all_reduce"
        assert evs[-1]["elapsed_s"] >= 0.2
        armed = [e for e in evs if e["kind"] == "watch_armed"]
        assert armed and armed[-1]["name"] == "all_reduce"
        assert "paddle_tpu_watchdog_timeouts_total 1" in telemetry.prometheus_text()

    def test_watchdog_dump_is_empty_with_telemetry_off(self):
        fired = []
        wd = CommWatchdog(timeout=0.1, poll_interval=0.02, on_timeout=fired.append)
        telemetry.disable()
        try:
            with wd.watch("hang"):
                time.sleep(0.35)
        finally:
            wd.stop()
            telemetry.enable()
        assert fired and fired[0]["flight_recorder_dump"] == ""


# ---------------------------------------------------------------------------
# Prometheus text against the reference's
# ---------------------------------------------------------------------------
def _samples(text: str):
    return [ln for ln in text.splitlines() if ln and not ln.startswith("#")]


def _feed(tel):
    tel.bump("steps_total", 3)
    tel.bump("tokens_total", 96)
    tel.set_gauge("mfu_last", 0.25)
    tel.bump("serving.requests_finished", 2)
    tel.set_gauge("serving.queue_depth", 4.0)
    tel.set_gauge("serving.fleet_queue_depth.r0", 2.0)
    tel.bump("kernel_fallback.total")
    tel.bump("kernel_fallback.serving_cp_prefill.kv_import")
    tel.bump("serving.ttft_s_hist.bucket.0.05")
    tel.bump("serving.ttft_s_hist.bucket.0.5", 2)
    tel.bump("serving.ttft_s_hist.sum", 0.9)
    tel.bump("serving.ttft_s_hist.count", 3)
    tel.register_traced_program("p", [{"kind": "all_reduce", "nbytes": 64, "group_size": 4}]) \
        .record_execution()


@pytest.mark.parametrize("labels", [None, {"replica": "r1", "rank": "0"}])
def test_prometheus_text_equals_the_reference(labels):
    _feed(telemetry)
    _feed(jtel)
    mine = telemetry.prometheus_text(labels=labels)
    theirs = jtel.prometheus_text(labels=labels)
    # the wire-seconds sample prices bytes at each package's link rate
    drop = ("collective_wire_seconds_total", "flight_recorder_events")
    keep = [ln for ln in _samples(theirs) if not any(d in ln for d in drop)]
    assert [ln for ln in _samples(mine) if not any(d in ln for d in drop)] == keep
    assert any("serving_ttft_s_seconds_bucket" in ln for ln in keep)


def test_render_histogram_equals_the_reference():
    h = telemetry.Histogram()
    for v in (0.002, 0.04, 0.7, 99.0):
        h.observe(v)
    a, b = [], []
    telemetry.render_histogram(a, "x_seconds", "help", h.to_doc(), labels={"r": "1"})
    jtel.render_histogram(b, "x_seconds", "help", h.to_doc(), labels={"r": "1"})
    assert a == b


# ---------------------------------------------------------------------------
# the decode gate's kernel_fallback events
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q,cache,tp,int8,fp8,reason", [
    ((2, 1, 8, 64), (2, 64, 4, 64), 0, False, False, "bad_tp"),
    ((2, 8, 64), (2, 64, 4, 64), 1, False, False, "rank"),
    ((2, 1, 8, 64), (2, 64, 3, 64), 2, False, False, "ragged_heads"),
    ((2, 1, 8, 64), (2, 64, 4, 64), 2, True, True, "conflicting_cache_dtypes"),
    ((2, 1, 8, 300), (2, 64, 4, 300), 2, False, False, "shard_shape"),
])
def test_decode_gate_records_the_reference_reason(q, cache, tp, int8, fp8, reason):
    assert decode_attention_sharded_supported(q, cache, tp=tp, int8=int8, fp8=fp8,
                                              emit_fallback=True) is False
    assert jax_sharded_supported(q, cache, tp=tp, int8=int8, fp8=fp8,
                                 emit_fallback=True) is False
    mine = {k: v for k, v in telemetry.counters().items() if k.startswith("kernel_fallback.")}
    theirs = {k: v for k, v in jtel.counters().items() if k.startswith("kernel_fallback.")}
    assert mine == theirs
    assert mine[f"kernel_fallback.decode_attention_sharded.{reason}"] == 1
    ev = [e for e in telemetry.get_flight_recorder().events() if e["kind"] == "kernel_fallback"]
    assert ev[-1]["name"] == "decode_attention_sharded" and ev[-1]["reason"] == reason


def test_decode_gate_accepts_quietly():
    assert decode_attention_sharded_supported((2, 1, 8, 64), (2, 64, 4, 64), tp=2,
                                              emit_fallback=True)
    assert not any(k.startswith("kernel_fallback") for k in telemetry.counters())



def test_launch_counts_survive_many_launching_threads():
    """The engines of an in-process fleet launch from their own threads:
    ``ops.count_launch`` loses no count (``+= 1`` on a dict entry would)."""
    import sys
    import threading

    from paddle_tpu_torch.ops import LAUNCHES, count_launch, reset_launch_counts

    reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch("rope") for _ in range(20000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert LAUNCHES["rope"] == 16 * 20000
    reset_launch_counts()
