"""The port's ``telemetry`` (``StepMeter`` and the modules it reads)
against the JAX package's: the same calls under one fake clock give the
same records, JSONL lines, ``summary()`` and counters; the chip tables
pick the H100 rows by the card's name; the memory watermarks read the
card's allocator; and what waits for a later item raises, naming it.
"""

import json
import time

import pytest
import torch

import paddle_tpu.telemetry as jtel
from paddle_tpu.telemetry import runtime as jruntime

import paddle_tpu_torch.telemetry as tel
from paddle_tpu_torch.telemetry import collectives, memory, runtime, stepmeter

torch.set_num_threads(1)


class _Clock:
    """``time.perf_counter`` and ``time.time`` stepping by fixed amounts,
    so two meters driven alike read the same times."""

    def __init__(self, dts):
        self._dts, self._i, self._t = list(dts), 0, 100.0

    def perf_counter(self):
        self._t += self._dts[self._i % len(self._dts)]
        self._i += 1
        return self._t

    def time(self):
        return 1.7e9 + self._t


SCENARIOS = {  # constructor arguments, step() calls
    "llm": (dict(tokens_per_step=4096, model_params=1_000_000),
            [dict(loss=2.5), dict(loss=2.25, grad_norm=0.5), dict(loss=2.0)]),
    "flops_and_bytes": (dict(tokens_per_step=64, samples_per_step=4, flops_per_step=3e12,
                             bytes_per_step=2e9, peak_tflops=989.0, peak_hbm_gbps=3350.0),
                        [dict(loss=1.0), dict(skipped=True), dict(loss=0.5, tokens=32)]),
    "skips_and_extra": (dict(samples_per_step=8),
                        [dict(skipped=False, lr=1e-4), dict(skipped=True, note="inf"),
                         dict(samples=4)]),
    "no_model": (dict(), [dict(), dict(loss=3.0)]),
}


def _drive(package_tel, kw, calls, path, monkeypatch):
    clock = _Clock([0.25, 0.5, 0.125])
    monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(time, "time", clock.time)
    meter = package_tel.StepMeter("meter", jsonl_path=str(path), **kw)
    recs = [meter.step(**c) for c in calls]
    summary = meter.summary()
    monkeypatch.undo()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    return recs, lines, summary, meter


@pytest.fixture
def no_sdc_counters():
    """The JAX summary reports the process's SDC monitor counters, which
    an earlier test in the same worker may have bumped; they are set aside
    for the test and put back after it."""
    saved = {k: jruntime._counters.pop(k) for k in list(jruntime._counters)
             if k.startswith("sdc_")}
    yield
    jruntime._counters.update(saved)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_records_jsonl_and_summary_match_reference(scenario, tmp_path, monkeypatch,
                                                   no_sdc_counters):
    kw, calls = SCENARIOS[scenario]
    jc0, tc0 = jruntime.counters(), runtime.counters()
    want = _drive(jtel, kw, calls, tmp_path / "jax.jsonl", monkeypatch)
    jc1 = jruntime.counters()
    got = _drive(tel, kw, calls, tmp_path / "port.jsonl", monkeypatch)
    tc1 = runtime.counters()
    for g, w in zip(got[:3], want[:3]):
        assert g == w
    assert got[3].steps_skipped == want[3].steps_skipped
    assert got[3].flops_per_step == want[3].flops_per_step
    delta = {k: tc1[k] - tc0.get(k, 0.0) for k in tc1 if "last" not in k}
    jdelta = {k: jc1[k] - jc0.get(k, 0.0) for k in tc1 if "last" not in k}
    assert delta == jdelta
    assert tc1["mfu_last"] == jc1["mfu_last"]


def test_empty_meter_summary_and_begin(monkeypatch):
    for package in (jtel, tel):
        m = package.StepMeter("idle", jsonl_path=False)
        m.begin()
        assert m.summary() == {"meter": "idle", "steps": 0}


def test_default_jsonl_path_and_disable(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path / "port"))
    meter = tel.StepMeter("job", tokens_per_step=10)
    meter.step(loss=1.0)
    files = list((tmp_path / "port").iterdir())
    assert [f.name for f in files] == [f"job_pid{runtime.identity()['pid']}.jsonl"]
    assert json.loads(files[0].read_text())["loss"] == 1.0
    tel.disable()
    try:
        meter.step(loss=2.0)
    finally:
        tel.enable()
    assert len(files[0].read_text().splitlines()) == 1
    assert tel.StepMeter("nofile", jsonl_path=False).jsonl_path is None


def test_rank_from_launcher_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    rec = tel.StepMeter("r", jsonl_path=False).step()
    assert rec["rank"] == 3 == runtime.identity()["rank"]


NAMES = {  # device name: (TFLOP/s, GB/s)
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
    "NVIDIA H100 PCIe": (756.0, 2000.0),
    "NVIDIA H100 NVL": (989.0, 3350.0),
    "TPU v5 lite": (197.0, 819.0),
    "cpu": (0.5, 50.0),
    "Some Other Card": (0.5, 50.0),
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_chip_lookup_by_name(name):
    assert (collectives.chip_lookup(name, tel.PEAK_TFLOPS),
            collectives.chip_lookup(name, tel.PEAK_HBM_GBPS)) == NAMES[name]


def test_tables_keep_the_reference_rows():
    for table, ref in ((tel.PEAK_TFLOPS, jtel.PEAK_TFLOPS),
                       (tel.PEAK_HBM_GBPS, jtel.PEAK_HBM_GBPS)):
        assert {k: v for k, v in table.items() if k in ref} == ref
        assert list(table)[:2] == ["h100 pcie", "h100"]


@pytest.mark.parametrize("card", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"])
def test_meter_reads_the_default_card(card, monkeypatch):
    monkeypatch.setattr(stepmeter, "resolve_device", lambda: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: card)
    m = tel.StepMeter("card", jsonl_path=False)
    assert (m.peak_tflops, m.peak_hbm_gbps) == NAMES[card]
    assert collectives.chip_lookup(torch.device("cuda", 0), tel.PEAK_TFLOPS) == NAMES[card][0]


def test_meter_on_the_cpu_reads_the_cpu_row():
    m = tel.StepMeter("cpu", jsonl_path=False)
    assert (m.peak_tflops, m.peak_hbm_gbps) == (0.5, 50.0)
    assert collectives.chip_lookup(torch.device("cpu"), tel.PEAK_HBM_GBPS) == 50.0


def test_memory_without_a_card_is_the_reference_no_op():
    assert memory.hbm_stats() == [] == jtel.hbm_stats()
    assert memory.hbm_watermarks() == jtel.hbm_watermarks() == {
        "live_gb": 0.0, "peak_gb": 0.0, "limit_gb": 0.0, "devices": 0}
    assert memory.hbm_peak_gb() == 0.0


def test_memory_reads_the_allocator(monkeypatch):
    """Live and peak are the allocator's ``allocated_bytes.all`` current and
    peak (``memory_allocated`` / ``max_memory_allocated``), the worst card's,
    in GB rounded to 4 places."""
    stats = [{"allocated_bytes.all.current": 3_000_000_000,
              "allocated_bytes.all.peak": 7_123_456_789},
             {"allocated_bytes.all.current": 5_000_000_000,
              "allocated_bytes.all.peak": 6_000_000_000}]

    class Props:
        total_memory = 85_000_000_000

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props())
    assert [s["peak_bytes_in_use"] for s in memory.hbm_stats()] == [7_123_456_789,
                                                                    6_000_000_000]
    assert memory.hbm_watermarks() == {"live_gb": 5.0, "peak_gb": 7.1235, "limit_gb": 85.0,
                                       "devices": 2}
    rec = tel.StepMeter("mem", jsonl_path=False, peak_tflops=1.0, peak_hbm_gbps=1.0).step()
    assert (rec["hbm_live_gb"], rec["hbm_peak_gb"]) == (5.0, 7.1235)


def test_collective_stats_empty_until_recorded():
    assert tel.collective_stats() == {}


def test_health_guard_raises_naming_a7():
    with pytest.raises(NotImplementedError, match="A7"):
        tel.StepMeter("g", health_guard=object())


def test_flight_recorder_gets_each_step():
    rec = tel.get_flight_recorder()
    tel.StepMeter("fr", jsonl_path=False).step(loss=1.5)
    ev = rec.events()[-1]
    assert (ev["kind"], ev["name"], ev["step"], ev["loss"]) == ("step", "fr", 1, 1.5)


UNPORTED = sorted(tel._UNPORTED)


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_exports_raise_naming_a8(name):
    assert name in jtel.__all__
    with pytest.raises(NotImplementedError, match="A8"):
        getattr(tel, name)


def test_ported_exports_are_the_reference_names():
    assert set(tel.__all__) <= set(jtel.__all__)
    assert set(tel.__all__) | set(tel._UNPORTED) == set(jtel.__all__)
