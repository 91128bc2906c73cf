"""Training telemetry (port of the reference's ``telemetry/``): the step
meter and the modules it reads.

- :class:`StepMeter`: tokens/s, MFU/MBU against the chip tables (an H100
  row), loss, skipped steps, device-memory watermarks, JSONL records;
- :mod:`.runtime`: counters, gauges, the enable switch and the process's
  identity from the launcher's environment;
- :mod:`.recorder`: the flight recorder;
- :mod:`.memory`: ``hbm_stats`` / ``hbm_watermarks`` / ``hbm_peak_gb``
  over the card's allocator;
- :mod:`.collectives`: the chip tables, ``chip_lookup`` and
  ``collective_stats``.

The reference's other exports (the collective recording and cost model,
traced programs, Prometheus text, trace spans, the metrics aggregator and
the black box) arrive with ROADMAP A8; each raises on use, naming it.

Env vars: ``PADDLE_TPU_TELEMETRY=0`` disables recording;
``PADDLE_TPU_TELEMETRY_DIR`` makes StepMeters write JSONL there by default;
``PADDLE_TPU_FLIGHT_RECORDER_DIR`` / ``_SIZE`` control the crash dump
location and ring size; ``PADDLE_TPU_FLIGHT_RECORDER=0`` opts out of the
unhandled-exception dump hook.
"""

from .runtime import (bump, counters, disable, enable, enabled,  # noqa: F401
                      reset, set_gauge)
from .recorder import (FlightRecorder, dump_flight_recorder,  # noqa: F401
                       get_flight_recorder, kernel_fallback, record_event)
from .collectives import (PEAK_HBM_GBPS, PEAK_TFLOPS, chip_lookup,  # noqa: F401
                          collective_stats)
from .memory import hbm_peak_gb, hbm_stats, hbm_watermarks  # noqa: F401
from .stepmeter import StepMeter  # noqa: F401

__all__ = [
    "enable", "disable", "enabled", "reset", "bump", "set_gauge", "counters",
    "FlightRecorder", "get_flight_recorder", "record_event",
    "dump_flight_recorder", "kernel_fallback",
    "collective_stats", "PEAK_TFLOPS", "PEAK_HBM_GBPS", "chip_lookup",
    "hbm_stats", "hbm_watermarks", "hbm_peak_gb", "StepMeter",
]

# the reference's exports that wait for the rest of telemetry (ROADMAP A8)
_UNPORTED = frozenset({
    "record_collective", "total_collective_bytes", "ici_cost_estimate",
    "ring_wire_bytes", "TracedProgram", "register_traced_program",
    "traced_programs", "ICI_GBPS_ONEWAY", "prometheus_text", "render_histogram",
    "TRACE_KEY", "mint", "trace_spans", "trace_ids", "trace_coverage",
    "chrome_trace_events", "Histogram", "MemoryDepot", "MetricsPusher",
    "local_snapshot", "rollup", "prometheus_rollup_text", "start_metrics_pusher",
    "blackbox"})


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"telemetry.{name} is not ported yet (ROADMAP A8: the collective "
            "recording and cost model, Prometheus, tracing, the aggregator and "
            "the black box)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
