"""Telemetry (port of the reference's ``telemetry/``): the metrics and
tracing layer the rest of the stack reports into.

- **collective tracing**: ``distributed.communication`` records every eager
  collective (kind, payload bytes, group, analytic link cost); the
  engines whose collectives run inside a step register a
  :class:`TracedProgram` with an execution counter;
- **step metrics**: :class:`StepMeter`: tokens/s, MFU/MBU against the
  chip tables (an H100 row), loss, skipped steps, device-memory
  watermarks, JSONL records, Prometheus text through
  :func:`prometheus_text`;
- **memory watermarks**: ``hbm_stats`` / ``hbm_watermarks`` /
  ``hbm_peak_gb`` over the card's allocator;
- **flight recorder**: :class:`FlightRecorder`, a bounded ring of recent
  events, dumped to JSON on demand, on an unhandled exception or on a
  watchdog hang;
- **request tracing** (:mod:`.tracing`): one trace id a serving request,
  carried through the journal, the depot frames, hand-backs and
  fail-overs;
- **the job view** (:mod:`.aggregator`, :mod:`.report`,
  :mod:`.blackbox`): per-process snapshots pushed to the launcher's
  depot, rolled up over merged histograms, printed as a dashboard, and
  every process's recorder dump merged into one causal timeline.

Env vars: ``PADDLE_TPU_TELEMETRY=0`` disables recording;
``PADDLE_TPU_TELEMETRY_DIR`` makes StepMeters write JSONL there by default;
``PADDLE_TPU_FLIGHT_RECORDER_DIR`` / ``_SIZE`` control the crash dump
location and ring size; ``PADDLE_TPU_FLIGHT_RECORDER=0`` opts out of the
unhandled-exception dump hook; ``PADDLE_TPU_METRICS_PUSH_S`` sets the
metrics pusher's period.
"""

from .runtime import (bump, counters, disable, enable, enabled,  # noqa: F401
                      reset, set_gauge)
from .recorder import (FlightRecorder, dump_flight_recorder,  # noqa: F401
                       get_flight_recorder, kernel_fallback, record_event)
from .collectives import (ICI_GBPS_ONEWAY, PEAK_HBM_GBPS,  # noqa: F401
                          PEAK_TFLOPS, TracedProgram, chip_lookup,
                          collective_stats, ici_cost_estimate,
                          record_collective, register_traced_program,
                          ring_wire_bytes, total_collective_bytes,
                          traced_programs)
from .memory import hbm_peak_gb, hbm_stats, hbm_watermarks  # noqa: F401
from .stepmeter import StepMeter  # noqa: F401
from .prometheus import prometheus_text, render_histogram  # noqa: F401
from .tracing import (TRACE_KEY, chrome_trace_events, mint,  # noqa: F401
                      trace_coverage, trace_ids)
from .tracing import spans as trace_spans  # noqa: F401
from .aggregator import (Histogram, MemoryDepot, MetricsPusher,  # noqa: F401
                         local_snapshot, prometheus_rollup_text, rollup,
                         start_metrics_pusher)
from . import blackbox  # noqa: F401

__all__ = [
    "enable", "disable", "enabled", "reset", "bump", "set_gauge", "counters",
    "FlightRecorder", "get_flight_recorder", "record_event",
    "dump_flight_recorder", "kernel_fallback",
    "record_collective", "collective_stats", "total_collective_bytes",
    "ici_cost_estimate", "ring_wire_bytes", "TracedProgram",
    "register_traced_program", "traced_programs",
    "PEAK_TFLOPS", "ICI_GBPS_ONEWAY", "PEAK_HBM_GBPS", "chip_lookup",
    "hbm_stats", "hbm_watermarks", "hbm_peak_gb",
    "StepMeter", "prometheus_text", "render_histogram",
    "TRACE_KEY", "mint", "trace_spans", "trace_ids", "trace_coverage",
    "chrome_trace_events",
    "Histogram", "MemoryDepot", "MetricsPusher", "local_snapshot",
    "rollup", "prometheus_rollup_text", "start_metrics_pusher",
    "blackbox",
]
