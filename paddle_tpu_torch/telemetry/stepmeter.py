"""StepMeter: per-step training metrics (port of the reference's
``telemetry/stepmeter.py``): tokens/s, achieved MFU/MBU from a FLOP/byte
model, loss/grad-norm, device-memory watermarks, per-step collective
bytes and the skipped-step columns.

Driven by the training loop::

    meter = StepMeter("llama", tokens_per_step=batch*seq, model_params=N,
                      jsonl_path="telemetry/steps.jsonl")
    for x, y in loader:
        loss = train_step(x, y)
        meter.step(loss=float(loss))     # or step() with no host sync
    print(meter.summary())

Each ``step()`` appends one JSONL record (when a path is configured; by
default under ``PADDLE_TPU_TELEMETRY_DIR`` when that is set), updates the
process-wide counters of :mod:`.runtime` and drops a compact event into
the flight recorder.  The records, the file and ``summary()`` are the
reference's, key for key.

The FLOP model is the reference's: 6·N flops per token (``model_params``)
unless the caller passes ``flops_per_step`` (a model whose attention
matters passes its own count); MBU uses ``bytes_per_step``.  The peaks
come from the chip tables by the default device's name (an H100 reads
its own row; without a card, the nominal CPU row).  The step time is the
host's clock between two ``step()`` calls: a loop that wants device time
synchronises before it calls ``step()``.  ``health_guard`` (a
``distributed.health.HealthGuard``) is fed every ``step(loss=...,
grad_norm=...)``'s values, driving its host-side spike detector (the
eager-loop twin of ``TrainStep``'s device probe: attach the guard to one
of the two, or anomalies count twice).  The
summary's ``overlap_fraction`` is the wire-byte-weighted mean of the
overlap fractions measured for the registered traced programs
(``distributed/overlap/measure.py`` measures them); it is absent while
none is measured, as in the reference.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from . import runtime
from .collectives import (PEAK_HBM_GBPS, PEAK_TFLOPS, chip_lookup,
                          collective_stats)
from .memory import hbm_watermarks
from .recorder import record_event

__all__ = ["StepMeter"]


def _default_device():
    """The package's default device, or the CPU where it cannot be had
    (no card and no ``set_device("cpu")``): the peaks of a meter with
    nothing to measure are the nominal CPU row, as in the reference."""
    try:
        return resolve_device()
    except RuntimeError:
        return torch.device("cpu")


def _default_jsonl_path(name: str) -> Optional[str]:
    d = os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{name}_pid{os.getpid()}.jsonl")


class StepMeter:
    def __init__(self, name: str = "train", *,
                 tokens_per_step: Optional[float] = None,
                 samples_per_step: Optional[float] = None,
                 model_params: Optional[int] = None,
                 flops_per_step: Optional[float] = None,
                 bytes_per_step: Optional[float] = None,
                 jsonl_path: Optional[str] = None,
                 peak_tflops: Optional[float] = None,
                 peak_hbm_gbps: Optional[float] = None,
                 health_guard=None):
        self.name = name
        self.health_guard = health_guard
        self.steps_skipped = 0
        self.tokens_per_step = tokens_per_step
        self.samples_per_step = samples_per_step
        if flops_per_step is None and model_params and tokens_per_step:
            flops_per_step = 6.0 * model_params * tokens_per_step
        self.flops_per_step = flops_per_step
        self.bytes_per_step = bytes_per_step
        # None = default (env PADDLE_TPU_TELEMETRY_DIR when set);
        # False = explicitly no file (hot loops that only want in-memory
        # records must not pay a per-step write)
        if jsonl_path is None:
            self.jsonl_path: Optional[str] = _default_jsonl_path(name)
        elif jsonl_path is False:
            self.jsonl_path = None
        else:
            self.jsonl_path = jsonl_path
        if peak_tflops is None or peak_hbm_gbps is None:
            dev = _default_device()
            if peak_tflops is None:
                peak_tflops = chip_lookup(dev, PEAK_TFLOPS)
            if peak_hbm_gbps is None:
                peak_hbm_gbps = chip_lookup(dev, PEAK_HBM_GBPS)
        self.peak_tflops = peak_tflops
        self.peak_hbm_gbps = peak_hbm_gbps
        # recent records only (full history is the JSONL file) — a 1M-step
        # run must not accumulate 1M dicts on the host
        self.records: collections.deque = collections.deque(maxlen=4096)
        self.step_num = 0
        self._t_last = time.perf_counter()
        self._coll_last = self._coll_totals()
        # running aggregates for summary(): O(1) memory over any run length
        self._total_dt = 0.0
        self._hbm_peak_gb = 0.0
        self._hbm_live_max_gb = 0.0
        self._coll_agg: Dict[str, int] = {}
        self._first_loss: Optional[float] = None
        self._last_loss: Optional[float] = None

    # -- internals ---------------------------------------------------------
    @staticmethod
    def _coll_totals() -> Dict[str, float]:
        return {k: v["bytes"] for k, v in collective_stats().items()}

    @staticmethod
    def _overlap_fraction():
        """Wire-byte-weighted mean of the MEASURED overlap fractions
        attached to registered TracedPrograms (None when nothing measured
        one — the meter never guesses)."""
        from .collectives import traced_programs

        num = den = 0.0
        for prog in traced_programs().values():
            if prog.overlap_fraction is None:
                continue
            w = max(prog.wire_bytes_per_execution(), 1.0)
            num += prog.overlap_fraction * w
            den += w
        return (num / den) if den else None

    def begin(self) -> None:
        """Re-arm the step timer (e.g. after a pause); optional — the
        constructor arms it."""
        self._t_last = time.perf_counter()
        self._coll_last = self._coll_totals()

    # -- the one entry point ----------------------------------------------
    def step(self, loss: Optional[float] = None,
             grad_norm: Optional[float] = None,
             tokens: Optional[float] = None,
             samples: Optional[float] = None,
             skipped: Optional[bool] = None,
             **extra) -> Dict[str, Any]:
        """Close the current step: compute rates since the previous call and
        emit one record. ``tokens``/``samples`` override the per-step
        defaults for variable-size batches. ``skipped=True`` marks a step
        whose update was withheld (health guard / AMP found-inf) — counted
        into ``steps_skipped`` so a silent-skip regression is visible in
        the JSONL trail and the summary."""
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        tokens = tokens if tokens is not None else self.tokens_per_step
        samples = samples if samples is not None else self.samples_per_step
        self.step_num += 1

        rec: Dict[str, Any] = {
            "meter": self.name, "step": self.step_num,
            "ts": time.time(), "dt_s": round(dt, 6),
        }
        # self-identification (schema-additive): a row pushed to the
        # launcher's metrics depot names its own rank/replica, so the
        # job rollup never has to guess attribution from filenames
        rec["wall_time"] = rec["ts"]
        ident = runtime.identity()
        if ident.get("rank") is not None:
            rec["rank"] = ident["rank"]
        if ident.get("replica"):
            rec["replica"] = ident["replica"]
        safe_dt = dt if dt > 0 else 0.0
        rec["tokens_per_s"] = round(tokens / safe_dt, 3) if tokens and safe_dt \
            else 0.0
        rec["samples_per_s"] = round(samples / safe_dt, 3) if samples and safe_dt \
            else 0.0
        # full precision: a CPU-smoke MFU of ~1e-7 must not round to zero
        rec["mfu"] = self.flops_per_step / safe_dt / (self.peak_tflops * 1e12) \
            if self.flops_per_step and safe_dt else 0.0
        rec["mbu"] = self.bytes_per_step / safe_dt / (self.peak_hbm_gbps * 1e9) \
            if self.bytes_per_step and safe_dt else 0.0
        if loss is not None:
            rec["loss"] = float(loss)
        if grad_norm is not None:
            rec["grad_norm"] = float(grad_norm)
        if skipped is not None:
            rec["skipped"] = bool(skipped)
            if skipped:
                self.steps_skipped += 1
                runtime.bump("steps_skipped_total")
        if self.health_guard is not None and loss is not None:
            # not shielded as telemetry is: the guard is training control,
            # and an escalation raised here (SystemExit(101), HealthError,
            # a custom on_escalate) must reach the training loop
            self.health_guard.observe_host(self.step_num, float(loss), grad_norm)
        rec["steps_skipped"] = self.steps_skipped

        wm = hbm_watermarks()
        rec["hbm_live_gb"] = wm["live_gb"]
        rec["hbm_peak_gb"] = wm["peak_gb"]

        coll = self._coll_totals()
        delta = {k: int(coll[k] - self._coll_last.get(k, 0)) for k in coll
                 if coll[k] - self._coll_last.get(k, 0) > 0}
        self._coll_last = coll
        rec["collective_bytes"] = delta
        rec["collective_bytes_total"] = int(sum(delta.values()))
        if extra:
            rec.update(extra)

        self.records.append(rec)
        self._total_dt += dt
        self._hbm_peak_gb = max(self._hbm_peak_gb, rec["hbm_peak_gb"])
        self._hbm_live_max_gb = max(self._hbm_live_max_gb, rec["hbm_live_gb"])
        for k, v in delta.items():
            self._coll_agg[k] = self._coll_agg.get(k, 0) + v
        if loss is not None:
            if self._first_loss is None:
                self._first_loss = float(loss)
            self._last_loss = float(loss)
        self._emit(rec)

        runtime.bump("steps_total")
        if tokens:
            runtime.bump("tokens_total", tokens)
        if samples:
            runtime.bump("samples_total", samples)
        runtime.set_gauge("step_duration_seconds_last", dt)
        runtime.set_gauge("tokens_per_second_last", rec["tokens_per_s"])
        runtime.set_gauge("mfu_last", rec["mfu"])
        if rec["mbu"]:
            runtime.set_gauge("mbu_last", rec["mbu"])
        record_event("step", self.name, step=self.step_num,
                     dt_s=rec["dt_s"], loss=rec.get("loss"),
                     tokens_per_s=rec["tokens_per_s"], mfu=rec["mfu"])
        return rec

    def _emit(self, rec: Dict[str, Any]) -> None:
        if not self.jsonl_path or not runtime.enabled():
            return
        try:
            # default=repr: a non-serializable value in **extra must not
            # kill the training loop (telemetry never breaks training)
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec, separators=(",", ":"),
                                   default=repr) + "\n")
        except Exception:
            pass

    # -- aggregates --------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Whole-run aggregates (maintained incrementally — valid even when
        the bounded ``records`` ring has dropped early steps)."""
        if self.step_num == 0:
            return {"meter": self.name, "steps": 0}
        out: Dict[str, Any] = {"meter": self.name, "steps": self.step_num,
                               "total_s": round(self._total_dt, 4),
                               "wall_time": time.time()}
        ident = runtime.identity()
        if ident.get("rank") is not None:
            out["rank"] = ident["rank"]
        if ident.get("replica"):
            out["replica"] = ident["replica"]
        if self._total_dt > 0:
            if self.tokens_per_step:
                out["tokens_per_s"] = round(
                    self.tokens_per_step * self.step_num / self._total_dt, 2)
            if self.flops_per_step:
                out["mfu"] = self.flops_per_step * self.step_num \
                    / self._total_dt / (self.peak_tflops * 1e12)
        # peak is the allocator's high-water mark (since the process began or
        # torch.cuda.reset_peak_memory_stats); hbm_live_max_gb is the max live
        # sample within THIS meter's steps — the per-run attributable number
        out["hbm_peak_gb"] = self._hbm_peak_gb
        out["hbm_live_max_gb"] = self._hbm_live_max_gb
        out["collective_bytes"] = dict(self._coll_agg)
        out["steps_skipped"] = self.steps_skipped
        frac = self._overlap_fraction()
        if frac is not None:
            out["overlap_fraction"] = round(frac, 4)
        if self._first_loss is not None:
            out["first_loss"] = self._first_loss
            out["final_loss"] = self._last_loss
        # SDC defense aggregates (schema-additive: the keys appear only
        # once the monitor has actually checked something this process)
        cnt = runtime.counters()
        if cnt.get("sdc_checks_total"):
            out["sdc_checks"] = int(cnt["sdc_checks_total"])
            out["sdc_mismatches"] = int(cnt.get("sdc_mismatch_total", 0))
        return out
