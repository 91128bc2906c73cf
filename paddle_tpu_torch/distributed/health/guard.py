"""HealthGuard: detect → decide → recover for numerical training health
(port of the reference's ``distributed/health/guard.py``).

The state machine that closes the loop the restart layer leaves open: the
process can survive crashes, but nothing stopped a live process from
training on poisoned state. Three layers:

1. **Detect** — a probe that ``jit.TrainStep`` computes on the device (the
   finiteness of the loss and of every raw gradient, and the global
   gradient norm); a non-finite step is SKIPPED on the device (the fused
   AdamW kernel returns before it loads anything, a plain rule selects the
   old values back, the forward's in-place buffers are restored), so it
   never touches params/opt-state/buffers; plus the host-side
   :class:`SpikeDetector` over the same loss/grad-norm values StepMeter
   records.
2. **Decide** — :class:`HealthPolicy`: skip the step and count it,
   escalate after ``escalate_after`` anomalies inside a ``window``-step
   span, de-escalate (clear the anomaly record) after ``cooldown``
   consecutive healthy steps.
3. **Recover** — on escalation: ``health_rewind`` flight-recorder event,
   recorder dump, a :class:`~.ledger.RewindLedger` entry naming the
   poisoned data window, then ``SystemExit(101)`` so the
   ``Supervisor`` relaunches and the child resumes from
   ``latest_checkpoint(root)``; :meth:`HealthGuard.on_restart` reads the
   ledger, fast-forwards the sampler past the window, and fails loudly
   (:class:`~.ledger.HealthError`) when the run keeps rewinding to the
   same step.

Host-sync discipline: the probe is a 3-float device tensor, copied
without blocking into pinned host memory with one CUDA event behind it
(:func:`stage_probe`); the guard resolves it ``max_lag`` steps late
(default 2), by which time the step has long finished — so a healthy run
pays no added device→host synchronization and the card's queue never
drains. A probe whose event is not done when its turn comes is waited for
on that event alone, and counted (:func:`probe_event_waits`). ``max_lag=0``
is the synchronous mode (tests, debugging). Device-side skip is immediate
regardless of lag — only the host-side *decisions* (spike detection,
escalation) trail by ``max_lag`` steps, and a rewind lands on the last
committed checkpoint anyway.

Env: ``PADDLE_TPU_HEALTH=0`` disables the guard (TrainStep falls back to
the unguarded step).
"""

from __future__ import annotations

import math
import os
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from .detector import SpikeDetector
from .ledger import HealthError, RewindLedger

__all__ = ["HealthPolicy", "HealthGuard", "REWIND_EXIT_CODE", "stage_probe",
           "probe_event_waits"]

# numerically equal to fleet.elastic.ELASTIC_EXIT_CODE — the supervisor
# relaunches on it; duplicated here so the guard imports nothing heavy
REWIND_EXIT_CODE = 101


_event_waits = [0]


def probe_event_waits() -> int:
    """How many times a probe's turn came before its copy to the host was
    done, so that resolving it waited on its CUDA event (the only wait a
    guarded step may make)."""
    return _event_waits[0]


# pinned host buffers of resolved probes, by (shape, dtype), for reuse
_pinned: Dict[Any, list] = {}


class HostProbe:
    """One step's probe on its way to the host: a card tensor is copied
    without blocking into a pinned host buffer (reused once its probe is
    read) and a CUDA event is recorded behind the copy; a CPU tensor is
    already there.  :meth:`values` reads it once (the guard and the SDC
    monitor share one handle)."""

    __slots__ = ("_host", "_event", "_vals", "_key")

    def __init__(self, probe: torch.Tensor):
        probe = probe.detach()
        self._event = self._vals = self._key = None
        if probe.is_cuda:
            self._key = (tuple(probe.shape), probe.dtype)
            free = _pinned.get(self._key)
            self._host = free.pop() if free else torch.empty(
                probe.shape, dtype=probe.dtype, pin_memory=True)
            self._host.copy_(probe, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = probe

    def values(self) -> np.ndarray:
        if self._vals is None:
            if self._event is not None and not self._event.query():
                _event_waits[0] += 1
                self._event.synchronize()
            self._vals = np.array(self._host.float().numpy(), copy=True)
            if self._key is not None:        # the copy is done: the buffer is free
                _pinned.setdefault(self._key, []).append(self._host)
            self._host = self._event = None
        return self._vals


def stage_probe(probe) -> "HostProbe":
    """``probe`` (a tensor, or a :class:`HostProbe` already) on its way to
    the host."""
    return probe if isinstance(probe, HostProbe) else HostProbe(probe)


def _probe_values(probe) -> np.ndarray:
    if isinstance(probe, HostProbe):
        return probe.values()
    if isinstance(probe, torch.Tensor):
        return HostProbe(probe).values()
    return np.asarray(probe, dtype=np.float32)


@dataclass
class HealthPolicy:
    """Knobs of the decide layer (see module docstring).

    ``escalate_after`` anomalies within ``window`` steps trigger a rewind;
    ``cooldown`` consecutive healthy steps clear the anomaly record.
    ``max_lag`` bounds how many steps the host-side verdict may trail the
    device (0 = synchronous). ``max_rewinds_per_window`` is the restart
    budget per resume anchor before :class:`HealthError`."""

    escalate_after: int = 3
    window: int = 50
    cooldown: int = 20
    max_lag: int = 2
    max_rewinds_per_window: int = 2
    # detector knobs (forwarded to SpikeDetector unless one is injected)
    spike_window: int = 128
    min_history: int = 20
    loss_zmax: float = 6.0
    grad_zmax: float = 6.0
    ema_alpha: Optional[float] = None


class HealthGuard:
    """Wires the three layers together for one training process.

    usage::

        guard = HealthGuard(HealthPolicy(), root=ckpt_root)
        resume = latest_checkpoint(ckpt_root)
        if resume:
            load_state_dict(state, resume)
            # raises HealthError on a rewind loop; else fast-forwards
            guard.on_restart(resume_step, sampler=batch_sampler)
        step = TrainStep(model, loss_fn, opt, health_guard=guard)
        for x, y in loader:
            loss = step(x, y)          # may raise SystemExit(101)
            ...
            save_state_dict(state, path, commit_extra=guard.commit_extra())
            guard.note_checkpoint(cur_step)

    ``on_escalate``: ``"exit"`` (default — ``SystemExit(101)`` for the
    supervisor), ``"raise"`` (:class:`HealthError`, in-process callers),
    or a callable receiving the ledger entry."""

    def __init__(self, policy: Optional[HealthPolicy] = None, *,
                 root: Optional[str] = None, name: str = "train",
                 detector: Optional[SpikeDetector] = None,
                 on_escalate: Union[str, Callable[[dict], None]] = "exit"):
        self.policy = policy or HealthPolicy()
        self.name = name
        self.ledger = RewindLedger(root)
        p = self.policy
        self.detector = detector or SpikeDetector(
            window=p.spike_window, min_history=p.min_history,
            loss_zmax=p.loss_zmax, grad_zmax=p.grad_zmax,
            ema_alpha=p.ema_alpha)
        self.on_escalate = on_escalate
        self.active = os.environ.get("PADDLE_TPU_HEALTH", "1") not in (
            "0", "false")
        # counters (mirrored into telemetry gauges and commit_extra)
        self.steps_seen = 0
        self.steps_skipped = 0
        self.anomalies = 0
        self.rewinds = len(self.ledger)
        self.last_loss: Optional[float] = None
        self.last_grad_norm: Optional[float] = None
        self._resume_anchor = 0
        self._step0 = 0
        self._local_steps = 0
        self._last_step = 0
        self._anomaly_steps: deque = deque()
        self._clean_streak = 0
        self._pending: deque = deque()  # (step, device probe array)

    def _norm_step(self, step: Optional[int]) -> int:
        """Strictly monotonic global step number. A caller whose counter
        restarted below the resume point (fresh optimizer/meter after a
        relaunch) would write nonsense ledger windows and negative window
        deltas, so the normalized step is the max of: restart point +
        calls since restart, last normalized step + 1, and the caller's
        own counter — it tracks a well-behaved restored counter exactly
        and can never jump backward."""
        self._local_steps += 1
        cand = max(self._step0 + self._local_steps, self._last_step + 1,
                   int(step) if step is not None else 0)
        self._last_step = cand
        return cand

    # -- lifecycle hooks ---------------------------------------------------
    def note_checkpoint(self, step: int) -> None:
        """The training loop committed a checkpoint at ``step`` — rewinds
        escalated after this land there, so the poisoned-window anchor
        moves forward."""
        self._resume_anchor = int(step)

    def on_restart(self, resume_step: int, sampler=None) -> int:
        """Restart-side entry: validate against the ledger (raises
        :class:`HealthError` on a rewind loop), fast-forward ``sampler``
        past the poisoned window, and return the number of skipped
        batches."""
        self._resume_anchor = int(resume_step)
        self._step0 = self._last_step = int(resume_step)
        self._local_steps = 0
        skip = self.ledger.check_restart(
            resume_step, max_rewinds=self.policy.max_rewinds_per_window)
        if skip and sampler is not None:
            sampler.fast_forward(skip)
        if skip:
            self._record_event("health_fast_forward", resume_step=resume_step,
                               skipped_batches=skip)
        return skip

    def commit_extra(self) -> Dict[str, Any]:
        """Health counters for the checkpoint ``COMMITTED`` marker (ride
        ``save_state_dict(..., commit_extra=...)``) — a post-mortem can
        read a checkpoint's health story without the telemetry files."""
        return {"health": {"steps_seen": self.steps_seen,
                           "steps_skipped": self.steps_skipped,
                           "anomalies": self.anomalies,
                           "rewinds": self.rewinds}}

    # -- device-probe path (TrainStep) ------------------------------------
    def on_step(self, probe, step: Optional[int] = None) -> None:
        """Feed one guarded step's probe (a tensor ``[loss, finite,
        grad_norm]`` on the device, or its :class:`HostProbe`). Resolves
        probes older than ``policy.max_lag`` steps — by then the device
        finished them, so the fetch is free."""
        if not self.active:
            return
        self._pending.append((self._norm_step(step), stage_probe(probe)))
        while len(self._pending) > max(0, self.policy.max_lag):
            self._resolve(*self._pending.popleft())

    def flush(self) -> None:
        """Resolve every pending probe now (end of epoch / before a
        checkpoint decision / tests)."""
        while self._pending:
            self._resolve(*self._pending.popleft())

    def _resolve(self, step: int, probe) -> None:
        vals = _probe_values(probe)  # 3 floats, the step long done
        self._observe(step, float(vals[0]), bool(vals[1] >= 0.5), float(vals[2]))

    # -- host-side feeds ---------------------------------------------------
    def observe_host(self, step: int, loss: Optional[float],
                     grad_norm: Optional[float] = None) -> None:
        """Eager-loop feed (no compiled probe): the same values StepMeter
        records. Non-finite loss counts as an anomaly but the step was
        already applied — only the escalation layer can undo it."""
        if not self.active:
            return
        finite = loss is None or math.isfinite(float(loss))
        self._observe(self._norm_step(step),
                      float("nan") if loss is None else float(loss),
                      finite, grad_norm, skipped=False)

    def note_scaler_skip(self, scale: Optional[float] = None) -> None:
        """AmpScaler found-inf skip: the optimizer step was withheld by the
        scaler — route it into the same skip counter and anomaly window."""
        if not self.active:
            return
        # same normalized step domain as the device/host feeds, so scaler
        # anomalies window and ledger consistently with the others
        step = self._norm_step(None)
        self.steps_seen += 1
        self.steps_skipped += 1
        self._bump_counters()
        self._record_event("health_skip", step=step, source="amp_scaler",
                           scale=scale)
        self._push_anomaly(step, "amp_found_inf")

    # -- decide ------------------------------------------------------------
    def _observe(self, step: int, loss: float, finite: bool,
                 grad_norm: Optional[float], skipped: Optional[bool] = None) \
            -> None:
        self.steps_seen += 1
        self.last_loss = loss
        self.last_grad_norm = grad_norm
        if not finite:
            if skipped is None or skipped:  # device probe: update withheld
                self.steps_skipped += 1
                self._record_event("health_skip", step=step,
                                   source="train_step", loss=repr(loss),
                                   grad_norm=repr(grad_norm))
            self._bump_counters()
            self._push_anomaly(step, "non_finite")
            return
        reason = self.detector.observe(loss=loss, grad_norm=grad_norm)
        self._bump_counters()
        if reason is not None:
            self._record_event("health_anomaly", step=step, reason=reason,
                               loss=loss, grad_norm=grad_norm)
            self._push_anomaly(step, reason)
        else:
            self._clean_streak += 1
            if self._clean_streak >= self.policy.cooldown:
                self._anomaly_steps.clear()

    def _push_anomaly(self, step: int, reason: str) -> None:
        self.anomalies += 1
        self._clean_streak = 0
        self._anomaly_steps.append(step)
        while self._anomaly_steps and \
                step - self._anomaly_steps[0] > self.policy.window:
            self._anomaly_steps.popleft()
        if len(self._anomaly_steps) >= self.policy.escalate_after:
            self.escalate(step, reason)

    # -- recover -----------------------------------------------------------
    def escalate(self, step: int, reason: str) -> None:
        """K anomalies in the window: record the poisoned window, dump the
        flight recorder, and exit for the supervisor to rewind."""
        entry = self.ledger.record(
            step=step, resume_step=self._resume_anchor, reason=reason,
            anomalies_in_window=len(self._anomaly_steps),
            steps_skipped=self.steps_skipped,
            last_loss=repr(self.last_loss))
        self.rewinds += 1
        self._anomaly_steps.clear()
        self._record_event("health_rewind", step=step, reason=reason,
                           window=entry["window"],
                           resume_step=entry["resume_step"])
        dump = ""
        try:
            from ... import telemetry

            dump = telemetry.dump_flight_recorder(reason="health_rewind")
        except Exception:
            pass
        if callable(self.on_escalate):
            # the handler OWNS the recovery decision (may continue training
            # in-process): no gang poison — poisoning here would os._exit
            # every rank, this one included, out from under the callback
            self.on_escalate(dict(entry, flight_recorder_dump=dump))
            return
        if self.on_escalate == "raise":
            raise HealthError(
                f"health guard escalated at step {step} ({reason}); "
                f"poisoned window {entry['window']}")
        try:
            # default exit path: this rank is about to leave with 101 — a
            # health escalation is gang-fatal (every rank must rewind to the
            # same checkpoint), so poison the epoch (first writer wins) so
            # siblings exit within the poison deadline instead of wedging
            # in the next collective
            from ..fleet import fault_domain as _fd

            _fd.poison_current("health_escalation",
                               detail=f"step {step}: {reason}")
        except Exception:
            pass
        raise SystemExit(REWIND_EXIT_CODE)

    # -- telemetry plumbing ------------------------------------------------
    def _bump_counters(self) -> None:
        try:
            from ... import telemetry

            telemetry.set_gauge("health_steps_skipped", self.steps_skipped)
            telemetry.set_gauge("health_anomalies", self.anomalies)
            telemetry.set_gauge("health_rewinds", self.rewinds)
        except Exception:
            pass

    def _record_event(self, kind: str, **data) -> None:
        try:
            from ... import telemetry

            telemetry.record_event(kind, self.name, **data)
        except Exception:
            pass
