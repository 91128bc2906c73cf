"""Degraded-hardware defense: straggler confirmation, chip-vs-link
localization, slow-rank remediation ladder.

Every failure class below this one is binary — a rank is dead (lease
expiry), wedged (watchdog), corrupt (SDC vote) or overloaded (admission
control).  The dominant availability killer at pod scale is none of
those: an *alive-but-slow* chip (downclocked HBM, a thermally throttled
core) or a degraded ICI link drags every synchronous collective down to
the straggler's pace while passing every health check.  The defense is a
detect → confirm → localize → remediate ladder with the same shape as the
SDC playbook (:mod:`.sdc`), composed over existing substrate:

1. **Detect** — per-rank step wall time rides the heartbeat payload
   (``HeartbeatLease.note_step(step, dt)`` maintains ``step_dt_ema``); the
   :class:`~..fleet.fault_domain.LeaseMonitor` flags a rank whose EMA
   exceeds the gang *median* by ``PADDLE_TPU_STRAGGLER_FACTOR`` for
   ``PADDLE_TPU_STRAGGLER_SCANS`` consecutive scans.  No new threads, no
   extra host sync — detection is a comparison inside the scan the
   monitor already runs, and median-relative means a uniformly slow gang
   (big model, cold caches) never flags anyone.  The flag is broadcast
   through the fleet store (``straggler/flag/<epoch>``), because the
   flagged rank does not run the monitor.

2. **Confirm & localize** — the flagged rank and ONE healthy control rank
   run short out-of-band micro-probes at their next step boundary: a
   fixed-shape matmul FLOPS probe (chip health) plus pairwise
   ring-neighbor bandwidth probes (link health), published to the fleet
   store like SDC votes (``straggler/probe/<epoch>/<seq>/<rank>``) with a
   bounded gather timeout.  Both sides classify deterministically from
   the same two docs: chip probe ≥ ``factor`` × control's → **chip-slow**;
   else one neighbor link ≥ ``factor`` × the other → **link-slow**; else
   **transient** (load spike, host GC).  Probes only run when flagged —
   the healthy-path overhead is the EMA arithmetic plus one store poll
   every ``every`` steps.

3. **Remediate** — transient: counted + observed (the monitor will
   re-flag a recurrence).  Sticky chip-slow: the SDC quarantine path
   verbatim — :class:`~.ledger.RewindLedger` window, flight-recorder
   dump, ``FaultDomain.poison("straggler_suspect", culprit=rank)``, exit
   101; the ``FleetSupervisor`` answers with an exclude-list relaunch
   minus the slot (fresh budget, ``min_procs`` floor).  Sticky link-slow:
   the gang is poisoned ``"straggler_link"`` with the degraded pair in
   the pill; the supervisor relaunches with a **device-order permutation**
   that routes ring-neighbor traffic around the link (a launch-time env —
   ``PADDLE_TPU_DEVICE_ORDER`` — not a recompile; the ring programs take
   ring position as an input), falling back to exclusion when no
   permutation avoids the pair.  No slot is lost for a link.

Chaos is driven by the ``slow`` fault family in ``checkpoint/faults.py``:
the step path fires ``("slow_step", f"rank{r}")``, the probe fires
``("slow_step", f"rank{r}/probe")`` and the collective/link path fires
``("slow_collective", f"link{a}-{b}")`` — an armed seeded delay is the
SIGSTOP-free way to make one rank (or one link) N× slow.

Knobs: ``PADDLE_TPU_STRAGGLER=0`` disables the confirm/remediate ladder
(detection events still fire); ``PADDLE_TPU_STRAGGLER_FACTOR`` (default
2.0) is the shared detect/classify threshold;
``PADDLE_TPU_STRAGGLER_SCANS`` (default 3) the consecutive-scan
hysteresis; ``PADDLE_TPU_STRAGGLER_EVERY`` (default 8) the flag-poll
cadence in steps; ``PADDLE_TPU_STRAGGLER_PROBE_ITERS`` /
``PADDLE_TPU_STRAGGLER_PROBE_TIMEOUT`` size the micro-probe.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .ledger import HealthError, RewindLedger

__all__ = ["StragglerPolicy", "StragglerMonitor", "classify_probes",
           "straggler_enabled", "STRAGGLER_POISON_REASON",
           "STRAGGLER_LINK_REASON", "STRAGGLER_EXIT_CODE"]

STRAGGLER_POISON_REASON = "straggler_suspect"
STRAGGLER_LINK_REASON = "straggler_link"
# numerically equal to the SDC/elastic/fleet exit — every rung of the
# resilience stack exits 101 so the supervisor relaunches
STRAGGLER_EXIT_CODE = 101

_EPS = 1e-9


def straggler_enabled() -> bool:
    return os.environ.get("PADDLE_TPU_STRAGGLER", "1") not in ("0", "false")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


@dataclass
class StragglerPolicy:
    """Knobs of the straggler ladder (see module docstring)."""

    factor: float = 2.0      # detect + classify threshold (× gang median)
    scans: int = 3           # consecutive over-factor scans before a flag
    every: int = 8           # flag-poll cadence on the step path (steps)
    probe_iters: int = 3     # micro-probe repetitions (min is kept)
    probe_timeout: float = 10.0  # bound on the probe-doc gather (seconds)
    seed: int = 0x51077      # seeds the probe workload

    @classmethod
    def from_env(cls) -> "StragglerPolicy":
        return cls(
            factor=max(1.0, _env_float("PADDLE_TPU_STRAGGLER_FACTOR", 2.0)),
            scans=max(1, _env_int("PADDLE_TPU_STRAGGLER_SCANS", 3)),
            every=max(1, _env_int("PADDLE_TPU_STRAGGLER_EVERY", 8)),
            probe_iters=max(
                1, _env_int("PADDLE_TPU_STRAGGLER_PROBE_ITERS", 3)),
            probe_timeout=_env_float(
                "PADDLE_TPU_STRAGGLER_PROBE_TIMEOUT", 10.0))


# -- telemetry plumbing ------------------------------------------------------

def _bump(name: str, n: float = 1.0) -> None:
    try:
        from ... import telemetry

        telemetry.bump(name, n)
    except Exception:
        pass


def _record_event(kind: str, name: str, **data) -> None:
    try:
        from ... import telemetry

        telemetry.record_event(kind, name, **data)
    except Exception:
        pass


# -- micro-probes ------------------------------------------------------------
#
# Both probes announce themselves through the fault injector's ``slow``
# seams, so the same armed spec that degrades the training step degrades
# the probe — a sticky fault confirms, a lifted one reads transient.

def _fire_slow(op: str, path: str) -> None:
    try:
        from ..checkpoint import faults

        faults.fire(op, path)
    except Exception:
        pass


def default_chip_probe(rank: int, iters: int = 3, n: int = 128,
                       seed: int = 0x51077) -> float:
    """Fixed-shape host matmul FLOPS probe: seconds for one ``n×n @ n×n``
    (best of ``iters`` — the min strips scheduler noise, which is exactly
    what a *sticky* slow chip cannot hide from)."""
    import numpy as np

    a = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    best = float("inf")
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        _fire_slow("slow_step", f"rank{rank}/probe")
        float((a @ a).sum())
        best = min(best, time.perf_counter() - t0)
    return best


def default_link_probe(rank: int, peer: int, iters: int = 3,
                       nbytes: int = 1 << 16) -> float:
    """Pairwise ring-neighbor bandwidth probe: seconds to push ``nbytes``
    through the ``link<lo>-<hi>`` seam (best of ``iters``).  Real
    hardware would run a 2-rank ppermute here; the CPU repro times the
    injector seam plus a copy, which is what the chaos tests degrade."""
    lo, hi = sorted((int(rank), int(peer)))
    payload = bytes(min(nbytes, 1 << 16))
    best = float("inf")
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        _fire_slow("slow_collective", f"link{lo}-{hi}")
        bytearray(payload)  # the copy stands in for the wire transfer
        best = min(best, time.perf_counter() - t0)
    return best


def ring_neighbors(rank: int, world_size: int) -> Tuple[int, int]:
    """(prev, next) on the default ring ordering."""
    return ((rank - 1) % world_size, (rank + 1) % world_size)


def pick_control(flagged: int, world_size: int) -> int:
    """Deterministic healthy control rank: the lowest rank that is neither
    the flagged rank nor one of its ring neighbors (neighbors share the
    possibly-degraded link), falling back to any non-flagged rank."""
    prev, nxt = ring_neighbors(flagged, world_size)
    cands = [r for r in range(world_size) if r != flagged]
    non_adj = [r for r in cands if r not in (prev, nxt)]
    return (non_adj or cands)[0]


def classify_probes(flagged_doc: Dict[str, Any],
                    control_doc: Dict[str, Any],
                    factor: float) -> Tuple[str, Dict[str, Any]]:
    """Deterministic verdict from the two published probe docs —
    ``("chip" | "link" | "transient", detail)``.  Chip is checked first
    (a slow chip also slows its link probes, so the order matters): the
    flagged rank's matmul time ≥ ``factor`` × the control's names the
    chip.  Otherwise, one neighbor link ≥ ``factor`` × the other names
    that link (both measurements ran on the same — now exonerated —
    chip).  Anything else is transient: the load spike that tripped the
    EMA has passed, or degradation is symmetric enough that no single
    component can be named."""
    chip = float(flagged_doc.get("chip_s") or 0.0)
    ref = float(control_doc.get("chip_s") or 0.0)
    ratio = chip / max(ref, _EPS)
    if ref > 0 and ratio >= factor:
        return "chip", {"chip_s": chip, "control_chip_s": ref,
                        "ratio": round(ratio, 3)}
    links = {int(k): float(v)
             for k, v in (flagged_doc.get("link_s") or {}).items()}
    if len(links) >= 2:
        slow_peer = max(links, key=links.get)
        fast_peer = min(links, key=links.get)
        link_ratio = links[slow_peer] / max(links[fast_peer], _EPS)
        if link_ratio >= factor:
            return "link", {"peer": slow_peer,
                            "link_s": links[slow_peer],
                            "other_link_s": links[fast_peer],
                            "ratio": round(link_ratio, 3)}
    return "transient", {"chip_ratio": round(ratio, 3),
                         "link_s": {str(k): round(v, 6)
                                    for k, v in links.items()}}


# -- the monitor -------------------------------------------------------------

class StragglerMonitor:
    """Rank-side half of the straggler ladder for one training process.

    ``on_step(step, dt)`` is the only hot-path hook: it stamps the step
    (and wall time) into the heartbeat lease via the domain and — every
    ``policy.every`` steps — polls the fleet store for a slow-rank flag.
    When a flag names an unhandled episode, the flagged rank and the
    control rank publish micro-probe results, gather each other's with a
    bounded timeout, classify, and the FLAGGED rank remediates:

    - ``transient`` → counted (``straggler_transient`` event), no action;
    - ``chip``      → ledger window + flight-recorder dump +
      ``poison("straggler_suspect", culprit)`` + ``SystemExit(101)``;
    - ``link``      → ``poison("straggler_link", culprit, link=[a, b])``
      + ``SystemExit(101)`` (no ledger window — a slow link computes
      CORRECT numbers; nothing needs rewinding beyond the normal resume).

    ``domain`` is a :class:`~..fleet.fault_domain.FaultDomain`;
    ``probe_fn(rank) -> seconds`` / ``link_probe_fn(rank, peer) ->
    seconds`` are injectable (tests route them through armed faults or
    canned timings).  ``on_suspect``: ``"exit"`` (default), ``"raise"``
    (:class:`HealthError`), or a callable receiving the suspect doc.
    """

    def __init__(self, policy: Optional[StragglerPolicy] = None, *,
                 domain: Any = None,
                 ledger: Optional[RewindLedger] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 probe_fn: Optional[Callable[[int], float]] = None,
                 link_probe_fn: Optional[Callable[[int, int], float]] = None,
                 on_suspect: Union[str, Callable[[dict], None]] = "exit",
                 name: str = "train"):
        self.policy = policy or StragglerPolicy.from_env()
        self.domain = domain
        self.rank = int(rank) if rank is not None else \
            int(getattr(domain, "rank", 0) or 0)
        self.world_size = int(world_size) if world_size is not None else \
            int(getattr(domain, "world_size", 1) or 1)
        self.epoch = int(getattr(domain, "epoch", 0) or 0)
        self._kv = getattr(domain, "_kv", None)
        self.ledger = ledger
        self.probe_fn = probe_fn
        self.link_probe_fn = link_probe_fn
        self.on_suspect = on_suspect
        self.name = name
        self.active = straggler_enabled()
        # counters (tests / telemetry / post-mortems)
        self.checks = 0
        self.probes_run = 0
        self.transients = 0
        self.chip_suspects = 0
        self.link_suspects = 0
        self.votes_incomplete = 0
        self.last_verdict: Optional[Dict[str, Any]] = None
        self._handled_seqs: set = set()
        self._ckpt_steps: List[int] = [0]
        self._last_step = 0

    # -- lifecycle hooks ---------------------------------------------------
    def note_checkpoint(self, step: int) -> None:
        """A snapshot/checkpoint generation committed at ``step`` — the
        newest one is the chip-slow remediation's resume anchor (a slow
        chip computes CORRECT numbers, so unlike SDC nothing behind the
        newest generation is suspect)."""
        self._ckpt_steps.append(int(step))

    def resume_anchor(self) -> int:
        return max(self._ckpt_steps)

    # -- hot path ----------------------------------------------------------
    def on_step(self, step: int, dt: Optional[float] = None) -> None:
        """Per-step hook: stamp progress + wall time into the lease, and
        at ``policy.every`` cadence check for a slow-rank flag.  Cheap by
        construction — the stamp rides the existing heartbeat, the flag
        check is one store get."""
        s = int(step)
        self._last_step = max(self._last_step, s)
        if self.active:
            # chaos seam: an armed ("slow_step", "rank<r>") delay fault
            # makes THIS rank's next measured step wall time longer, which
            # is exactly how a degraded chip presents
            _fire_slow("slow_step", f"rank{self.rank}")
        if self.domain is not None:
            try:
                self.domain.note_step(s, dt=dt)
            except TypeError:  # pre-dt domain (rolling upgrade)
                self.domain.note_step(s)
        if not self.active or self._kv is None or self.world_size <= 1:
            return
        if s % max(1, self.policy.every):
            return
        self.checks += 1
        flag = self._read_flag()
        if flag is None:
            return
        seq = int(flag.get("seq") or 0)
        if seq in self._handled_seqs:
            return
        self._handled_seqs.add(seq)
        self._handle_flag(flag, seq)

    # -- flag / probe protocol ---------------------------------------------
    def _flag_key(self) -> str:
        return f"straggler/flag/{self.epoch}"

    def _probe_key(self, seq: int, rank: int) -> str:
        return f"straggler/probe/{self.epoch}/{int(seq)}/{int(rank)}"

    def _read_flag(self) -> Optional[dict]:
        try:
            doc = self._kv.get(self._flag_key())
        except Exception:
            return None
        return doc if isinstance(doc, dict) else None

    def _handle_flag(self, flag: dict, seq: int) -> None:
        flagged = int(flag.get("rank", -1))
        if not (0 <= flagged < self.world_size):
            return
        control = pick_control(flagged, self.world_size)
        _record_event("straggler_flag_seen", self.name, rank=self.rank,
                      flagged=flagged, control=control, seq=seq,
                      ema_s=flag.get("ema_s"), median_s=flag.get("median_s"))
        if self.rank not in (flagged, control):
            return  # bystander: the pill (if any) will reach us via poll
        self._run_probe(flagged, control, seq)

    def _run_probe(self, flagged: int, control: int, seq: int) -> None:
        """Publish this rank's micro-probe doc, gather the other
        participant's, classify, and (on the flagged rank) remediate."""
        self.probes_run += 1
        _bump("straggler_probes_total")
        iters = self.policy.probe_iters
        doc: Dict[str, Any] = {"rank": self.rank,
                               "chip_s": self._chip_probe(iters)}
        if self.rank == flagged and self.world_size >= 3:
            prev, nxt = ring_neighbors(flagged, self.world_size)
            doc["link_s"] = {str(p): self._link_probe(p, iters)
                             for p in dict.fromkeys((prev, nxt))}
        try:
            self._kv.put(self._probe_key(seq, self.rank), doc)
        except Exception:
            return
        docs = self._gather(seq, (flagged, control))
        if docs is None:
            # the other participant hasn't published yet (it may see the
            # flag one poll later than we did) — un-handle the episode so
            # the next cadence poll retries; our doc stays in the store,
            # so the retry converges as soon as both sides have published
            self.votes_incomplete += 1
            self._handled_seqs.discard(seq)
            _record_event("straggler_probe", self.name, rank=self.rank,
                          flagged=flagged, seq=seq, complete=False,
                          timeout=self.policy.probe_timeout)
            return
        verdict, detail = classify_probes(docs[flagged], docs[control],
                                          self.policy.factor)
        self.last_verdict = {"seq": seq, "flagged": flagged,
                             "verdict": verdict, "detail": detail}
        _record_event("straggler_probe", self.name, rank=self.rank,
                      flagged=flagged, seq=seq, complete=True,
                      verdict=verdict, **detail)
        if self.rank != flagged:
            return  # control: observed; remediation is the culprit's move
        if verdict == "transient":
            self.transients += 1
            _bump("straggler_transient_total")
            _record_event("straggler_transient", self.name, rank=self.rank,
                          seq=seq, **detail)
            return
        if verdict == "chip":
            self._quarantine_chip(seq, detail)
        else:
            self._quarantine_link(seq, detail)

    def _chip_probe(self, iters: int) -> float:
        if self.probe_fn is not None:
            return float(self.probe_fn(self.rank))
        return default_chip_probe(self.rank, iters=iters,
                                  seed=self.policy.seed)

    def _link_probe(self, peer: int, iters: int) -> float:
        if self.link_probe_fn is not None:
            return float(self.link_probe_fn(self.rank, peer))
        return default_link_probe(self.rank, peer, iters=iters)

    def _gather(self, seq: int,
                participants: Tuple[int, int]) -> Optional[Dict[int, dict]]:
        """Poll the store until every participant's probe doc for ``seq``
        is present, or the timeout lapses (a participant that died
        mid-probe is the lease monitor's problem — an incomplete probe is
        observed, never judged)."""
        deadline = time.monotonic() + max(0.1, self.policy.probe_timeout)
        docs: Dict[int, dict] = {}
        want = sorted(set(int(p) for p in participants))
        while True:
            for r in want:
                if r in docs:
                    continue
                try:
                    v = self._kv.get(self._probe_key(seq, r))
                except Exception:
                    v = None
                if isinstance(v, dict):
                    docs[r] = v
            if len(docs) == len(want):
                return docs
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.02)

    # -- remediation (flagged rank only) -----------------------------------
    def _quarantine_chip(self, seq: int, detail: Dict[str, Any]) -> None:
        self.chip_suspects += 1
        _bump("straggler_chip_suspects_total")
        anchor = self.resume_anchor()
        step = self._last_step
        entry: Dict[str, Any] = {"window": [anchor, int(step)]}
        if self.ledger is not None:
            entry = self.ledger.record(
                step=int(step), resume_step=anchor, reason="straggler",
                culprit=self.rank, **detail)
        doc = {"reason": STRAGGLER_POISON_REASON, "step": int(step),
               "rank": self.rank, "resume_step": anchor,
               "window": entry.get("window"), "seq": seq}
        doc.update(detail)
        _record_event("straggler_suspect", self.name, **doc)
        try:
            from ... import telemetry

            telemetry.dump_flight_recorder(reason=STRAGGLER_POISON_REASON)
        except Exception:
            pass
        if callable(self.on_suspect):
            self.on_suspect(doc)
            return
        if self.on_suspect == "raise":
            raise HealthError(
                f"straggler confirmed sticky chip-slow on rank {self.rank} "
                f"at step {step}: probe ratio {detail.get('ratio')}x the "
                f"control rank; excluding the slot")
        if self.domain is not None:
            try:
                self.domain.poison(
                    STRAGGLER_POISON_REASON, culprit=self.rank,
                    detail=f"step {step}: sticky chip-slow "
                           f"({detail.get('ratio')}x control probe)")
            except Exception:
                pass
        raise SystemExit(STRAGGLER_EXIT_CODE)

    def _quarantine_link(self, seq: int, detail: Dict[str, Any]) -> None:
        self.link_suspects += 1
        _bump("straggler_link_suspects_total")
        peer = int(detail.get("peer", -1))
        pair = sorted((self.rank, peer))
        step = self._last_step
        doc = {"reason": STRAGGLER_LINK_REASON, "step": int(step),
               "rank": self.rank, "link": pair, "seq": seq}
        doc.update(detail)
        _record_event("straggler_link", self.name, **doc)
        try:
            from ... import telemetry

            telemetry.dump_flight_recorder(reason=STRAGGLER_LINK_REASON)
        except Exception:
            pass
        if callable(self.on_suspect):
            self.on_suspect(doc)
            return
        if self.on_suspect == "raise":
            raise HealthError(
                f"straggler confirmed sticky link-slow between ranks "
                f"{pair[0]} and {pair[1]} ({detail.get('ratio')}x the other "
                f"neighbor); remapping device order around the link")
        if self.domain is not None:
            try:
                self.domain.poison(
                    STRAGGLER_LINK_REASON, culprit=self.rank,
                    detail=f"step {step}: sticky link-slow to rank {peer} "
                           f"({detail.get('ratio')}x the other neighbor)",
                    link=pair)
            except Exception:
                pass
        raise SystemExit(STRAGGLER_EXIT_CODE)
