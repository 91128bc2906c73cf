"""RewindLedger: persistent record of health-triggered rewinds.

When the health guard escalates it exits 101 so the restart ``Supervisor``
relaunches the job from ``latest_checkpoint(root)``. Without memory of WHY
it rewound, the restarted run replays exactly the batches that poisoned it
and spikes again — a rewind loop. The ledger closes that hole: each
escalation appends one entry naming the poisoned data window (the steps
between the resume anchor — the last committed checkpoint — and the
escalation step) before the process exits; the restarted run reads it back
and fast-forwards the sampler past the window instead of replaying it.

Persistence rides the checkpoint commit protocol's storage seam
(:mod:`..checkpoint.storage`): bytes go through ``write_bytes`` — the same
retry/backoff + fault-injection path every shard write takes, individually
atomic (``.part`` temp + ``os.replace``) — so a crash mid-append can never
leave a torn ledger. The file lives next to the checkpoints
(``<root>/rewind_ledger.json``, plain JSON for post-mortems); checkpoint
saves additionally stamp the guard's counters into the ``COMMITTED``
marker via ``save_state_dict(..., commit_extra=...)``.

Repeated rewinds anchored at the same step mean skipping the window did
not cure the run — something systemic (bad optimizer state, a data shard
of garbage wider than the window) — and :meth:`RewindLedger.check_restart`
fails loudly with :class:`HealthError` naming the window instead of
burning the restart budget.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

__all__ = ["HealthError", "RewindLedger", "LEDGER_NAME"]

LEDGER_NAME = "rewind_ledger.json"


class HealthError(RuntimeError):
    """Raised when the health guard cannot make progress: the run keeps
    rewinding into the same data window. Deliberately NOT exit code 101 —
    the supervisor must treat it as fatal, not relaunch."""


class RewindLedger:
    """Append-only JSON ledger of rewinds under a checkpoint root.

    ``root=None`` keeps the ledger in memory only (bench / unit tests —
    counters without a filesystem footprint)."""

    def __init__(self, root: Optional[str] = None):
        self.root = root
        self.path = os.path.join(root, LEDGER_NAME) if root else None
        self._entries: Optional[List[Dict[str, Any]]] = None if root else []

    # -- I/O ---------------------------------------------------------------
    def entries(self) -> List[Dict[str, Any]]:
        if self._entries is None:
            self._entries = self._load()
        return self._entries

    def _load(self) -> List[Dict[str, Any]]:
        if self.path is None or not os.path.isfile(self.path):
            return []
        try:
            with open(self.path) as f:
                doc = json.load(f)
            return list(doc.get("rewinds", []))
        except (OSError, ValueError) as e:
            # an unreadable ledger must not block resume; losing skip
            # history degrades to replaying the window once
            import sys

            sys.stderr.write(f"[health] rewind ledger {self.path!r} "
                             f"unreadable ({e!r}); starting fresh\n")
            return []

    def _flush(self) -> None:
        if self.path is None:
            return
        from ..checkpoint import storage

        os.makedirs(self.root, exist_ok=True)
        doc = {"version": 1, "rewinds": self.entries()}
        # write_bytes is already atomic (.part temp + os.replace) and
        # retried — one call gives the crash-safety this file needs
        storage.write_bytes(self.path, json.dumps(doc, indent=1).encode(),
                            op="write")

    # -- recording ---------------------------------------------------------
    def record(self, *, step: int, resume_step: int, reason: str,
               **detail) -> Dict[str, Any]:
        """Append one rewind entry (called by the guard right before it
        exits 101) and persist. The poisoned window is
        ``[resume_step, step]`` — the steps the restarted run would replay."""
        entry = {
            "step": int(step),
            "resume_step": int(resume_step),
            "window": [int(resume_step), int(step)],
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
        }
        if detail:
            entry.update(detail)
        self.entries().append(entry)
        self._flush()
        return entry

    # -- restart-side queries ----------------------------------------------
    def rewinds_at(self, resume_step: int) -> List[Dict[str, Any]]:
        return [e for e in self.entries()
                if e.get("resume_step") == int(resume_step)]

    def skip_ahead(self, resume_step: int) -> int:
        """Batches the restarted run should fast-forward past: the widest
        poisoned window anchored at this resume step (0 when none)."""
        ends = [e["step"] for e in self.rewinds_at(resume_step)]
        return max(0, max(ends) - int(resume_step)) if ends else 0

    def poisoned(self, step: int) -> bool:
        """True when ``step`` falls inside any recorded poisoned window
        ``(resume_step, step]`` — the snapshot resolution ladder
        (:func:`~..checkpoint.snapshot.resume`) consults this so an
        in-memory snapshot generation captured between a rewind's anchor
        and its escalation is never resumed into: those snapshots hold the
        very state the rewind exists to discard."""
        s = int(step)
        return any(e["window"][0] < s <= e["window"][1]
                   for e in self.entries() if e.get("window"))

    def check_restart(self, resume_step: int,
                      max_rewinds: int = 2) -> int:
        """Validate that restarting at ``resume_step`` can make progress
        and return the number of batches to skip. Raises
        :class:`HealthError` when this step has already been rewound to
        ``max_rewinds`` times — the skip didn't cure the run."""
        prior = self.rewinds_at(resume_step)
        if len(prior) >= max_rewinds:
            last = prior[-1]
            raise HealthError(
                f"training has rewound to step {resume_step} "
                f"{len(prior)} times (limit {max_rewinds}); last poisoned "
                f"window {last['window']} ({last['reason']!r}) — skipping "
                f"past it did not restore health. Refusing to relaunch "
                f"into the same divergence; inspect the flight-recorder "
                f"dumps and the data window before resuming.")
        return self.skip_ahead(resume_step)

    def __len__(self) -> int:
        return len(self.entries())
