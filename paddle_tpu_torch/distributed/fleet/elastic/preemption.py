"""Preemption-aware checkpoint + resume (port of the reference's
``distributed/fleet/elastic/preemption.py``).

Cloud VMs receive a preemption notice as SIGTERM (maintenance events
deliver the same signal through the metadata server). The reference reacts to
membership change after the fact (etcd lease expiry → ElasticManager
restart); here we can do better — catch the notice, write an async sharded
checkpoint, and exit with the elastic restart code so the relaunched job
resumes with reshard-on-load under the survivor topology.

usage::

    guard = PreemptionGuard()                      # installs SIGTERM hook
    state = {"model": model.state_dict(), "opt": opt.state_dict(),
             "step": step_holder}
    for step in range(start, total):
        loss = train_step(batch)
        if guard.preempted:
            guard.checkpoint_and_exit(state, ckpt_dir)   # exits 101
    guard.uninstall()

On restart: ``load_state_dict`` the same directory (mesh may differ) and
continue from the saved step.
"""

from __future__ import annotations

import signal
import sys
import threading
from typing import Dict, Iterable, Optional

from . import ELASTIC_EXIT_CODE

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Signal-triggered checkpoint/exit hook.

    The handler only SETS a flag — all work (device sync, file IO) happens
    in the training loop's next ``preempted`` check, where it is safe to run
    device code. ``manager`` (an ElasticManager) is detached on exit so the
    dead node leaves membership immediately instead of waiting out the TTL.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,),
                 manager=None):
        self._flag = threading.Event()
        self._prev = {}
        self.manager = manager
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame) -> None:
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:
        """Mark preemption programmatically (tests; cloud notice pollers)."""
        self._flag.set()

    def checkpoint_and_exit(self, state_dict: Dict, path: str,
                            exit_code: int = ELASTIC_EXIT_CODE,
                            extra: Optional[Dict] = None) -> None:
        """Async-save ``state_dict`` (synced before exit), dump the flight
        recorder next to the checkpoint, deregister from the elastic
        membership, and leave with the restart exit code."""
        import os

        from ...checkpoint import save_state_dict
        from ...checkpoint.save_state_dict import _wait_pending

        if extra:
            state_dict = {**state_dict, **extra}
        saved = False
        try:
            save_state_dict(state_dict, path, async_save=True)
            _wait_pending()  # the process is about to die: flush the writers
            saved = True
        except Exception as e:
            # a storage failure must not steal the restart exit code: the
            # supervisor can still relaunch into the previous committed
            # checkpoint, which beats dying "fatal" with no checkpoint at all
            import sys as _sys

            _sys.stderr.write(f"[preemption] checkpoint to {path!r} failed: "
                              f"{e!r}; exiting {exit_code} anyway\n")
        try:  # post-mortem beside the checkpoint: why did this pod leave?
            from .... import telemetry

            telemetry.record_event("preemption_exit", path,
                                   exit_code=exit_code, saved=saved)
            parent = os.path.dirname(os.path.abspath(path)) or "."
            telemetry.dump_flight_recorder(
                path=os.path.join(parent,
                                  f"flight_preempt_pid{os.getpid()}.json"),
                reason="preemption")
        except Exception:
            pass
        if self.manager is not None:
            try:
                self.manager.exit(completed=False)
            except Exception:
                pass
        self.uninstall()
        sys.exit(exit_code)

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}
