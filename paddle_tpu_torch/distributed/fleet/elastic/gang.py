"""Gang restart + elastic degrade: the fleet-level restart supervisor.

The :class:`~.supervisor.Supervisor` relaunches ONE process; on a pod the
unit of failure is the gang — when any rank dies, the launcher (with the
fault domain's coordinated abort) tears the whole gang down, and something
above it must relaunch the whole gang.  That something is
:class:`FleetSupervisor`:

- each attempt launches the full gang through ``launch.launch`` (the
  pod-per-host CLI) with a fresh **gang epoch** stamped into
  ``PADDLE_TPU_GANG_EPOCH`` — poison pills and the pre-step-0 gang barrier
  are epoch-scoped, so a stale pill can never kill the relaunch;
- ranks run a store **barrier with deadline** before step 0
  (``FaultDomain.gang_barrier``; ``PADDLE_TPU_GANG_BARRIER=1`` exported
  here), then resume from ``latest_checkpoint(ckpt_root)`` exactly like the
  single-process supervisor path;
- restarts are bounded per world size (``GangPolicy.max_gang_restarts``,
  env ``PADDLE_TPU_GANG_RESTARTS``) with the same seeded backoff as
  :class:`~.supervisor.RestartPolicy`;
- after the budget is exhausted with a persistently failing gang, the
  supervisor **degrades**: it relaunches at reduced world size
  (``nproc_per_node - 1`` per degrade step, floored at
  ``GangPolicy.min_procs``), shrinking the DP degree — the relaunched ranks
  ride the checkpoint reshard-on-load path under the smaller mesh (the
  "resume under a different mesh" property the checkpoint tests establish);
- an ``sdc_suspect`` poison (the SDC monitor confirmed a chip silently
  computing wrong numbers) or a ``straggler_suspect`` poison (the
  straggler ladder confirmed a sticky chip-slow rank) triggers an
  **exclude-list relaunch** instead of a plain restart: the launcher
  dumps the poison doc to ``<log_dir>/epoch_N/poison.json``, the
  supervisor maps the culprit rank to its physical slot, adds it to
  ``excluded_slots`` (exported as ``PADDLE_TPU_EXCLUDE_SLOTS``), and
  relaunches the SAME topology minus the quarantined slot with a FRESH
  restart budget — distinct from degrade, which shrinks the world
  because hosts keep dying, not because one of them lies (or limps);
- a ``straggler_link`` poison (sticky link-slow: the chip is fine, the
  ICI link between two ring neighbors is degraded) triggers a **mesh
  re-order remap**: the supervisor records the pair in slot space,
  computes a device-order permutation in which no degraded link is
  ring-adjacent (:func:`ring_order_avoiding`), exports it as
  ``PADDLE_TPU_DEVICE_ORDER`` and relaunches the FULL topology — no slot
  is lost for a bad cable.  When no permutation avoids the pair
  (world < 4), it falls back to excluding the culprit's slot;
- relaunched ranks resume through the **in-memory snapshot ladder**
  (:func:`~....checkpoint.snapshot.resume`: own RAM → snapshot-store copy
  → peer replica → committed disk checkpoint).  The supervisor hosts the
  snapshot depot (:func:`~....checkpoint.replicator.ensure_host_store`) in
  ITS process so copies survive gang teardown, exports
  ``PADDLE_TPU_SNAP_STORE`` to every launch, and after each attempt reads
  the ranks' resume reports back — ``gang_restart`` /
  ``fleet_supervisor_done`` events carry ``resume_sources``
  (memory|peer|disk per rank) and ``steps_lost`` so the goodput trail
  shows WHAT each restart actually cost.

usage::

    sup = FleetSupervisor("train.py", [ckpt_root],
                          nproc_per_node=4, ckpt_root=ckpt_root,
                          policy=GangPolicy(max_gang_restarts=2))
    sys.exit(sup.run())
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ...checkpoint.replicator import env_int as _env_int
from .supervisor import RestartPolicy, worst_resume_source

__all__ = ["GangPolicy", "FleetSupervisor", "ring_order_avoiding"]


def ring_order_avoiding(n: int, bad_pairs) -> Optional[List[int]]:
    """Smallest (lexicographically, from rank 0) ring ordering of
    ``range(n)`` in which no ``bad_pairs`` entry is ring-adjacent —
    including the wraparound edge — or ``None`` when every ordering
    crosses a bad pair (n < 4 with one pair: on a 3-ring every pair is
    adjacent).  Backtracking over gang-sized n (tens), not a search
    problem.  This is the link-slow remap: the returned order becomes
    ``PADDLE_TPU_DEVICE_ORDER``, routing ring-neighbor traffic around a
    degraded link without excluding any slot."""
    bad = set()
    for a, b in bad_pairs:
        bad.add((int(a), int(b)))
        bad.add((int(b), int(a)))
    if not bad:
        return list(range(n))
    order = [0]
    used = {0}

    def _solve() -> bool:
        if len(order) == n:
            return (order[-1], order[0]) not in bad
        for cand in range(1, n):
            if cand in used or (order[-1], cand) in bad:
                continue
            order.append(cand)
            used.add(cand)
            if _solve():
                return True
            order.pop()
            used.discard(cand)
        return False

    return list(order) if _solve() else None


@dataclass
class GangPolicy:
    """Bounds of the gang restart loop.

    ``max_gang_restarts`` — relaunches allowed per world size before the
    supervisor either degrades or gives up (env
    ``PADDLE_TPU_GANG_RESTARTS`` overrides the default).
    ``degrade`` — allow re-launching at reduced world size once the budget
    for the current size is spent (elastic degrade; off = give up).
    ``degrade_step`` — how many procs each degrade removes.
    ``min_procs`` — smallest world the job still makes sense at.
    ``backoff`` — seeded exponential backoff between relaunches."""

    max_gang_restarts: int = field(
        default_factory=lambda: _env_int("PADDLE_TPU_GANG_RESTARTS", 3))
    degrade: bool = True
    degrade_step: int = 1
    min_procs: int = 1
    backoff: RestartPolicy = field(default_factory=RestartPolicy)


class FleetSupervisor:
    """Relaunch loop around one gang (generalizes ``Supervisor`` from one
    process to one pod).

    ``script``/``script_args`` name the per-rank training program; each
    attempt goes through the launch CLI in-process (``launch.launch``), so
    ranks are real subprocesses with the full PADDLE_* env contract, and
    the launcher's fault domain (store hosting, lease monitor, poison
    teardown) is armed per attempt.  ``launch_fn(argv, env) -> int``
    overrides the launcher for tests.

    Any nonzero gang exit is restartable by default — a coordinated abort
    surfaces as whichever rank's exit the launcher saw first (101 from a
    poison-poll exit, a negative signal code from the culprit), and
    distinguishing them buys nothing at the gang level.  ``fatal_codes``
    lists exceptions (e.g. a config error exit that relaunching cannot
    fix)."""

    def __init__(self, script: str, script_args: Sequence[str] = (), *,
                 nproc_per_node: int = 1, nnodes: int = 1,
                 master: Optional[str] = None, job_id: str = "default",
                 log_dir: str = "log",
                 policy: Optional[GangPolicy] = None,
                 ckpt_root: Optional[str] = None,
                 keep_n: Optional[int] = None,
                 compile_cache: Optional[str] = None,
                 fatal_codes: Sequence[int] = (),
                 env: Optional[Dict[str, str]] = None,
                 launch_fn: Optional[Callable[..., int]] = None):
        self.script = script
        self.script_args = list(script_args)
        self.nproc_per_node = int(nproc_per_node)
        self.nnodes = int(nnodes)
        self.master = master
        self.job_id = job_id
        self.log_dir = log_dir
        self.policy = policy or GangPolicy()
        self.ckpt_root = ckpt_root
        self.keep_n = keep_n
        self.compile_cache = compile_cache
        self.fatal_codes = tuple(fatal_codes)
        self.env = dict(env) if env else {}
        self.launch_fn = launch_fn
        # trajectory (inspected by tests / status reporting)
        self.epoch = 0                  # launch attempts so far
        self.gang_restarts = 0          # relaunches at the CURRENT world
        self.degrades = 0
        self.excluded_slots: List[int] = []   # quarantined physical slots
        self.bad_link_slots: List[List[int]] = []  # degraded pairs (slots)
        self.device_order: Optional[List[int]] = None  # link-remap ring
        self.world_size = self.nnodes * self.nproc_per_node
        self.exit_codes: List[int] = []
        # in-memory snapshot depot: hosted HERE (this process outlives
        # every gang epoch) so peer replicas survive a full teardown and
        # the relaunch can resume from memory instead of disk
        self.resume_reports: Dict[int, Dict[int, dict]] = {}
        self._snap_addr: Optional[str] = None
        if os.environ.get("PADDLE_TPU_SNAP", "1") not in ("0", "false"):
            # an already-exported depot (outer supervisor, test harness)
            # wins; otherwise host the process-global one here
            self._snap_addr = os.environ.get("PADDLE_TPU_SNAP_STORE")
            if not self._snap_addr:
                try:
                    from ...checkpoint.replicator import ensure_host_store

                    _, self._snap_addr = ensure_host_store()
                except Exception:
                    self._snap_addr = None

    # -- one launch --------------------------------------------------------
    def _argv(self) -> List[str]:
        argv = ["--nnodes", str(self.nnodes),
                "--nproc_per_node", str(self.nproc_per_node),
                "--log_dir", os.path.join(self.log_dir,
                                          f"epoch_{self.epoch}"),
                "--job_id", self.job_id]
        if self.master:
            argv += ["--master", self.master]
        return argv + [self.script, *self.script_args]

    def _launch_env(self) -> Dict[str, str]:
        env = {
            "PADDLE_TPU_GANG_EPOCH": str(self.epoch),
            "PADDLE_TPU_GANG_BARRIER": "1",
            "PADDLE_TPU_FAULT_DOMAIN": os.environ.get(
                "PADDLE_TPU_FAULT_DOMAIN", "1"),
        }
        if self.compile_cache:
            env["PADDLE_TPU_COMPILE_CACHE"] = self.compile_cache
        if self._snap_addr:
            env["PADDLE_TPU_SNAP_STORE"] = self._snap_addr
        if self.excluded_slots:
            env["PADDLE_TPU_EXCLUDE_SLOTS"] = ",".join(
                str(s) for s in sorted(self.excluded_slots))
        if self.device_order:
            env["PADDLE_TPU_DEVICE_ORDER"] = ",".join(
                str(r) for r in self.device_order)
        env.update(self.env)
        return env

    def _collect_resume(self, epoch: int) -> dict:
        """Ranks report how they resumed (source + steps_lost) into the
        snapshot depot at epoch start; read it back after the attempt so
        the restart events narrate the recovery ladder's outcome."""
        if not self._snap_addr:
            return {}
        try:
            from ...checkpoint.replicator import SnapshotClient

            client = SnapshotClient.from_address(self._snap_addr)
            try:
                reports = client.resume_reports(epoch)
            finally:
                client.close()
        except Exception:
            return {}
        if not reports:
            return {}
        self.resume_reports[epoch] = reports
        lost = [d.get("steps_lost") for d in reports.values()
                if d.get("steps_lost") is not None]
        return {
            # worst rung scalar first — uniform with the single-process
            # Supervisor's restart events, what telemetry filters on
            "resume_source": worst_resume_source(
                d.get("source") for d in reports.values()),
            "resume_sources": {r: d.get("source")
                               for r, d in sorted(reports.items())},
            "steps_lost": max(lost) if lost else None,
        }

    def _launch_once(self) -> int:
        self.epoch += 1
        argv = self._argv()
        extra = self._launch_env()
        self._event("gang_launch", epoch=self.epoch,
                    world=self.world_size,
                    nproc_per_node=self.nproc_per_node)
        if self.launch_fn is not None:
            return self.launch_fn(argv, extra)
        from ...launch.main import launch

        saved = {k: os.environ.get(k) for k in extra}
        os.environ.update(extra)
        try:
            return launch(argv)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    # -- quarantine (SDC + straggler remediation) --------------------------
    def _check_quarantine(self, epoch: int):
        """After a failed attempt, read the launcher's poison dump for
        this epoch and apply the matching remediation: ``sdc_suspect`` /
        ``straggler_suspect`` → exclude-list relaunch minus the culprit's
        slot; ``straggler_link`` → device-order remap around the degraded
        pair (exclusion fallback when no order avoids it).  Returns a
        truthy token when a remediation was applied (the relaunch burns
        no restart budget), else None."""
        import json

        path = os.path.join(self.log_dir, f"epoch_{epoch}", "poison.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        reason = doc.get("reason")
        if reason in ("sdc_suspect", "straggler_suspect"):
            return self._quarantine_exclude(epoch, doc)
        if reason == "straggler_link":
            return self._quarantine_link(epoch, doc)
        return None

    def _quarantine_exclude(self, epoch: int, doc: dict) -> Optional[int]:
        """Quarantine the culprit's physical slot: the relaunch keeps the
        SAME topology minus that slot, with a FRESH restart budget — an
        exclude-list relaunch, not a degrade (the host isn't dying; it's
        lying, or limping). Returns the newly excluded slot, or None."""
        culprit = doc.get("culprit")
        if not isinstance(culprit, int):
            return None
        # dense ranks → physical slots: rank r of the poisoned epoch ran on
        # the r-th non-excluded slot (the launcher's spawn loop skips
        # excluded slots and assigns dense ranks in slot order)
        avail = [s for s in range(self.nnodes * self.nproc_per_node)
                 if s not in self.excluded_slots]
        if culprit < 0 or culprit >= len(avail):
            return None
        if len(avail) - 1 < max(1, self.policy.min_procs):
            # excluding would drop below the floor: let the normal restart
            # budget (and eventually giveup) decide instead
            self._event("gang_quarantine_refused", epoch=epoch,
                        culprit_rank=culprit,
                        world=self.world_size,
                        min_procs=self.policy.min_procs)
            return None
        slot = avail[culprit]
        self.excluded_slots.append(slot)
        self.world_size = self.nnodes * self.nproc_per_node \
            - len(self.excluded_slots)
        self.gang_restarts = 0   # fresh budget: the bad actor is gone
        self._recompute_order()  # dense ranks moved under the new world
        self._event("gang_quarantine", epoch=epoch, slot=slot,
                    reason=doc.get("reason"),
                    culprit_rank=culprit, step=doc.get("step"),
                    excluded_slots=sorted(self.excluded_slots),
                    world=self.world_size)
        return slot

    def _quarantine_link(self, epoch: int, doc: dict):
        """Mesh re-order remap for a degraded link: record the pair in
        slot space, find a ring order in which it is never adjacent, and
        relaunch the FULL topology under ``PADDLE_TPU_DEVICE_ORDER`` —
        the fix costs a permutation, not a slot.  Falls back to excluding
        the culprit's slot when no order avoids every recorded pair."""
        link = doc.get("link")
        if not (isinstance(link, (list, tuple)) and len(link) == 2):
            return None
        avail = [s for s in range(self.nnodes * self.nproc_per_node)
                 if s not in self.excluded_slots]
        try:
            pair = sorted(avail[int(r)] for r in link)
        except (TypeError, ValueError, IndexError):
            return None
        if pair not in self.bad_link_slots:
            self.bad_link_slots.append(pair)
        if self._recompute_order():
            self.gang_restarts = 0  # fresh budget: the link is routed out
            self._event("gang_link_remap", epoch=epoch,
                        link_ranks=[int(r) for r in link], link_slots=pair,
                        device_order=list(self.device_order or []),
                        world=self.world_size)
            return {"remap": list(self.device_order or [])}
        self._event("gang_link_exclude_fallback", epoch=epoch,
                    link_slots=pair, world=self.world_size)
        return self._quarantine_exclude(epoch, doc)

    def _recompute_order(self) -> bool:
        """Re-derive ``device_order`` from the recorded degraded links
        under the CURRENT exclusion set.  True when every still-live pair
        can be kept off the ring adjacency (or none remain)."""
        avail = [s for s in range(self.nnodes * self.nproc_per_node)
                 if s not in self.excluded_slots]
        aset = set(avail)
        pairs = [(avail.index(a), avail.index(b))
                 for a, b in self.bad_link_slots if a in aset and b in aset]
        if not pairs:
            self.device_order = None
            return True
        order = ring_order_avoiding(len(avail), pairs)
        self.device_order = order
        return order is not None

    # -- degrade -----------------------------------------------------------
    def _degrade(self) -> bool:
        """Shrink the gang one step; False when already at the floor."""
        new_nproc = self.nproc_per_node - self.policy.degrade_step
        if self.nnodes * new_nproc < self.policy.min_procs or new_nproc < 1:
            return False
        self.nproc_per_node = new_nproc
        self.world_size = self.nnodes * new_nproc
        self.degrades += 1
        self.gang_restarts = 0  # fresh budget at the smaller world
        self._event("gang_degrade", epoch=self.epoch,
                    world=self.world_size,
                    nproc_per_node=self.nproc_per_node,
                    degrades=self.degrades)
        return True

    # -- loop --------------------------------------------------------------
    def run(self) -> int:
        """Launch the gang; relaunch (and eventually degrade) on failure;
        return the final exit code (0 = the gang completed)."""
        self._event("fleet_supervisor_start", world=self.world_size)
        while True:
            rc = self._launch_once()
            self.exit_codes.append(rc)
            resume = self._collect_resume(self.epoch)
            if rc == 0:
                self._event("fleet_supervisor_done", epoch=self.epoch,
                            restarts=self.epoch - 1,
                            degrades=self.degrades,
                            world=self.world_size, **resume)
                return 0
            if rc in self.fatal_codes:
                self._event("fleet_supervisor_fatal", exit_code=rc,
                            epoch=self.epoch, **resume)
                return rc
            if self._check_quarantine(self.epoch) is not None:
                # exclude-list relaunch: budget already reset, world size
                # already shrunk by the quarantined slot — fall through to
                # the backoff + relaunch without spending a restart
                pass
            elif self.gang_restarts >= self.policy.max_gang_restarts:
                # budget for this world size is spent: a persistently
                # missing host keeps killing every relaunch — degrade the
                # mesh instead of burning forever (or give up at the floor)
                if not (self.policy.degrade and self._degrade()):
                    self._event("fleet_supervisor_giveup", exit_code=rc,
                                epoch=self.epoch, world=self.world_size)
                    return rc
            else:
                self.gang_restarts += 1
            delay = self.policy.backoff.delay(self.epoch)
            self._event("gang_restart", attempt=self.epoch, exit_code=rc,
                        backoff_s=round(delay, 3), world=self.world_size,
                        **resume)
            if self.ckpt_root and self.keep_n:
                try:
                    from ...checkpoint import gc_checkpoints

                    gc_checkpoints(self.ckpt_root, keep=self.keep_n)
                except Exception:
                    pass
            time.sleep(delay)

    @staticmethod
    def _event(name: str, **data) -> None:
        try:  # flight recorder: the pod-level restart story
            from .... import telemetry

            telemetry.record_event("fleet_supervisor", name, **data)
        except Exception:
            pass
