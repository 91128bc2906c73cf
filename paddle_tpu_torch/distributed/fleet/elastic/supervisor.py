"""Local restart supervisor: bounded relaunch loop with backoff.

The reference restarts a pod from *outside* (etcd watch → agent relaunch);
this module is the single-host analogue that makes the resilience pieces
compose end to end without a cluster manager:

    CommWatchdog timeout ──► flight-recorder dump (watchdog)
                             └► emergency checkpoint (``emergency_handler``)
                                 └► exit ``ELASTIC_EXIT_CODE`` (101)
    PreemptionGuard SIGTERM ──► async checkpoint + dump ──► exit 101
    HealthGuard escalation ──► RewindLedger entry + dump ──► exit 101
    ServingEngine wedge ──► dump ──► exit 101 (journal already durable)
                                      │
    Supervisor.run() ◄────────────────┘  sees 101 → backoff → relaunch
                                         child resumes via
                                         ``latest_checkpoint(root)`` (train)
                                         or ``ServingEngine.recover()``
                                         (serving: journal replay, reported
                                         as ``resume_source=journal`` +
                                         ``resume_replayed``)

The third arrow is the numerical-health rewind path
(:mod:`paddle_tpu_torch.distributed.health`): when a
:class:`~paddle_tpu_torch.distributed.health.HealthGuard` sees K anomalies
(NaN/Inf steps it already skipped device-side, or finite loss/grad-norm
spikes) inside its window, it records the poisoned data window in the
``RewindLedger`` next to the checkpoints, dumps the flight recorder, and
exits 101 — the relaunch resumes from ``latest_checkpoint(root)``, calls
``guard.on_restart(step, sampler)`` to fast-forward PAST the poisoned
batches, and a run that keeps rewinding to the same step raises
``HealthError`` (a non-101 exit this supervisor treats as fatal rather
than burning the restart budget on a divergence loop). When ``ckpt_root``
is set, restart events carry the ledger's rewind count so the parent's
flight recorder narrates health rewinds distinctly from crash restarts.

:class:`Supervisor` relaunches either a subprocess command (real isolation
— a hung child is killed, a crashed child cannot corrupt the parent) or an
in-process callable (unit tests) whenever it exits with a *restart code*
(default: only 101). Restarts are bounded (``RestartPolicy.max_restarts``)
and spaced by seeded exponential backoff + jitter; any other nonzero exit
is treated as fatal and returned to the caller. Between restarts the
supervisor optionally runs keep-N retention GC over the checkpoint root,
so a crash-looping job cannot fill the disk with emergency checkpoints.

``compile_cache=`` names a compile-cache root that every launch inherits
as ``PADDLE_TPU_COMPILE_CACHE`` (kept for the reference's interface: this
package's eager ``TrainStep`` compiles nothing, so only a user program that
caches compiled code reads it) — and every child-exit event carries
``time_to_first_step_s`` (relaunch → first completed step, via the
``PADDLE_TPU_FIRST_STEP_STAMP`` protocol with ``jit.TrainStep``) so the
warm-start win is measured, not assumed.

:func:`emergency_handler` builds the child-side ``on_timeout`` callback for
:class:`~paddle_tpu_torch.distributed.CommWatchdog`: the watchdog has already
dumped the flight recorder by the time it fires, so the handler saves a
committed emergency checkpoint (best effort — the state provider runs on
the monitor thread while the main thread is wedged) and exits 101 for the
supervisor to catch.

usage::

    # parent
    sup = Supervisor([sys.executable, "train.py", ckpt_root],
                     policy=RestartPolicy(max_restarts=5),
                     ckpt_root=ckpt_root, keep_n=3)
    sys.exit(sup.run())

    # child (train.py)
    resume = latest_checkpoint(ckpt_root)
    if resume:
        load_state_dict(state, resume)
    wd = CommWatchdog(timeout=300,
                      on_timeout=emergency_handler(lambda: state, ckpt_root))
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

from . import ELASTIC_EXIT_CODE
from ...retry import BackoffPolicy

__all__ = ["RestartPolicy", "Supervisor", "ReplicaPool",
           "emergency_handler", "RESUME_LADDER", "worst_resume_source"]

# recovery rungs from cheapest to most degraded — a multi-rank launch
# reports its WORST rung (the one that actually bounded the restart)
RESUME_LADDER = ("memory", "peer", "disk", "none")


def worst_resume_source(sources) -> Optional[str]:
    """The most-degraded rung among per-rank resume sources (unknown
    strings rank below every known rung)."""
    sources = [s for s in sources if s is not None]
    if not sources:
        return None
    return max(sources, key=lambda s: RESUME_LADDER.index(s)
               if s in RESUME_LADDER else len(RESUME_LADDER))


@dataclass
class RestartPolicy:
    """Bounded restarts with seeded exponential backoff + jitter.

    The delay schedule is the shared :class:`..retry.BackoffPolicy`
    (1-based ``restart_num`` maps onto its 0-based attempt index; the
    per-restart RNG stream ``seed * 1_000_003 + restart_num`` is
    unchanged, so historical delay sequences are preserved)."""

    max_restarts: int = 5
    backoff_base: float = 1.0
    backoff_cap: float = 60.0
    jitter: float = 0.25
    seed: int = 0

    def delay(self, restart_num: int) -> float:
        """Backoff before restart ``restart_num`` (1-based)."""
        return BackoffPolicy(base=self.backoff_base, cap=self.backoff_cap,
                             jitter=self.jitter,
                             seed=self.seed).delay(restart_num - 1)


class Supervisor:
    """Relaunch loop around one training job.

    ``target`` is either an argv list (subprocess mode) or a callable
    (in-process mode — the callable's ``SystemExit`` code, or 0 on normal
    return, plays the role of the exit status).

    ``compile_cache`` names a compile-cache root exported to every launch
    as ``PADDLE_TPU_COMPILE_CACHE`` (read by a user program that caches
    compiled code; the eager ``jit.TrainStep`` compiles nothing). Each
    launch also gets a
    fresh ``PADDLE_TPU_FIRST_STEP_STAMP`` path that ``jit.TrainStep``
    stamps on the first completed step; the supervisor reads it back and
    reports ``time_to_first_step_s`` in its restart/done events, so
    warm-start wins are visible in the goodput trail next to
    ``health_rewinds``."""

    def __init__(self, target: Union[Sequence[str], Callable[[], None]],
                 policy: Optional[RestartPolicy] = None,
                 restart_codes: Sequence[int] = (ELASTIC_EXIT_CODE,),
                 env: Optional[dict] = None,
                 ckpt_root: Optional[str] = None,
                 keep_n: Optional[int] = None,
                 child_timeout: Optional[float] = None,
                 compile_cache: Optional[str] = None):
        self.target = target
        self.policy = policy or RestartPolicy()
        self.restart_codes = tuple(restart_codes)
        self.env = env
        self.ckpt_root = ckpt_root
        self.keep_n = keep_n
        self.child_timeout = child_timeout
        self.compile_cache = compile_cache
        self.restarts = 0
        self.exit_codes: List[int] = []
        self.time_to_first_step_s: Optional[float] = None
        self.last_resume: Optional[dict] = None  # {"source","steps_lost",…}
        self._stamp_dir: Optional[str] = None

    # -- first-step goodput probe ------------------------------------------
    def _next_stamp_path(self) -> str:
        if self._stamp_dir is None:
            self._stamp_dir = tempfile.mkdtemp(prefix="paddle_tpu_sup_")
        return os.path.join(self._stamp_dir,
                            f"first_step_{len(self.exit_codes)}.stamp")

    @staticmethod
    def _read_stamp(stamp: str, launch_wall: float) -> Optional[float]:
        """relaunch → first completed TrainStep, from the child's stamp
        file (None when the child never finished a step — crashed during
        compile/load, or runs no TrainStep)."""
        try:
            with open(stamp) as f:
                t = float(f.read().strip())
            os.remove(stamp)
            return max(0.0, t - launch_wall)
        except (OSError, ValueError):
            return None

    def _read_resume_report(self, base: str) -> Optional[dict]:
        """The child's resume ladder (``checkpoint.snapshot.resume``)
        writes ``<base>.<rank>`` with its resolved source + steps_lost —
        read it back so restart events narrate memory-vs-disk recovery.
        With several ranks the scalar fields aggregate deterministically
        (most-degraded source, earliest step, max steps_lost) and the
        per-rank map rides along as ``resume_sources``."""
        import glob
        import json

        docs = {}
        for path in sorted(glob.glob(base + ".*")):
            try:
                with open(path) as f:
                    doc = json.load(f)
                os.remove(path)
            except (OSError, ValueError):
                continue
            docs[doc.get("rank", len(docs))] = doc
        if not docs:
            return None

        lost = [d.get("steps_lost") for d in docs.values()
                if d.get("steps_lost") is not None]
        steps = [d.get("step") for d in docs.values()
                 if d.get("step") is not None]
        out = {"resume_source": worst_resume_source(
                   d.get("source") for d in docs.values()),
               "resume_step": min(steps) if steps else None,
               "steps_lost": max(lost) if lost else None}
        # serving children resume through the request journal instead of a
        # checkpoint: their reports carry source="journal" plus the count
        # of in-flight requests replayed (ServingEngine.recover)
        rep = [d.get("replayed") for d in docs.values()
               if d.get("replayed") is not None]
        if rep:
            out["resume_replayed"] = sum(rep)
        if len(docs) > 1:
            out["resume_sources"] = {r: d.get("source")
                                     for r, d in sorted(docs.items())}
        return out

    # -- one launch --------------------------------------------------------
    def _launch_once(self) -> int:
        stamp = self._next_stamp_path()
        extra_env = {"PADDLE_TPU_FIRST_STEP_STAMP": stamp,
                     "PADDLE_TPU_RESUME_REPORT": stamp + ".resume"}
        if self.compile_cache:
            extra_env["PADDLE_TPU_COMPILE_CACHE"] = self.compile_cache
        launch_wall = time.time()
        try:
            return self._launch_raw(extra_env)
        finally:
            self.time_to_first_step_s = self._read_stamp(stamp, launch_wall)
            self.last_resume = self._read_resume_report(stamp + ".resume")

    def _launch_raw(self, extra_env: dict) -> int:
        if callable(self.target):
            saved = {k: os.environ.get(k) for k in extra_env}
            os.environ.update(extra_env)
            try:
                self.target()
                return 0
            except SystemExit as e:
                code = e.code
                return code if isinstance(code, int) else (0 if code is None
                                                           else 1)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        env = dict(self.env) if self.env is not None else dict(os.environ)
        env.update(extra_env)
        try:
            proc = subprocess.run(list(self.target), env=env,
                                  timeout=self.child_timeout)
            return proc.returncode
        except subprocess.TimeoutExpired:
            # a child the watchdog failed to kill: treat as restartable hang
            return self.restart_codes[0] if self.restart_codes else 1

    # -- loop --------------------------------------------------------------
    def run(self) -> int:
        """Launch; relaunch with backoff on restart codes; return the final
        exit code (0 = completed, restart code = gave up after
        ``max_restarts``, anything else = fatal child error)."""
        self._event("supervisor_start")
        try:
            while True:
                rc = self._launch_once()
                self.exit_codes.append(rc)
                ttfs = None if self.time_to_first_step_s is None else \
                    round(self.time_to_first_step_s, 3)
                resume = self.last_resume or {}
                if rc == 0:
                    self._event("supervisor_done", restarts=self.restarts,
                                time_to_first_step_s=ttfs, **resume)
                    self._dump_blackbox("supervisor_done")
                    return 0
                if rc not in self.restart_codes:
                    self._event("supervisor_fatal", exit_code=rc,
                                restarts=self.restarts,
                                time_to_first_step_s=ttfs, **resume)
                    self._dump_blackbox("supervisor_fatal")
                    return rc
                if self.restarts >= self.policy.max_restarts:
                    self._event("supervisor_giveup", exit_code=rc,
                                restarts=self.restarts,
                                time_to_first_step_s=ttfs, **resume)
                    self._dump_blackbox("supervisor_giveup")
                    return rc
                self.restarts += 1
                delay = self.policy.delay(self.restarts)
                self._event("supervisor_restart", attempt=self.restarts,
                            exit_code=rc, backoff_s=round(delay, 3),
                            health_rewinds=self._rewind_count(),
                            time_to_first_step_s=ttfs, **resume)
                if self.ckpt_root and self.keep_n:
                    try:
                        from ...checkpoint import gc_checkpoints

                        gc_checkpoints(self.ckpt_root, keep=self.keep_n)
                    except Exception:
                        pass
                time.sleep(delay)
        finally:
            if self._stamp_dir is not None:
                shutil.rmtree(self._stamp_dir, ignore_errors=True)
                self._stamp_dir = None

    def _rewind_count(self) -> Optional[int]:
        """Health rewinds recorded under ``ckpt_root`` (None without one):
        lets a restart event distinguish 'child crashed' from 'child asked
        to rewind past poisoned data'."""
        if not self.ckpt_root:
            return None
        try:
            from ...health import RewindLedger

            return len(RewindLedger(self.ckpt_root))
        except Exception:
            return None

    @staticmethod
    def _event(name: str, **data) -> None:
        try:  # flight recorder: the parent's ring narrates the restart story
            from .... import telemetry

            telemetry.record_event("supervisor", name, **data)
        except Exception:
            pass

    @staticmethod
    def _dump_blackbox(reason: str) -> None:
        """Terminal-state dump: when a job-level epoch dir exists, leave
        the parent's restart narrative next to the workers' dumps so
        ``telemetry.blackbox.merge`` folds the supervisor's view in."""
        if not os.environ.get("PADDLE_TPU_EPOCH_DIR"):
            return
        try:
            from .... import telemetry

            telemetry.dump_flight_recorder(reason=reason)
        except Exception:
            pass


class ReplicaPool:
    """Per-replica supervision for a serving fleet.

    The gang :class:`Supervisor` restarts ONE child and treats its death
    as the whole job's death — right for SPMD training, wrong for a
    lease-routed serving fleet where replica death is routine and the
    frontend has already fenced + failed the work over by the time a
    relaunch matters.  This pool runs N named replica subprocesses, each
    with its OWN bounded :class:`RestartPolicy` budget: one replica crash
    -looping exhausts only its own budget; the others keep serving.

    ``-SIGKILL`` is a restart code by default (unlike the gang
    supervisor): an externally killed replica (preemption, OOM killer,
    chaos) relaunches, adopts a bumped fencing epoch
    (:func:`paddle_tpu_torch.serving.fleet.adopt_epoch`) and takes new traffic,
    while the dead incarnation's work replays on survivors.  Exit 0 means
    the replica was asked to stop (frontend ``stop`` command) and is NOT
    relaunched."""

    def __init__(self, policy: Optional[RestartPolicy] = None,
                 restart_codes: Sequence[int] = (ELASTIC_EXIT_CODE, -9),
                 env: Optional[dict] = None):
        self.policy = policy or RestartPolicy()
        self.restart_codes = tuple(restart_codes)
        self.env = env
        self._argv: dict = {}          # name -> argv list
        self._envs: dict = {}          # name -> per-replica env overlay
        self._logs: dict = {}          # name -> log path (append per spawn)
        self._procs: dict = {}         # name -> live Popen
        self._backoff_until: dict = {} # name -> wall time to respawn at
        self.restarts: dict = {}       # name -> relaunch count
        self.exit_codes: dict = {}     # name -> [codes]
        self.given_up: set = set()
        self.done: set = set()         # exited 0 (asked to stop)
        self.retiring: set = set()     # scale-in victims: ANY exit is
        # intentional — never relaunched, zero restart budget burned,
        # even when a SIGKILL lands mid-drain
        self._template: Optional[tuple] = None
        self._stopping = False

    def add(self, name: str, argv: Sequence[str],
            env: Optional[dict] = None,
            log_path: Optional[str] = None) -> None:
        self._argv[str(name)] = list(argv)
        self._envs[str(name)] = dict(env or {})
        self._logs[str(name)] = log_path
        self.restarts.setdefault(str(name), 0)
        self.exit_codes.setdefault(str(name), [])

    def start(self) -> None:
        for name in self._argv:
            if name not in self._procs:
                self._spawn(name)

    # -- elastic autoscaling surface ---------------------------------------
    def set_template(self, argv: Sequence[str],
                     env: Optional[dict] = None,
                     log_dir: Optional[str] = None,
                     name_prefix: str = "replica") -> None:
        """Arm :meth:`scale_to` with the argv/env a scale-out replica
        spawns with.  Fresh replicas get monotonically increasing
        ``<name_prefix><idx>`` names — a name is never reused, so a new
        replica can never be mistaken for (or inherit restart budget
        from) a retired incarnation; its fencing epoch comes from
        ``adopt_epoch`` at replica start as for any launch."""
        self._template = (list(argv), dict(env or {}),
                          None if log_dir is None else str(log_dir),
                          str(name_prefix))

    def _next_name(self) -> str:
        prefix = self._template[3]
        idx = 0
        for name in self._argv:
            if name.startswith(prefix):
                try:
                    idx = max(idx, int(name[len(prefix):]) + 1)
                except ValueError:
                    continue
        return f"{prefix}{idx}"

    def live_names(self) -> List[str]:
        """Replicas this pool still owes traffic capacity for: added and
        neither retired, done, nor given up (a crashed-but-relaunching
        replica counts — its backoff is capacity in flight)."""
        return sorted(n for n in self._argv
                      if n not in self.done and n not in self.given_up
                      and n not in self.retiring)

    def note_retiring(self, name: str) -> None:
        """Mark ``name`` as a scale-in victim BEFORE it is asked to drain:
        from here on any exit — the clean exit 0 of a finished drain or a
        SIGKILL landing mid-drain — retires it without burning restart
        budget, and it is never relaunched (the fleet frontend's fence +
        fold + replay failover owns whatever work the kill interrupted)."""
        name = str(name)
        self.retiring.add(name)
        self._backoff_until.pop(name, None)
        self._event("replica_retiring", replica=name)

    def scale_to(self, n: int, victims: Sequence[str] = ()) -> dict:
        """Grow or shrink toward ``n`` live replicas.  Growth spawns
        fresh-named replicas from :meth:`set_template`; shrink only marks
        caller-chosen ``victims`` as retiring (the caller owns the drain
        protocol — this pool only guarantees their exits are intentional).
        Returns ``{"spawned": [...], "retiring": [...], "live": [...]}``."""
        n = max(0, int(n))
        spawned: List[str] = []
        retiring: List[str] = []
        live = self.live_names()
        while len(live) + len(spawned) < n:
            if self._template is None:
                raise RuntimeError("scale_to growth needs set_template()")
            name = self._next_name()
            argv, env, log_dir, _prefix = self._template
            log_path = None if log_dir is None else \
                os.path.join(log_dir, f"{name}.log")
            self.add(name, argv, env=env, log_path=log_path)
            self._spawn(name)
            spawned.append(name)
        excess = len(live) - n
        for name in victims:
            if excess <= 0:
                break
            name = str(name)
            if name in live and name not in self.retiring:
                self.note_retiring(name)
                retiring.append(name)
                excess -= 1
        return {"spawned": spawned, "retiring": retiring,
                "live": self.live_names()}

    def _spawn(self, name: str) -> None:
        env = dict(self.env) if self.env is not None else dict(os.environ)
        env.update(self._envs.get(name, ()))
        env["PADDLE_TPU_SERVE_REPLICA"] = name
        kw = {}
        log_f = None
        if self._logs.get(name):
            log_f = open(self._logs[name], "a")
            kw = {"stdout": log_f, "stderr": subprocess.STDOUT}
        try:
            self._procs[name] = subprocess.Popen(self._argv[name], env=env,
                                                 **kw)
        finally:
            if log_f is not None:
                log_f.close()   # the child holds its own dup of the fd
        self._event("replica_spawn", replica=name,
                    pid=self._procs[name].pid,
                    attempt=self.restarts.get(name, 0))

    def poll_once(self, now: Callable[[], float] = time.time) -> None:
        """One non-blocking pass: reap exited replicas, schedule/execute
        backed-off relaunches.  The caller's loop (launcher main, test)
        owns the cadence."""
        for name, proc in list(self._procs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del self._procs[name]
            self.exit_codes[name].append(rc)
            if self._stopping:
                continue
            if rc == 0 or name in self.retiring:
                # exit 0 = asked to stop; a RETIRING name is done whatever
                # its exit code (SIGKILL mid-drain included): intentional
                # stops are distinguishable from crashes and burn zero
                # restart budget
                self.done.add(name)
                self._event("replica_done", replica=name, exit_code=rc,
                            retired=name in self.retiring)
            elif rc in self.restart_codes and \
                    self.restarts[name] < self.policy.max_restarts:
                self.restarts[name] += 1
                delay = self.policy.delay(self.restarts[name])
                self._backoff_until[name] = now() + delay
                self._event("replica_restart", replica=name, exit_code=rc,
                            attempt=self.restarts[name],
                            backoff_s=round(delay, 3))
            else:
                self.given_up.add(name)
                self._event("replica_giveup", replica=name, exit_code=rc,
                            restarts=self.restarts[name])
        for name, t in list(self._backoff_until.items()):
            if now() >= t:
                del self._backoff_until[name]
                self._spawn(name)

    def alive(self) -> List[str]:
        return sorted(n for n, p in self._procs.items() if p.poll() is None)

    def all_exited(self) -> bool:
        return not self._procs and not self._backoff_until

    def run(self, poll_interval: float = 0.2,
            until: Optional[Callable[[], bool]] = None) -> dict:
        """Poll until every replica exited for good (done or gave up), or
        ``until()`` goes true.  Returns {name: last exit code}."""
        while True:
            self.poll_once()
            if until is not None and until():
                break
            if self.all_exited():
                break
            time.sleep(poll_interval)
        return {n: (codes[-1] if codes else None)
                for n, codes in self.exit_codes.items()}

    def stop(self, timeout: float = 10.0) -> None:
        """TERM every replica, escalate to KILL past ``timeout``."""
        self._stopping = True
        self._backoff_until.clear()
        for proc in self._procs.values():
            try:
                proc.terminate()
            except OSError:
                pass
        deadline = time.time() + timeout
        for name, proc in list(self._procs.items()):
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                try:
                    proc.kill()
                    proc.wait(timeout=5)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            self.exit_codes[name].append(proc.returncode)
            del self._procs[name]

    @staticmethod
    def _event(name: str, **data) -> None:
        Supervisor._event(name, **data)


def emergency_handler(get_state: Callable[[], dict], ckpt_root: str,
                      exit_code: int = ELASTIC_EXIT_CODE,
                      hard_exit: bool = True) -> Callable[[dict], None]:
    """Build a ``CommWatchdog`` ``on_timeout`` callback: save a committed
    emergency checkpoint under ``ckpt_root`` and exit ``exit_code`` so a
    :class:`Supervisor` relaunches into ``latest_checkpoint`` resume.

    The watchdog dumps the flight recorder *before* invoking this (its
    ``info`` already carries ``flight_recorder_dump``), so the ordering is
    dump → checkpoint → exit. ``hard_exit=False`` skips the exit (tests;
    callers that want to raise instead). Best effort by design: the save
    runs on the watchdog's monitor thread while the main thread is wedged —
    if it fails (e.g. the hang is in the storage layer too), the handler
    records the failure and still exits, and resume falls back to the last
    periodic checkpoint."""

    def on_timeout(info: dict) -> None:
        path = os.path.join(
            ckpt_root, f"emergency_{int(time.time())}_pid{os.getpid()}")
        saved = False
        try:
            from ...checkpoint import save_state_dict
            from ...checkpoint.save_state_dict import _wait_pending

            save_state_dict(get_state(), path)
            _wait_pending()
            saved = True
        except Exception as e:
            sys.stderr.write(f"[supervisor] emergency checkpoint to {path} "
                             f"failed: {e!r}\n")
        try:
            from .... import telemetry

            telemetry.record_event("emergency_checkpoint", path,
                                   trigger=info.get("name"), saved=saved,
                                   dump=info.get("flight_recorder_dump", ""))
        except Exception:
            pass
        if hard_exit:
            os._exit(exit_code)  # the main thread is wedged: no sys.exit

    return on_timeout
