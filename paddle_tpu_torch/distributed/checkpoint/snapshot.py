"""In-memory peer-replicated snapshots: recovery with an RPO of *steps*
(port of the reference's ``distributed/checkpoint/snapshot.py``).

The disk checkpoint stack (atomic commit, ``latest_checkpoint`` resume)
bounds what a crash can lose to the checkpoint interval — minutes of work,
paid back through a full storage read.  At pod scale, where
mean-time-between-failure shrinks with world size, that loss dominates
goodput.  The fix (Gemini SOSP'23, MegaScale NSDI'24): snapshot to host
RAM every few steps and replicate to a peer, so recovery loses only the
steps since the last snapshot and restores from memory.

Three pieces:

- :class:`Snapshotter` — every ``PADDLE_TPU_SNAP_EVERY`` steps (default
  10) the rank copies its tensors into a **double-buffered** host-RAM
  snapshot, then ships a CRC-tagged copy to its own slot AND its
  ring-neighbor peer's slot over the replication transport
  (:mod:`.replicator`).  The copy is a DELIBERATE, amortized host sync
  and runs synchronously at the trigger step — it must: the optimizers
  update the state in place, so a lazy capture would read the next
  step's values.  Serialization + shipping run on a
  background thread off the step path (the ``async_save`` discipline:
  failures are captured and surfaced, never lost with the thread).  The
  generation number IS the step number, so generations can never desync
  from progress, and the double buffer means a crash (or injected fault,
  ``faults.fire("snap", ...)``) mid-capture leaves the previous snapshot
  intact and advertises nothing torn.
- the **generation protocol** — a generation is *complete* only when every
  rank has a valid copy at the same step
  (``transport.complete_generations(world)``); resolution only ever offers
  complete generations, so a torn one (some ranks snapped step N, some
  N−10) is never mixed into a resume.
- :func:`resume` — the recovery ladder, in order: own RAM snapshot
  (same-process relaunch) → own copy in the snapshot store → peer replica
  (the dead rank's shards recovered from its ring neighbor) → committed
  disk checkpoint.  Generations inside a health-rewind poisoned window
  (:meth:`~..health.ledger.RewindLedger.poisoned`) are skipped — a NaN
  that escalated at step N must not be resumed back into via a snapshot
  of step N−2.  The outcome (``resume_source=memory|peer|disk`` +
  ``steps_lost``) is recorded to telemetry, reported to the supervisor
  (snapshot-store report or the ``PADDLE_TPU_RESUME_REPORT`` stamp file),
  and a fall-through past available-but-unusable snapshots emits a loud
  ``snapshot_unrecoverable`` event.

Env: ``PADDLE_TPU_SNAP=0`` disables; ``PADDLE_TPU_SNAP_EVERY`` sets the
cadence; ``PADDLE_TPU_SNAP_STORE`` addresses the replication daemon.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import faults
from .errors import CheckpointError
from .replicator import crc32, env_int as _env_int, transport_from_env
from .utils import (compute_overlap, dtype_name, flatten_state_dict, fp_array,
                    from_host, global_place, host_bits, host_empty, tensor_value,
                    to_host, unflatten_key)

__all__ = ["Snapshotter", "SnapshotRestoreError", "ResumeInfo", "resume",
           "snap_every", "snapshots_enabled"]


class SnapshotRestoreError(CheckpointError):
    """A snapshot exists but cannot fill the requested state (missing keys,
    shard coverage holes after a mesh change, undecodable payload) — the
    resume ladder treats it as 'this rung is gone' and falls through."""


def snapshots_enabled() -> bool:
    return os.environ.get("PADDLE_TPU_SNAP", "1") not in ("0", "false")


def snap_every(default: int = 10) -> int:
    try:
        n = int(os.environ.get("PADDLE_TPU_SNAP_EVERY", default))
    except (TypeError, ValueError):
        n = default
    return max(1, n)


def _record_event(kind: str, name: str, **data) -> None:
    try:
        from ... import telemetry

        telemetry.record_event(kind, name, **data)
    except Exception:
        pass


def _set_gauge(name: str, value) -> None:
    try:
        from ... import telemetry

        telemetry.set_gauge(name, value)
    except Exception:
        pass


# -- capture / restore -------------------------------------------------------

def _materialize(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten + copy THIS process's tensors into host numpy — the
    host-RAM snapshot entry.  A deliberate host sync, synchronous at the
    trigger: the optimizers update the state in place at the next step.
    A tensor is its process's block (whole, or where
    :func:`~.utils.mark_local_shard` put it); every rank keeps its own
    copy of replicated state (unlike the disk format's single owner): a
    snapshot must be self-sufficient for its rank's resume."""
    flat, _ = flatten_state_dict(state_dict)
    shards: Dict[str, List[Tuple[Tuple[int, ...], np.ndarray]]] = {}
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for key, leaf in flat.items():
        v = tensor_value(leaf)
        if isinstance(v, torch.Tensor):
            offset, gshape = global_place(v)
            shapes[key] = (gshape, dtype_name(v))
            shards[key] = [(offset, to_host(v))]
        else:
            arr = np.array(v)
            shapes[key] = (tuple(arr.shape), str(arr.dtype))
            shards[key] = [((0,) * arr.ndim, arr)]
    return {"shards": shards, "shapes": shapes}


def _snapshot_fingerprints(shards: Dict[str, List[Tuple[Tuple[int, ...],
                                                        np.ndarray]]],
                           seed: int, dtypes: Optional[Dict[str, str]] = None
                           ) -> Dict[str, str]:
    """Per-shard value fingerprints of a snapshot entry (same "key@offset"
    naming as the disk checkpoint metadata)."""
    from ..health.sdc import shard_fp_name, tree_fingerprints

    named = {}
    for key, entries in shards.items():
        for off, arr in entries:
            named[shard_fp_name(key, off)] = fp_array(arr, dtypes[key]) if dtypes else arr
    return tree_fingerprints(named, seed)


def _restore_into(state_dict: Dict[str, Any], snap: Dict[str, Any]) -> int:
    """Fill ``state_dict`` in place from a snapshot entry, resharding the
    available pieces onto each target's block (the same overlap machinery
    as ``load_state_dict``).  Raises
    :class:`SnapshotRestoreError` on any hole so the ladder falls through
    to the next rung instead of resuming partial state."""
    flat, mapping = flatten_state_dict(state_dict)
    shards, shapes = snap["shards"], snap["shapes"]
    fps = snap.get("fp")
    if fps:
        # shipped generations carry value fingerprints (stamped on the
        # background ship path, off the step cadence): a replica whose
        # values no longer match — corrupted in the depot, in transit, or
        # in the holder's RAM — fails THIS rung and the ladder falls
        # through to an intact source instead of resuming silent damage
        from ..health.sdc import SDCPolicy, verify_load_enabled

        if verify_load_enabled():
            got = _snapshot_fingerprints(shards, SDCPolicy.from_env().seed,
                                         {k: d for k, (_, d) in shapes.items()})
            for name, want in fps.items():
                if name in got and got[name] != want:
                    key = name.split("@", 1)[0]
                    _record_event("snapshot_fingerprint_mismatch", key,
                                  gen=snap.get("gen"), step=snap.get("step"))
                    raise SnapshotRestoreError(
                        f"snapshot (gen {snap.get('gen')}) value-"
                        f"fingerprint mismatch in tensor {key!r} "
                        f"(shard {name!r}) — the replica's values were "
                        f"silently corrupted after capture")
    for key, leaf in flat.items():
        if key not in shards:
            raise SnapshotRestoreError(
                f"snapshot (step {snap.get('step')}) has no tensor {key!r}")
        entries = shards[key]
        dtype = shapes[key][1]
        v = tensor_value(leaf)
        if not isinstance(v, torch.Tensor):
            data = entries[0][1]
            value = data.item() if data.ndim == 0 else data
            if isinstance(leaf, int) and data.ndim == 0:
                value = int(value)
            unflatten_key(state_dict, mapping[key], value)
            continue
        offset, _ = global_place(v)
        local_shape = tuple(v.shape)
        out = host_empty(local_shape, dtype)
        covered = 0
        for src_off, piece in entries:
            ov = compute_overlap(src_off, piece.shape, offset, local_shape)
            if ov is None:
                continue
            src, dst = ov
            out[dst] = host_bits(piece, dtype)[src]
            covered += int(np.prod([s.stop - s.start for s in dst]))
        if covered != int(np.prod(local_shape)):
            raise SnapshotRestoreError(
                f"snapshot shards of {key!r} do not cover wanted "
                f"slice offset={offset} shape={local_shape} — the "
                f"sharding changed since capture; memory resume needs "
                f"the disk reshard-on-load path")
        with torch.no_grad():
            v.copy_(from_host(out, dtype).to(v.dtype))
    return int(snap["step"])


# -- the snapshotter ---------------------------------------------------------

class Snapshotter:
    """Periodic host-RAM snapshots of one rank's state, peer-replicated.

    ``state_provider`` returns the state_dict to snapshot — the same dict
    the training loop hands ``save_state_dict`` (params, optimizer state,
    counters).  ``transport`` is any :mod:`.replicator` transport (daemon
    client or KV fallback); ``None`` (and nothing in the env) keeps
    snapshots process-local — still rung 1 of the ladder for in-process
    relaunches.

    usage::

        snap = Snapshotter(lambda: {"model": model.state_dict(),
                                    "step": step_t})
        step = TrainStep(model, loss_fn, opt, snapshotter=snap)
        ...                                  # snapshots every N steps
        info = snapshot.resume(state, ckpt_root, snapshotter=snap)
    """

    def __init__(self, state_provider: Callable[[], Dict[str, Any]], *,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 every: Optional[int] = None,
                 transport: Any = "env",
                 sync: Optional[bool] = None,
                 name: str = "train"):
        self.state_provider = state_provider
        self.rank = _env_int("PADDLE_TRAINER_ID", 0) if rank is None \
            else int(rank)
        self.world_size = _env_int("PADDLE_TRAINERS_NUM", 1) \
            if world_size is None else int(world_size)
        self.every = snap_every() if every is None else max(1, int(every))
        self.enabled = snapshots_enabled()
        self.transport = transport_from_env() if transport == "env" \
            else transport
        self.sync = (os.environ.get("PADDLE_TPU_SNAP_SYNC") == "1"
                     if sync is None else bool(sync))
        self.name = name
        # double buffer: capture fills the spare slot, the flip publishes
        self._buffers: List[Optional[Dict[str, Any]]] = [None, None]
        self._live = -1
        self._lock = threading.Lock()
        self._ship_thread: Optional[threading.Thread] = None
        # counters (tests / telemetry / post-mortems)
        self.captures = 0
        self.capture_failures = 0
        self.ship_failures = 0
        self.ship_skips = 0          # triggers skipped: ship still in flight
        self.last_error: Optional[BaseException] = None
        self.last_step: Optional[int] = None
        self.capture_seconds_total = 0.0
        self._ship_fail_streak = 0
        self._replication_dead = False
        try:
            self._max_ship_failures = int(os.environ.get(
                "PADDLE_TPU_SNAP_MAX_SHIP_FAILURES", 5))
        except (TypeError, ValueError):
            self._max_ship_failures = 5

    @property
    def peer(self) -> Optional[int]:
        """Ring-neighbor replica holder (None in a world of one)."""
        if self.world_size <= 1:
            return None
        return (self.rank + 1) % self.world_size

    # -- trigger -----------------------------------------------------------
    def on_step(self, step: int) -> bool:
        """TrainStep hook: snapshot when ``step`` hits the cadence.  Cheap
        (one modulo) on non-trigger steps."""
        if not self.enabled or step % self.every:
            return False
        if self.last_step is not None:
            # the real inter-snapshot gap: reads > ``every`` when triggers
            # were skipped (ship in flight) — age grew, RPO degraded
            _set_gauge("snapshot_age_steps", step - self.last_step)
        return self.snapshot_now(step)

    def snapshot_now(self, step: int, wait: Optional[bool] = None) -> bool:
        """Capture (synchronously — see module docstring) and ship
        (asynchronously unless ``wait``/``sync``).  Returns True when a new
        generation was published to the local double buffer.

        Bounded on the step path by construction: a previous ship still in
        flight (slow or unreachable depot) makes this trigger SKIP instead
        of joining it — at most one background thread ever exists, and a
        dead depot costs the trigger steps one cheap liveness check, never
        a socket-timeout stall."""
        wait = self.sync if wait is None else wait
        t = self._ship_thread
        if t is not None and t.is_alive():
            if wait:
                self.wait()  # sync mode (tests) opted into blocking
            else:
                self.ship_skips += 1
                _record_event("snapshot_skipped", self.name, step=step,
                              rank=self.rank, reason="ship_in_flight")
                return False
        t0 = time.perf_counter()
        try:
            faults.fire("snap", f"capture_step{step}_rank{self.rank}")
            entry = _materialize(self.state_provider())
        except Exception as e:
            # Exception, NOT BaseException: this runs on the training
            # thread — a Ctrl-C/SystemExit during the host copy must
            # interrupt training, not be counted as a capture failure
            self.capture_failures += 1
            self.last_error = e
            _record_event("snapshot_failed", self.name, step=step,
                          rank=self.rank, phase="capture",
                          error=repr(e)[:300])
            return False
        entry["step"] = int(step)
        entry["gen"] = int(step)  # generation IS the step: can never desync
        entry["rank"] = self.rank
        entry["ts"] = time.time()
        capture_s = time.perf_counter() - t0
        self.capture_seconds_total += capture_s
        with self._lock:
            spare = 1 - self._live if self._live >= 0 else 0
            self._buffers[spare] = entry
            self._live = spare  # the flip IS the publication
        self.captures += 1
        self.last_step = int(step)
        nbytes = sum(a.nbytes for es in entry["shards"].values()
                     for _, a in es)
        _set_gauge("snapshot_bytes", nbytes)
        _set_gauge("snapshot_gen", entry["gen"])
        _record_event("snapshot", self.name, step=step, rank=self.rank,
                      bytes=nbytes, capture_s=round(capture_s, 4),
                      replicated=self.transport is not None
                      and not self._replication_dead)
        if self.transport is not None and not self._replication_dead:
            t = threading.Thread(target=self._ship, args=(entry,),
                                 daemon=True, name="paddle-tpu-snap-ship")
            self._ship_thread = t
            t.start()
            if wait:
                self.wait()
        return True

    def _ship(self, entry: Dict[str, Any]) -> None:
        """Background replication: serialize the host-owned numpy shards
        and put the CRC-tagged payload into our own slot and the ring
        neighbor's.  A failed ship degrades RPO (recovery falls back one
        generation or to disk) — recorded loudly, never raised into the
        training thread."""
        try:
            faults.fire("snap",
                        f"ship_step{entry['step']}_rank{self.rank}")
            doc = {k: entry[k] for k in
                   ("shards", "shapes", "step", "gen", "rank")}
            try:
                # value fingerprints ride with the payload (off the step
                # cadence — this thread is already off the critical path);
                # restore recomputes them, catching depot/transit/holder-RAM
                # corruption the transport CRC cannot (the CRC is taken
                # over bytes that may already be silently wrong)
                from ..health.sdc import SDCPolicy

                doc["fp"] = _snapshot_fingerprints(
                    entry["shards"], SDCPolicy.from_env().seed,
                    {k: d for k, (_, d) in entry["shapes"].items()})
            except Exception:
                pass  # degrade to an unfingerprinted ship
            payload = pickle.dumps(doc, protocol=pickle.HIGHEST_PROTOCOL)
            crc = crc32(payload)
            holders = [self.rank] if self.peer is None \
                else [self.rank, self.peer]
            put_multi = getattr(self.transport, "put_replicated", None)
            if put_multi is not None:
                # one wire transfer covering every holder slot
                put_multi(self.rank, holders, entry["gen"],
                          entry["step"], payload, crc=crc)
            else:  # duck-typed transports may only offer put()
                for holder in holders:
                    self.transport.put(self.rank, holder, entry["gen"],
                                       entry["step"], payload, crc=crc)
            lag = time.time() - entry["ts"]
            self._ship_fail_streak = 0
            _set_gauge("snapshot_replication_lag_s", round(lag, 4))
            _record_event("snapshot_shipped", self.name,
                          step=entry["step"], rank=self.rank,
                          holder_peer=self.peer, bytes=len(payload),
                          lag_s=round(lag, 4))
        except BaseException as e:
            self.ship_failures += 1
            self._ship_fail_streak += 1
            self.last_error = e
            _record_event("snapshot_failed", self.name,
                          step=entry["step"], rank=self.rank, phase="ship",
                          error=repr(e)[:300])
            if self._ship_fail_streak >= self._max_ship_failures and \
                    not self._replication_dead:
                # the depot is persistently gone: stop burning a thread
                # (and skipped generations) per trigger — local double
                # buffering continues, recovery degrades to own-RAM/disk
                self._replication_dead = True
                _record_event("snapshot_replication_disabled", self.name,
                              rank=self.rank,
                              consecutive_failures=self._ship_fail_streak)

    def wait(self, timeout: Optional[float] = None) -> None:
        t = self._ship_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    # -- local recovery surface --------------------------------------------
    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._buffers[self._live] if self._live >= 0 else None

    def latest_step(self) -> Optional[int]:
        snap = self.latest()
        return None if snap is None else int(snap["step"])

    def restore_own(self, state_dict: Dict[str, Any]) -> Optional[int]:
        """Rung 1: fill ``state_dict`` from this process's live buffer
        (same-process relaunch).  None when no snapshot exists."""
        snap = self.latest()
        if snap is None:
            return None
        return _restore_into(state_dict, snap)

    def invalidate(self) -> None:
        """Drop the local buffers (health escalation on OUR state: the
        snapshots may hold the poison)."""
        with self._lock:
            self._buffers = [None, None]
            self._live = -1


# -- the recovery ladder -----------------------------------------------------

@dataclass
class ResumeInfo:
    """What one rank's resume resolved to."""

    source: str                      # "memory" | "peer" | "disk" | "none"
    step: Optional[int] = None       # resume step (snapshot rungs only,
    #                                  or the caller's step_key for disk)
    gen: Optional[int] = None
    path: Optional[str] = None       # disk rung: the checkpoint dir
    steps_lost: Optional[int] = None
    detail: Dict[str, Any] = field(default_factory=dict)


def _poisoned(ledger, step: Optional[int]) -> bool:
    if ledger is None or step is None:
        return False
    try:
        return bool(ledger.poisoned(step))
    except Exception:
        return False


def resume(state_dict: Dict[str, Any], ckpt_root: Optional[str] = None, *,
           snapshotter: Optional[Snapshotter] = None,
           transport: Any = "env",
           rank: Optional[int] = None, world_size: Optional[int] = None,
           ledger: Any = "auto", epoch: Optional[int] = None,
           step_key: Optional[str] = None,
           name: str = "train") -> ResumeInfo:
    """Fill ``state_dict`` from the freshest recoverable source and report
    how.  The ladder: own RAM snapshot → own copy in the snapshot store →
    peer replica → committed disk checkpoint (→ fresh start).

    All snapshot rungs resolve against the gang-agreed freshest COMPLETE
    generation, skipping generations inside a ledger-recorded poisoned
    window, so every rank lands on the same step and never on poisoned
    state.  ``step_key`` names a flat key holding the step counter so the
    disk rung can report its resume step too."""
    rank = _env_int("PADDLE_TRAINER_ID", 0) if rank is None else int(rank)
    world_size = _env_int("PADDLE_TRAINERS_NUM", 1) \
        if world_size is None else int(world_size)
    epoch = _env_int("PADDLE_TPU_GANG_EPOCH", 0) if epoch is None \
        else int(epoch)
    if transport == "env":
        transport = transport_from_env()
    if transport is None and snapshotter is not None:
        transport = snapshotter.transport
    if ledger == "auto":
        ledger = None
        if ckpt_root:
            try:
                from ..health.ledger import RewindLedger

                ledger = RewindLedger(ckpt_root)
            except Exception:
                ledger = None

    candidates: List[dict] = []
    snap_seen = False
    if transport is not None:
        try:
            raw = transport.complete_generations(world_size)
        except Exception:
            raw = []
        snap_seen = bool(raw)
        for c in raw:
            if _poisoned(ledger, c.get("step")):
                _record_event("snapshot_poisoned_skipped", name,
                              rank=rank, gen=c.get("gen"),
                              step=c.get("step"))
                continue
            candidates.append(c)
    target = candidates[0] if candidates else None

    known_steps = []
    if transport is not None:
        try:
            ms = transport.max_step()
            if ms is not None:
                known_steps.append(int(ms))
                # copies exist even when no generation is COMPLETE (the
                # double-fault case): that is still "snapshots were there
                # and could not be used" — the unrecoverable breadcrumb
                # below must fire on the disk fallback
                snap_seen = True
        except Exception:
            pass

    def _finish(info: ResumeInfo) -> ResumeInfo:
        if snapshotter is not None and snapshotter.latest_step() is not None:
            known_steps.append(snapshotter.latest_step())
        if info.step is not None and known_steps:
            info.steps_lost = max(0, max(known_steps) - int(info.step))
        _record_event("resume", name, rank=rank, source=info.source,
                      step=info.step, gen=info.gen,
                      steps_lost=info.steps_lost, epoch=epoch)
        _set_gauge("resume_steps_lost", info.steps_lost or 0)
        if transport is not None:
            try:
                transport.report_resume(rank, epoch, info.source, info.step,
                                        info.steps_lost)
            except Exception:
                pass
        stamp = os.environ.get("PADDLE_TPU_RESUME_REPORT")
        if stamp:
            try:
                with open(f"{stamp}.{rank}", "w") as f:
                    json.dump({"rank": rank, "source": info.source,
                               "step": info.step,
                               "steps_lost": info.steps_lost}, f)
            except OSError:
                pass
        return info

    # -- rung 1: own process RAM (same-process relaunch) -------------------
    own = snapshotter.latest() if snapshotter is not None else None
    if own is not None:
        snap_seen = True
        if transport is None or world_size <= 1:
            # no gang to agree with: the own buffer is authoritative
            own_ok = not _poisoned(ledger, own.get("step"))
        else:
            # gang case: only usable when it IS the agreed generation —
            # a fresher own buffer than the complete gen means some rank
            # never finished that generation; resuming from it would tear
            own_ok = target is not None and own.get("gen") == target["gen"]
        if own_ok:
            try:
                step = _restore_into(state_dict, own)
                return _finish(ResumeInfo("memory", step=step,
                                          gen=own["gen"],
                                          detail={"rung": "own_ram"}))
            except SnapshotRestoreError as e:
                _record_event("snapshot_failed", name, rank=rank,
                              phase="restore_own", error=repr(e)[:300])

    # -- rungs 2+3: snapshot store — own copy, then the peer replica -------
    if transport is not None and target is not None:
        try:
            got = transport.fetch(rank, gen=target["gen"])
        except Exception:
            got = None
        if got is not None:
            meta, payload = got
            try:
                snap = pickle.loads(payload)
                step = _restore_into(state_dict, snap)
                source = "memory" if meta.get("holder") == rank else "peer"
                return _finish(ResumeInfo(
                    source, step=step, gen=meta.get("gen"),
                    detail={"holder": meta.get("holder")}))
            except Exception as e:  # undecodable payload, coverage hole…
                _record_event("snapshot_failed", name, rank=rank,
                              phase="restore_fetched",
                              error=repr(e)[:300])

    # -- rung 4: committed disk checkpoint ---------------------------------
    if snap_seen:
        # snapshots existed but none was usable for this rank/generation —
        # the loud breadcrumb the double-fault post-mortem starts from
        _record_event("snapshot_unrecoverable", name, rank=rank,
                      world=world_size, epoch=epoch,
                      complete_generations=[c.get("gen")
                                            for c in candidates],
                      detail="falling back to committed disk checkpoint")
    if ckpt_root:
        from .commit import latest_checkpoint
        from .load_state_dict import load_state_dict

        latest = latest_checkpoint(ckpt_root)
        if latest is not None:
            load_state_dict(state_dict, latest)
            step = None
            if step_key is not None:
                flat, _ = flatten_state_dict(state_dict)
                if step_key in flat:
                    try:
                        v = tensor_value(flat[step_key])
                        step = int(v.item() if isinstance(v, torch.Tensor)
                                   else np.asarray(v))
                    except (TypeError, ValueError):
                        step = None
            return _finish(ResumeInfo("disk", step=step, path=latest))
    return _finish(ResumeInfo("none"))
