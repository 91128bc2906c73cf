"""Checkpoint commit protocol: staging dir → rename → ``COMMITTED`` marker.

A checkpoint directory is only *real* once it holds a ``COMMITTED`` marker
file — the last thing written, after every shard file and the metadata are
durably in place. The save path is:

1. every rank writes its shards (and a CRC sidecar) into ``<path>.staging``;
2. barrier — all ranks' files are on disk;
3. the coordinator folds the sidecar CRCs into ``metadata``, writes it into
   staging, renames staging → final, and writes ``COMMITTED`` last.

Any crash therefore leaves one of exactly two observable states: a
``*.staging`` directory (died before rename) or a final directory without
the marker (died between rename and marker) — both refused by
``load_state_dict`` with a clear error and both invisible to
:func:`latest_checkpoint`, which walks a checkpoint root back to the newest
*committed* directory. :func:`gc_checkpoints` is the keep-N retention
sweep (old committed checkpoints, stale staging/trash leftovers).

The marker is JSON (commit wallclock, file list, writer pid/host) so a
post-mortem can read it without importing anything.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import time
from typing import List, Optional

from . import faults, storage
from .errors import CheckpointError

__all__ = ["COMMITTED_MARKER", "staging_dir", "is_committed", "commit_dir",
           "latest_checkpoint", "gc_checkpoints"]

COMMITTED_MARKER = "COMMITTED"
_STAGING_SUFFIX = ".staging"
_TRASH_SUFFIX = ".trash"


def staging_dir(path: str) -> str:
    return path.rstrip("/") + _STAGING_SUFFIX


def is_committed(path: str) -> bool:
    """True iff ``path`` is a checkpoint directory whose save completed."""
    return os.path.isfile(os.path.join(path, COMMITTED_MARKER)) and \
        os.path.isfile(os.path.join(path, "metadata"))


def commit_dir(staging: str, final: str, extra: Optional[dict] = None) -> str:
    """Atomically publish ``staging`` as ``final`` and drop the marker.

    The rename is the atomicity point for the *data*; the marker is the
    atomicity point for the *protocol* (readers trust nothing without it).
    A pre-existing ``final`` (re-save into the same path) is rotated aside
    to ``<final>.trash.<pid>`` and deleted only after the NEW marker is on
    disk, so at every instant at least one committed copy exists; a crash
    anywhere in the rotation is healed by :func:`_recover_interrupted`
    (run by ``latest_checkpoint``/``gc_checkpoints``), which restores the
    newest committed copy to the canonical name."""
    faults.fire("rename", final)
    trash = None
    if os.path.isdir(final):
        trash = final + f"{_TRASH_SUFFIX}.{os.getpid()}"
        shutil.rmtree(trash, ignore_errors=True)
        os.rename(final, trash)
    os.rename(staging, final)

    marker = os.path.join(final, COMMITTED_MARKER)
    doc = {
        "committed_at": time.time(),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "files": sorted(f for f in os.listdir(final)
                        if f != COMMITTED_MARKER),
    }
    if extra:
        doc.update(extra)
    # the marker is the single most critical write of the protocol: give it
    # the same retry/backoff + fault seam as every shard write
    storage.write_bytes(marker, json.dumps(doc).encode(), op="commit")
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)
    return marker


def _trash_original(name: str) -> Optional[str]:
    """``ck.trash.1234`` → ``ck`` (None when not a trash name)."""
    base, sep, pid = name.rpartition(_TRASH_SUFFIX + ".")
    return base if sep and pid.isdigit() else None


def _recover_interrupted(root: str) -> None:
    """Heal crash windows of :func:`commit_dir`'s re-save rotation: a
    ``*.trash.*`` dir holding a COMMITTED copy means the process died
    mid-rotation. If the canonical name is free (died between the two
    renames) restore it; if the canonical dir exists but is *uncommitted*
    (died before the new marker landed) the new data is by-contract
    discardable — drop it and restore the old committed copy; if the
    canonical dir is committed (died before the trash sweep) the trash is
    the superseded copy — delete it."""
    for name in list(os.listdir(root)):
        orig = _trash_original(name)
        if orig is None:
            continue
        trash = os.path.join(root, name)
        if not (os.path.isdir(trash) and is_committed(trash)):
            continue  # plain garbage: gc_checkpoints sweeps it
        final = os.path.join(root, orig)
        if is_committed(final):
            shutil.rmtree(trash, ignore_errors=True)
        else:
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(trash, final)


def _commit_time(path: str) -> float:
    marker = os.path.join(path, COMMITTED_MARKER)
    try:
        with open(marker) as f:
            t = json.load(f).get("committed_at")
        if isinstance(t, (int, float)):
            return float(t)
    except (OSError, ValueError):
        pass
    try:
        return os.path.getmtime(marker)
    except OSError:
        return 0.0


def latest_checkpoint(root: str) -> Optional[str]:
    """Newest *committed* checkpoint under ``root`` (or ``root`` itself if
    it is one); ``None`` when nothing committed exists. Uncommitted
    directories — staging leftovers, crashed-mid-commit dirs — are walked
    past, which is the whole point: resume always lands on a checkpoint
    that finished."""
    if not os.path.isdir(root):
        return None
    _recover_interrupted(root)
    candidates: List[str] = []
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if os.path.isdir(p) and is_committed(p):
            candidates.append(p)
    if not candidates:
        return root if is_committed(root) else None
    return max(candidates, key=lambda p: (_commit_time(p), p))


def gc_checkpoints(root: str, keep: int = 3) -> List[str]:
    """Keep-N retention: delete all but the ``keep`` newest committed
    checkpoints under ``root``, plus stale ``*.staging`` / ``*.trash.*``
    leftovers from interrupted saves. Returns the removed paths. Never
    touches uncommitted non-staging directories (another process may be
    mid-commit)."""
    if keep < 1:
        raise CheckpointError(f"gc_checkpoints keep must be >= 1, got {keep}")
    if not os.path.isdir(root):
        return []
    _recover_interrupted(root)  # committed trash copies are restored, not swept
    committed, leftovers = [], []
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if not os.path.isdir(p):
            continue
        if name.endswith(_STAGING_SUFFIX) or _trash_original(name):
            leftovers.append(p)
        elif is_committed(p):
            committed.append(p)
    committed.sort(key=_commit_time)
    doomed = committed[:-keep] if keep < len(committed) else []
    removed = []
    for p in doomed + leftovers:
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    if removed:
        try:  # flight recorder: retention explains "where did step N go"
            from ... import telemetry

            telemetry.record_event("checkpoint_gc", root, keep=keep,
                                   removed=[os.path.basename(p)
                                            for p in removed])
        except Exception:
            pass
    return removed
