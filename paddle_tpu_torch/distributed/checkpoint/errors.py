"""Checkpoint error taxonomy.

Failure modes get distinct, catchable types with actionable messages
(the reference surfaces half-written checkpoints as raw ``pickle``
tracebacks; here a truncated or bit-flipped shard must name the file and
the protocol step that rejected it, and an interrupted save must be
distinguishable from a missing one):

- :class:`CheckpointError` — base; anything structurally wrong with a
  checkpoint directory (missing metadata, uncommitted dir).
- :class:`CheckpointCorruptionError` — bytes present but wrong (CRC32
  mismatch, unpicklable shard); names the offending file.
- :class:`AsyncSaveError` — a background ``async_save`` writer failed;
  raised on the *main* thread at the next save/wait so the failure is
  never silently swallowed by the daemon thread.
"""

from __future__ import annotations

__all__ = ["CheckpointError", "CheckpointCorruptionError", "AsyncSaveError"]


class CheckpointError(RuntimeError):
    """A checkpoint directory is structurally unusable (uncommitted,
    missing metadata, unreadable manifest)."""


class CheckpointCorruptionError(CheckpointError):
    """A shard/metadata file exists but its bytes are wrong (checksum
    mismatch or undecodable payload). The message names the file."""


class AsyncSaveError(CheckpointError):
    """A background checkpoint writer raised; re-raised at the next
    ``save_state_dict``/``_wait_pending`` on the calling thread."""
