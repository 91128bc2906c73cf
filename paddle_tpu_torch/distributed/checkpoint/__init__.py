"""Distributed (sharded) checkpoint with reshard-on-load (port of the
reference's ``distributed/checkpoint``; paddle's
``python/paddle/distributed/checkpoint/``): ``save_state_dict`` /
``load_state_dict`` in the reference's mesh-independent format (global
offsets and shapes), so a checkpoint of one layout loads under another,
and a committed checkpoint of either package loads in the other.

Crash safety: saves are atomic (staging dir → rename → ``COMMITTED``
marker last, per-shard CRC32 and value fingerprints in the metadata —
``commit.py``), storage I/O retries with backoff (``storage.py``),
async-save failures re-raise on the calling thread, and ``faults.py`` is
the seeded injector that makes all of it testable:

- :class:`Snapshotter` / :func:`resume` — in-memory peer-replicated
  snapshots (``snapshot.py`` + ``replicator.py``) and the recovery ladder
  own RAM → depot copy → peer replica → committed disk;
- :func:`latest_checkpoint` — newest *committed* checkpoint under a root;
- :func:`gc_checkpoints` — keep-N retention sweep;
- :func:`is_committed` — commit-marker check for one directory;
- :class:`CheckpointError` / :class:`CheckpointCorruptionError` /
  :class:`AsyncSaveError` — the failure taxonomy.
"""

from . import faults  # noqa: F401  (fault-injection API: faults.inject(...))
from . import replicator  # noqa: F401  (snapshot replication transports)
from .commit import (gc_checkpoints, is_committed,  # noqa: F401
                     latest_checkpoint)
from .errors import (AsyncSaveError, CheckpointCorruptionError,  # noqa: F401
                     CheckpointError)
from .load_state_dict import load_state_dict
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata
from .save_state_dict import save_state_dict
from .snapshot import (ResumeInfo, Snapshotter,  # noqa: F401
                       SnapshotRestoreError, resume)
from .utils import mark_local_shard  # noqa: F401

__all__ = ["save_state_dict", "load_state_dict", "Metadata",
           "LocalTensorMetadata", "LocalTensorIndex",
           "latest_checkpoint", "gc_checkpoints", "is_committed",
           "CheckpointError", "CheckpointCorruptionError", "AsyncSaveError",
           "faults", "replicator",
           "Snapshotter", "SnapshotRestoreError", "ResumeInfo", "resume",
           "mark_local_shard"]
