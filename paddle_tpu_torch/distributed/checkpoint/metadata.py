"""Sharded-checkpoint metadata schema (port of the reference's
``distributed/checkpoint/metadata.py``).

Mirrors the reference's mesh-independent format
(`python/paddle/distributed/checkpoint/metadata.py:20-40`):

- ``state_dict_metadata``: flat key → list of :class:`LocalTensorMetadata`
  (one per saved shard: global_offset, local_shape, dtype)
- ``storage_metadata``: :class:`LocalTensorIndex` (key, global_offset) →
  shard file name
- ``flat_mapping``: flat key → original nested key path
- ``file_checksums``: shard file name → CRC32 of its bytes, recorded at
  save time and verified on every load (a bit-flipped or truncated shard
  fails with a checksum error naming the file, not a pickle traceback);
  absent in checkpoints written before the commit protocol — loaders use
  ``getattr(meta, "file_checksums", {})``
- ``tensor_fingerprints``: ``"key@offset"`` → hex fingerprint
  (:func:`~..health.sdc.host_fingerprint`: seeded ±1 projection +
  abs-sum) of each saved shard's VALUES, computed from the in-memory
  arrays *before* serialization and re-verified after deserialization on
  load — end-to-end integrity the CRC cannot give (the CRC covers the
  serialized bytes, so corruption between device-get and pickling is
  CRC-self-consistent). Same back-compat discipline:
  ``getattr(meta, "tensor_fingerprints", {})``; load verification is
  skipped with ``PADDLE_TPU_SDC_VERIFY_LOAD=0``

Because the schema speaks only in global offsets/shapes, a checkpoint saved
under one mesh/parallelism config can be loaded under any other — the loader
intersects saved slices with wanted slices (reshard-on-load)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["LocalTensorMetadata", "LocalTensorIndex", "Metadata"]


@dataclass(frozen=True)
class LocalTensorMetadata:
    """One saved shard of a tensor, in global coordinates."""

    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    dtype: str


@dataclass(frozen=True, eq=False)
class LocalTensorIndex:
    """Identity of a saved shard: (flat key, global offset).  Equal to any
    index of the same key and offset, the reference's class included, and
    hashed as the reference's dataclass hashes: so either package finds
    its blocks in the other's ``storage_metadata``."""

    tensor_key: str
    global_offset: Tuple[int, ...]

    def __eq__(self, other):
        try:
            return (self.tensor_key, tuple(self.global_offset)) == \
                (other.tensor_key, tuple(other.global_offset))
        except AttributeError:
            return NotImplemented

    def __hash__(self):
        return hash((self.tensor_key, self.global_offset))


@dataclass
class Metadata:
    state_dict_metadata: Dict[str, List[LocalTensorMetadata]] = field(default_factory=dict)
    storage_metadata: Dict[LocalTensorIndex, str] = field(default_factory=dict)
    flat_mapping: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    file_checksums: Dict[str, int] = field(default_factory=dict)
    tensor_fingerprints: Dict[str, str] = field(default_factory=dict)
