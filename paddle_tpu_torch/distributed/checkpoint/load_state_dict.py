"""Sharded checkpoint load with reshard-on-load (port of the reference's
``distributed/checkpoint/load_state_dict.py``; paddle's
``load_state_dict.py:377``, ``compute_overlap:247``).

The caller's state dict defines what is wanted: each tensor leaf is filled
in place (``copy_``, on its own device and in its own dtype) from the saved
blocks that overlap it, whole, or, when :func:`~.utils.mark_local_shard`
tagged it, its block of the global tensor.  So a checkpoint saved under one
layout loads under any other.  A directory without the ``COMMITTED``
marker is refused up front (escape hatch for pre-protocol checkpoints:
``PADDLE_TPU_CKPT_ALLOW_UNCOMMITTED=1``); each shard file's CRC32 is checked
before it is unpickled, and each block's values against the fingerprint
recorded before serialisation (``PADDLE_TPU_SDC_VERIFY_LOAD=0`` skips the
latter).

A checkpoint that the reference wrote pickles its metadata classes under
``paddle_tpu``'s module path; the unpickler here maps those names onto the
port's own classes and imports nothing of the reference.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import commit as _commit
from . import metadata as _metadata
from . import storage
from .errors import CheckpointCorruptionError, CheckpointError
from .metadata import LocalTensorIndex
from .save_state_dict import _wait_pending
from .utils import (compute_overlap, flatten_state_dict, fp_array, from_host,
                    global_place, host_bits, host_empty, tensor_value, unflatten_key)

__all__ = ["load_state_dict"]

_REFERENCE_METADATA = "paddle_tpu.distributed.checkpoint.metadata"


class _Unpickler(pickle.Unpickler):
    """Reads the reference's metadata classes as the port's."""

    def find_class(self, module, name):
        if module == _REFERENCE_METADATA and name in _metadata.__all__:
            return getattr(_metadata, name)
        return super().find_class(module, name)


def _loads(data: bytes):
    return _Unpickler(io.BytesIO(data)).load()


class _ShardFiles:
    """Lazy per-file shard cache: a rank file is read (and its CRC32
    verified) at most once, and each block accessed is checked against its
    save-time value fingerprint."""

    def __init__(self, path: str, checksums: Dict[str, int],
                 fingerprints: Optional[Dict[str, str]] = None, fp_seed: int = 0):
        self.path = path
        self.checksums = checksums
        self.fingerprints = fingerprints or {}
        self.fp_seed = fp_seed
        self._fp_checked: set = set()
        self._cache: Dict[str, Dict[tuple, np.ndarray]] = {}

    def _verify_fp(self, file_name: str, key: str, offset: tuple, arr: np.ndarray,
                   dtype: str) -> None:
        from ..health.sdc import shard_fp_name, tree_fingerprints

        name = shard_fp_name(key, offset)
        if name in self._fp_checked:
            return
        self._fp_checked.add(name)
        want = self.fingerprints.get(name)
        if want is None:
            return
        got = tree_fingerprints({name: fp_array(arr, dtype)}, self.fp_seed)[name]
        if got != want:
            self._mismatch(file_name, key, offset)

    def _mismatch(self, file_name: str, key: str, offset: tuple):
        raise CheckpointCorruptionError(
            f"value-fingerprint mismatch in tensor {key!r} (shard "
            f"offset {offset}, file {file_name!r}) of checkpoint "
            f"{self.path!r}: the deserialized values do not match the "
            f"fingerprint recorded before serialization at save time — "
            f"the payload was silently corrupted between the host copy "
            f"and commit (a window the per-file CRC cannot see). Set "
            f"PADDLE_TPU_SDC_VERIFY_LOAD=0 to load anyway.")

    def get(self, file_name: str, key: str, offset: tuple, dtype: str) -> np.ndarray:
        arr = self._block(file_name, key, offset)
        if self.fingerprints:
            self._verify_fp(file_name, key, offset, arr, dtype)
        return arr

    def _block(self, file_name: str, key: str, offset: tuple) -> np.ndarray:
        if file_name not in self._cache:
            full = os.path.join(self.path, file_name)
            data = storage.read_bytes(full)
            want = self.checksums.get(file_name)
            if want is not None and storage.crc32(data) != want:
                raise CheckpointCorruptionError(
                    f"checksum mismatch in shard file {file_name!r} of "
                    f"checkpoint {self.path!r}: expected crc32 {want}, got "
                    f"{storage.crc32(data)} over {len(data)} bytes — the "
                    f"file is corrupt or was truncated after commit")
            try:
                self._cache[file_name] = _loads(data)
            except Exception as e:
                raise CheckpointCorruptionError(
                    f"shard file {file_name!r} of checkpoint {self.path!r} "
                    f"is undecodable ({type(e).__name__}: {e}); its bytes "
                    f"are damaged") from e
        return self._cache[file_name][(key, offset)]


def _check_committed(path: str) -> None:
    if _commit.is_committed(path):
        return
    if os.environ.get("PADDLE_TPU_CKPT_ALLOW_UNCOMMITTED") == "1" and \
            os.path.isfile(os.path.join(path, "metadata")):
        return  # pre-commit-protocol checkpoint, explicitly allowed
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"no checkpoint directory at {path!r}"
            + (f" (a staging dir {_commit.staging_dir(path)!r} exists: the "
               f"save that produced it never finished)"
               if os.path.isdir(_commit.staging_dir(path)) else ""))
    raise CheckpointError(
        f"checkpoint at {path!r} has no {_commit.COMMITTED_MARKER} marker — "
        f"the save was interrupted before commit and the directory may be "
        f"incomplete. Use latest_checkpoint(root) to resume from the newest "
        f"committed checkpoint (or set PADDLE_TPU_CKPT_ALLOW_UNCOMMITTED=1 "
        f"to force-load a pre-protocol checkpoint).")


def read_metadata(path: str):
    """The :class:`~.metadata.Metadata` of the checkpoint at ``path``."""
    # a read failure is a storage outage (retries exhausted) and propagates
    # as OSError; only an undecodable payload is corruption
    data = storage.read_bytes(os.path.join(path, "metadata"))
    try:
        return _loads(data)
    except Exception as e:
        raise CheckpointCorruptionError(
            f"metadata file of checkpoint {path!r} is undecodable "
            f"({type(e).__name__}: {e})") from e


def _assemble(files: _ShardFiles, meta, key: str, offset, local_shape) -> np.ndarray:
    """The wanted block of ``key`` from every saved block that overlaps it
    (bf16 as uint16 bits)."""
    saved = meta.state_dict_metadata[key]
    dtype = saved[0].dtype
    out = host_empty(local_shape, dtype)
    covered = 0
    for sm in saved:
        ov = compute_overlap(sm.global_offset, sm.local_shape, offset, local_shape)
        if ov is None:
            continue
        src, dst = ov
        piece = files.get(meta.storage_metadata[LocalTensorIndex(key, sm.global_offset)],
                          key, sm.global_offset, dtype)
        out[dst] = host_bits(piece, dtype)[src]
        covered += int(np.prod([s.stop - s.start for s in dst]))
    if covered != int(np.prod(local_shape)):
        raise ValueError(
            f"saved shards of {key!r} do not cover wanted slice "
            f"offset={offset} shape={local_shape} "
            f"({covered}/{int(np.prod(local_shape))} elements)")
    return out


def load_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0) -> None:
    """Fill ``state_dict``'s tensors in place from the checkpoint at
    ``path``, resharding the saved blocks onto each target's block."""
    _wait_pending()
    _check_committed(path)
    meta = read_metadata(path)
    from ..health.sdc import SDCPolicy, verify_load_enabled

    fps = (getattr(meta, "tensor_fingerprints", None) or {}) if verify_load_enabled() else {}
    files = _ShardFiles(path, getattr(meta, "file_checksums", {}) or {},
                        fingerprints=fps, fp_seed=SDCPolicy.from_env().seed)
    flat, mapping = flatten_state_dict(state_dict)
    for key, leaf in flat.items():
        if key not in meta.state_dict_metadata:
            raise KeyError(f"checkpoint at {path!r} has no tensor {key!r}; "
                           f"saved keys: {sorted(meta.state_dict_metadata)[:8]}...")
        saved = meta.state_dict_metadata[key]
        v = tensor_value(leaf)
        if not isinstance(v, torch.Tensor):
            # a plain Python or numpy leaf: written back into the dict
            sm = saved[0]
            data = _assemble(files, meta, key, sm.global_offset, sm.local_shape)
            if sm.dtype == "bfloat16":
                data = from_host(data, "bfloat16").float().numpy()
            value = data.item() if data.ndim == 0 else data
            if isinstance(leaf, int) and data.ndim == 0:
                value = int(value)
            unflatten_key(state_dict, mapping[key], value)
            continue
        offset, _ = global_place(v)
        data = _assemble(files, meta, key, offset, tuple(v.shape))
        with torch.no_grad():
            v.copy_(from_host(data, saved[0].dtype).to(v.dtype))
    _record("checkpoint_load", path, keys=len(flat))


def _record(kind: str, name: str, **data) -> None:
    from ... import telemetry

    telemetry.record_event(kind, name, **data)
