"""Sharded checkpoint save (port of the reference's
``distributed/checkpoint/save_state_dict.py``; paddle's
``save_state_dict.py:104``).

The format is the reference's, in global coordinates: each process writes
the blocks it owns to its own ``rank_k.distcp`` (a pickle of
``{(key, global_offset): array}``), and the coordinator writes one
``metadata`` (:class:`~.metadata.Metadata`) describing every block of
every tensor.  The port has no global array with addressable shards: a
tensor is whole (offset 0), as every tensor of a single-controller mesh
is, unless :func:`~.utils.mark_local_shard` tagged it as this process's
block of a larger one.  A whole tensor is written once, by the
coordinator; across processes the coordinator gathers every rank's
block list (``all_gather_object``).  bf16 blocks are held as in
:mod:`.utils`.

Crash safety (``commit.py``): every file lands in ``<path>.staging``;
after a barrier the coordinator folds each shard file's CRC32 and value
fingerprints into the metadata, renames staging → final and writes the
``COMMITTED`` marker last.  ``async_save=True`` copies the state to host
memory before it returns (the optimizers update parameters and moments
in place, so the next step must not race the writer), then fingerprints,
writes and commits on a background thread; a failure there is re-raised on the
calling thread at the next ``save_state_dict``/``_wait_pending``/
``load_state_dict``."""

from __future__ import annotations

import atexit
import json
import os
import pickle
import sys
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import commit as _commit
from . import faults
from . import storage
from .errors import AsyncSaveError
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata
from .utils import (dtype_name, flatten_state_dict, fp_array, global_place,
                    tensor_value, to_host)

__all__ = ["save_state_dict"]


class _AsyncSave:
    """One in-flight background save: the thread plus its error slot."""

    __slots__ = ("thread", "path", "error")

    def __init__(self, thread: Optional[threading.Thread], path: str):
        self.thread = thread
        self.path = path
        self.error: Optional[BaseException] = None


_pending: list = []


def _wait_pending() -> None:
    """Join all in-flight async saves; re-raise the first captured failure
    on the calling thread."""
    errs = []
    while _pending:
        p = _pending.pop()
        p.thread.join()
        if p.error is not None:
            errs.append(p)
    if errs:
        first = errs[0]
        raise AsyncSaveError(
            f"async checkpoint save to {first.path!r} failed: "
            f"{first.error!r} (raised at the next save/wait; the checkpoint "
            f"was NOT committed)") from first.error


def _drain_at_exit() -> None:
    # interpreter exit must not truncate an in-flight async checkpoint,
    # and atexit must not raise: failures go to stderr
    try:
        _wait_pending()
    except AsyncSaveError as e:
        sys.stderr.write(f"[paddle_tpu_torch.checkpoint] {e}\n")


atexit.register(_drain_at_exit)


def _rank_world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(tag: str) -> None:
    """Every rank's staged files are durable before the coordinator
    commits.  One process: nothing to wait for."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host_leaf(leaf):
    """(host array, dtype name, global offset, global shape) of a leaf."""
    v = tensor_value(leaf)
    if isinstance(v, torch.Tensor):
        offset, gshape = global_place(v)
        return to_host(v), dtype_name(v), offset, gshape
    arr = np.asarray(v)
    return arr.copy(), str(arr.dtype), (0,) * arr.ndim, tuple(arr.shape)


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    async_save: bool = False,
                    keep_n: Optional[int] = None,
                    commit_extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state_dict`` (possibly nested) as per-rank shard files plus a
    global ``metadata`` file under ``path``, committed atomically.
    ``keep_n`` runs keep-N retention over ``dirname(path)`` after the
    commit; ``commit_extra`` is folded into the ``COMMITTED`` marker."""
    _wait_pending()
    rank, world = _rank_world()
    flat, mapping = flatten_state_dict(state_dict)

    local_shards: Dict[tuple, np.ndarray] = {}
    blocks = []                    # (key, offset, local shape, dtype, whole)
    for key, leaf in flat.items():
        arr, dtype, offset, gshape = _host_leaf(leaf)
        whole = tuple(arr.shape) == tuple(gshape)
        blocks.append((key, offset, tuple(arr.shape), dtype, whole))
        if not whole or rank == coordinator_rank:
            local_shards[(key, offset)] = arr
    all_blocks = [blocks]
    if world > 1:
        import torch.distributed as dist

        all_blocks = [None] * world
        dist.all_gather_object(all_blocks, blocks)

    meta = Metadata(flat_mapping=mapping)
    for r, rank_blocks in enumerate(all_blocks):
        for key, offset, local_shape, dtype, whole in rank_blocks:
            owner = coordinator_rank if whole else r
            index = LocalTensorIndex(key, offset)
            if index in meta.storage_metadata:
                continue            # a block several ranks hold: saved once
            meta.state_dict_metadata.setdefault(key, []).append(
                LocalTensorMetadata(offset, local_shape, dtype))
            meta.storage_metadata[index] = f"rank_{owner}.distcp"

    shard_name = f"rank_{rank}.distcp"
    local_shards = {k: v for k, v in local_shards.items()
                    if meta.storage_metadata[LocalTensorIndex(*k)] == shard_name}

    from ..health.sdc import SDCPolicy, shard_fp_name, tree_fingerprints

    dtypes = {key: dtype for key, _, _, dtype, _ in blocks}
    staging = _commit.staging_dir(path)

    def _write():
        # value fingerprints, from the host copies before serialisation: the
        # window the CRC (taken over the serialised bytes) cannot see.  The
        # copies are this save's own, so an async save takes them here, off
        # the caller's thread
        shard_fps = tree_fingerprints(
            {shard_fp_name(key, off): fp_array(arr, dtypes[key])
             for (key, off), arr in local_shards.items()}, SDCPolicy.from_env().seed)
        # chaos seam: an armed "sdc" spec corrupts the payload here, after
        # fingerprinting and before serialisation
        if faults.active():
            for key_off in list(local_shards):
                flipped = faults.fire("sdc", f"ckpt_serialize/{key_off[0]}",
                                      data=local_shards[key_off])
                if flipped is not local_shards[key_off]:
                    local_shards[key_off] = flipped
        os.makedirs(staging, exist_ok=True)
        payload = pickle.dumps(local_shards, protocol=pickle.HIGHEST_PROTOCOL)
        crc = storage.write_bytes(os.path.join(staging, shard_name), payload)
        # sidecars: the coordinator cannot see other ranks' bytes, so each
        # rank publishes its checksum and fingerprints beside its file
        storage.write_bytes(os.path.join(staging, shard_name + ".crc32"),
                            str(crc).encode())
        storage.write_bytes(os.path.join(staging, shard_name + ".fp"),
                            json.dumps(shard_fps).encode())
        _barrier("staged")
        if rank == coordinator_rank:
            for f in sorted(os.listdir(staging)):
                if f.endswith(".crc32"):
                    meta.file_checksums[f[:-len(".crc32")]] = \
                        int(storage.read_bytes(os.path.join(staging, f)))
                    os.remove(os.path.join(staging, f))
                elif f.endswith(".fp"):
                    meta.tensor_fingerprints.update(json.loads(
                        storage.read_bytes(os.path.join(staging, f))))
                    os.remove(os.path.join(staging, f))
            storage.write_bytes(os.path.join(staging, "metadata"),
                                pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL))
            _commit.commit_dir(staging, path,
                               extra={"keys": len(flat), "async_save": bool(async_save),
                                      **(commit_extra or {})})
            if keep_n is not None:
                _commit.gc_checkpoints(os.path.dirname(os.path.abspath(path)) or ".",
                                       keep=keep_n)
        _barrier("committed")

    if async_save:
        def _write_captured(p: "_AsyncSave") -> None:
            try:
                _write()
            except BaseException as e:  # surfaced at the next save/wait
                p.error = e
                _record("checkpoint_save_failed", path, rank=rank,
                        error=repr(e)[:300], async_save=True)

        pend = _AsyncSave(None, path)
        pend.thread = threading.Thread(daemon=True, name="paddle-tpu-ckpt-writer",
                                       target=_write_captured, args=(pend,))
        _pending.append(pend)
        pend.thread.start()
    else:
        _write()
    _record("checkpoint_save", path, rank=rank, keys=len(flat),
            async_save=bool(async_save))


def _record(kind: str, name: str, **data) -> None:
    from ... import telemetry

    telemetry.record_event(kind, name, **data)
