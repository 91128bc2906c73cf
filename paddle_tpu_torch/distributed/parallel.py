"""Process bootstrap and ``DataParallel`` (port of the reference's
``distributed/parallel.py``; reference ``python/paddle/distributed/
parallel.py``: init_parallel_env :943, the env contract :687-710,
DataParallel :202).

``init_parallel_env`` reads the launcher's environment contract
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_COORDINATOR`` or
``PADDLE_MASTER``, else the first of ``PADDLE_TRAINER_ENDPOINTS``) and
creates the ``torch.distributed`` process group: NCCL when the process
runs on the card (the default), gloo only after ``set_device("cpu")``.
NCCL takes one rank per card, so more processes on a node than visible
cards raise; nothing falls back to gloo or to the CPU.  Then it sets the
default ``HybridCommunicateGroup(dp=world)``, one member a process.

When the launcher exported a fleet store (``PADDLE_TPU_FLEET_STORE``),
the process first joins the job's fault domain
(``fleet.fault_domain.init_from_env``: heartbeat lease, poison poll, and
the gang barrier when a ``FleetSupervisor`` armed one); a domain that is
armed and fails to start raises.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..device import devices as _visible_devices
from ..device import resolve_device
from ..framework.flags import get_flags
from ..nn.layer.layers import Layer
from .communication import ReduceOp, _mp_all_reduce, _multi, _resolve_group
from .topology import (_HYBRID_AXES, HybridCommunicateGroup, Mesh,
                       get_hybrid_communicate_group, process_rank,
                       set_hybrid_communicate_group)

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "DataParallel", "is_initialized"]

_initialized = False


def _card_of_this_process() -> torch.device:
    """The card of this process: ``cuda:PADDLE_LOCAL_RANK``.  NCCL refuses
    two ranks on one card, so a node with more processes than cards
    raises."""
    local = int(os.environ.get("PADDLE_LOCAL_RANK", "0"))
    per_node = int(os.environ.get("PADDLE_NPROC_PER_NODE", "1"))
    cards = torch.cuda.device_count()
    if max(per_node, local + 1) > cards:
        raise RuntimeError(
            f"init_parallel_env: NCCL takes one rank per card, and this node runs "
            f"{max(per_node, local + 1)} processes on {cards} visible card(s); launch "
            f"--nproc_per_node {cards} at most, or call set_device('cpu') first for gloo")
    return torch.device("cuda", local)


def init_parallel_env(strategy=None) -> "ParallelEnv":
    """Create this process's ``torch.distributed`` process group from the
    launcher's environment and the default hybrid group over the job's
    processes (a single process with no master address gets a group of
    one)."""
    global _initialized
    if _initialized:
        return ParallelEnv()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    # PADDLE_COORDINATOR: on several nodes the launcher's rendezvous store
    # HOLDS the PADDLE_MASTER port for the whole job, so the process group
    # rendezvous at the port it exports beside it
    master = os.environ.get("PADDLE_COORDINATOR", os.environ.get("PADDLE_MASTER"))
    if master is None:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        master = eps.split(",")[0] if eps else None
    if master is None and nprocs > 1:
        raise RuntimeError("multi-process init requires PADDLE_MASTER or "
                           "PADDLE_COORDINATOR")
    # the fleet fault domain first (heartbeat lease + poison poll, + the
    # gang barrier when a FleetSupervisor armed one), so that a join that
    # fails leaves no process group behind
    try:
        from .fleet import fault_domain as _fd

        _fd.init_from_env()
    except Exception:
        # an ARMED fault domain failing to start must be loud: a partial
        # gang or an unreachable fleet store would let this rank train
        # unprotected, and wedge the way the fault domain exists to prevent
        if os.environ.get("PADDLE_TPU_FLEET_STORE"):
            raise
    device = resolve_device()
    if device.type == "cuda":
        device = _card_of_this_process()
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    timeout = timedelta(seconds=float(get_flags("comm_timeout_seconds")["comm_timeout_seconds"]))
    if master is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{master}", rank=rank,
                                world_size=nprocs, timeout=timeout)
    if get_hybrid_communicate_group() is None:
        world = dist.get_world_size()
        # each process knows only its own member's device: every member is
        # recorded as this process's, and procs says whose member it is
        members = np.empty(world, dtype=object)
        members[:] = [device] * world
        shape = (world, 1, 1, 1, 1)
        mesh = Mesh(members.reshape(shape), _HYBRID_AXES, np.arange(world).reshape(shape))
        set_hybrid_communicate_group(HybridCommunicateGroup(mesh=mesh))
    _initialized = True
    return ParallelEnv()


def is_initialized() -> bool:
    return _initialized


def _has_process_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _processes() -> int:
    return dist.get_world_size() if _has_process_group() else 1


def get_rank(group=None) -> int:
    """This process's rank in the job (0 without a process group)."""
    return process_rank()


def get_world_size(group=None) -> int:
    """``group``'s size; else the job's processes, or, without a process
    group, the devices one process drives (the reference's
    ``len(jax.devices())``)."""
    if group is not None:
        return group.nranks
    return _processes() if _has_process_group() else len(_visible_devices())


class ParallelEnv:
    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def device_id(self) -> int:
        return torch.cuda.current_device() if _has_process_group() \
            and dist.get_backend() == "nccl" else 0

    @property
    def nranks(self) -> int:
        return self.world_size

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("PADDLE_LOCAL_RANK", self.rank))


class DataParallel(Layer):
    """paddle.DataParallel (reference parallel.py:202 → EagerReducer), an
    ``nn.Layer`` as in the reference, so it answers the ``Layer`` methods
    (``sublayers``, ``clear_gradients``, ``named_parameters(
    include_sublayers=False)``, ...).

    The forward passes through; ``parameters`` and ``state_dict``/
    ``set_state_dict``/``load_state_dict`` are the inner model's (keys with
    no ``_layers.`` prefix), as the reference's are.  With several processes each holds its
    local gradients after ``backward``; ``apply_collective_grads``
    averages them over the data-parallel group (``jit.TrainStep`` calls it
    after the backward).  With one process the gradients of the batch are
    already the synchronised value, and it returns at once."""

    def __init__(self, layers: nn.Module, strategy=None, comm_buffer_size: int = 25,
                 last_comm_buffer_size: int = 1, find_unused_parameters: bool = False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group
        self._comm_buffer_bytes = int(comm_buffer_size) * 1024 * 1024

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        if isinstance(self._layers, Layer):
            return self._layers.set_state_dict(state_dict, use_structured_name)
        return self._layers.load_state_dict(state_dict)

    set_dict = load_dict = set_state_dict

    def parameters(self, include_sublayers: bool = True, *, recurse=None) -> List[nn.Parameter]:
        recurse = include_sublayers if recurse is None else recurse
        return list(self._layers.parameters(recurse=recurse))

    @property
    def parameters_(self) -> List[nn.Parameter]:
        return list(self._layers.parameters())

    def _grad_buckets(self) -> List[List[nn.Parameter]]:
        """Parameters with gradients in ~``comm_buffer_size``-MB buckets,
        PER GRADIENT DTYPE (the reference fuses per dtype so bf16 buckets
        travel as bf16, reducer.h:88), in reverse parameter order (grads
        become ready back to front in the backward)."""
        by_dtype: dict = {}
        for p in reversed(list(self._layers.parameters())):
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p)
        out = []
        for params in by_dtype.values():
            bucket, size = [], 0
            for p in params:
                nbytes = (p.grad.numel() or 1) * p.grad.element_size()
                if bucket and size + nbytes > self._comm_buffer_bytes:
                    out.append(bucket)
                    bucket, size = [], 0
                bucket.append(p)
                size += nbytes
            if bucket:
                out.append(bucket)
        return out

    def apply_collective_grads(self) -> None:
        """Average the local gradients over the data-parallel group with the
        reducer's FUSED-bucket semantics (reference `reducer.h:88`): each
        bucket is packed into one flat buffer in the gradients' own dtype,
        averaged by ONE all_reduce, and unpacked.  With one process it
        returns at once (reference :186)."""
        if _processes() == 1:
            return  # the batch's gradients are already the synced value
        self._sync_buckets()

    @torch.no_grad()
    def _sync_buckets(self) -> None:
        """``apply_collective_grads`` past its one-process return: one AVG
        all_reduce a bucket over the data-parallel process group."""
        hcg = get_hybrid_communicate_group()
        group = self._group or (hcg.get_data_parallel_group() if hcg
                                else _resolve_group(None))
        if not _multi(group):
            raise RuntimeError("DataParallel gradient sync needs the process group "
                               "of init_parallel_env")
        for bucket in self._grad_buckets():
            flats = [p.grad.reshape(-1) for p in bucket]
            flat = torch.cat(flats) if len(flats) > 1 else flats[0]
            _mp_all_reduce(flat, ReduceOp.AVG, group)
            if len(bucket) == 1 and flat.data_ptr() == bucket[0].grad.data_ptr():
                continue                      # reduced in place
            off = 0
            for p in bucket:
                n = p.grad.numel()
                p.grad.copy_(flat[off:off + n].view_as(p.grad))
                off += n
