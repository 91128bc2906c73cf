"""Hybrid-parallel topology over the devices one process drives (port of
the reference's ``distributed/topology.py``).

The reference lays ``["data", "pipe", "sharding", "sep", "model"]`` out as
the axes of a ``jax.sharding.Mesh`` and lets XLA run one program per device.
The port's :class:`Mesh` is the same bookkeeping over ``torch.device``
members: an array of devices with named axes and ``shape`` as a dict.

Two modes, as in the reference:
- single controller (:func:`build_mesh`): one process drives every member,
  as the JAX engine's single controller does, so a member is a position on
  the mesh, not a process, and ``devices=`` may repeat a device: n members
  can share one card, or the CPU;
- multi-process (``distributed.init_parallel_env``): member i is process
  i's device, ``Mesh.procs`` says which process owns each member, and a
  group's collectives run over ``torch.distributed``.

The ``data`` axis (data parallelism: the collectives and ``DataParallel``),
the ``sep`` axis (context parallelism: :mod:`.meta_parallel.context_parallel`)
and the ``model`` axis (tensor parallelism: :mod:`.meta_parallel.mp_layers`,
:mod:`.meta_parallel.sequence_parallel`, the mesh wrappers of
``ops/sharded.py`` and ``ServingEngine(tp=n)``) run here.  A degree above 1
on ``pipe`` or ``sharding`` waits for ROADMAP A6c and raises
``NotImplementedError``; the sharding axis's groups and ranks exist at
degree 1, as the pipe axis's do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import devices as _visible_devices

__all__ = ["Mesh", "CommunicateTopology", "CommGroup", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group", "build_mesh",
           "process_mesh_coords"]

_HYBRID_AXES = ("data", "pipe", "sharding", "sep", "model")
_WAITING = {"pipe": "A6c", "sharding": "A6c"}   # their queue items


class Mesh:
    """``devices``: an array of ``torch.device`` members, one axis per
    name of ``axis_names``; ``shape`` maps each axis to its size.
    ``procs`` (multi-process meshes only): an int array of the same shape,
    the rank of the process that owns each member; None when one process
    drives them all."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 procs: Optional[np.ndarray] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        if procs is not None and procs.shape != devices.shape:
            raise ValueError(f"procs {procs.shape} and devices {devices.shape} differ")
        self.procs = procs

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The members along ``axis`` at position 0 of every other axis."""
        at = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return list(self.devices[at])

    def __repr__(self):
        return f"Mesh({self.shape})"


def _indexed(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_mesh(dp: int = 1, pp: int = 1, sharding: int = 1, sep: int = 1, mp: int = 1,
               devices=None) -> Mesh:
    """The hybrid mesh over ``devices`` (default: every visible card).
    Degrees multiply to the device count; one degree of -1 absorbs the
    remainder, as the reference's strategy allows."""
    devs = [_indexed(d) for d in (devices if devices is not None else _visible_devices())]
    n = len(devs)
    degrees = {"data": dp, "pipe": pp, "sharding": sharding, "sep": sep, "model": mp}
    unknown = [a for a, v in degrees.items() if v == -1]
    known = int(np.prod([v for v in degrees.values() if v != -1]))
    if unknown:
        if len(unknown) > 1:
            raise ValueError("at most one degree may be -1")
        if n % known != 0:
            raise ValueError(f"device count {n} not divisible by fixed degrees {known}")
        degrees[unknown[0]] = n // known
    waiting = {a: v for a, v in degrees.items() if a in _WAITING and v > 1}
    if waiting:
        raise NotImplementedError(
            "build_mesh: " + ", ".join(f"{a} degree {v} waits for ROADMAP {_WAITING[a]}"
                                       for a, v in waiting.items())
            + " (data, sep and model run in paddle_tpu_torch)")
    total = int(np.prod(list(degrees.values())))
    if total != n:
        raise ValueError(
            f"parallel degrees {degrees} multiply to {total}, but {n} device(s) given")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(degrees[a] for a in _HYBRID_AXES)), _HYBRID_AXES)


class CommunicateTopology:
    """Axis bookkeeping (the reference's ``CommunicateTopology``)."""

    def __init__(self, hybrid_group_names: Sequence[str] = _HYBRID_AXES,
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._parallel_names)

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self) -> int:
        return int(np.prod(self._dims))

    def get_dim_size(self, axis_name: str) -> int:
        return self.get_dim(axis_name)


def process_rank() -> int:
    """This process's rank in the job: torch.distributed's rank once a
    process group exists, else 0."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_mesh_coords(mesh: Mesh) -> Dict[str, int]:
    """This process's coordinates on ``mesh``: those of the first member it
    owns (all zeros on a single-controller mesh, whose one process owns
    every member)."""
    if mesh.procs is not None:
        hits = np.argwhere(mesh.procs == process_rank())
        if len(hits):
            return dict(zip(mesh.axis_names, (int(i) for i in hits[0])))
    return {a: 0 for a in mesh.axis_names}


class CommGroup:
    """A communication group: a set of mesh axes (the reference's
    ``CommGroup``, its analogue of a ProcessGroup).  ``rank`` is this
    process's position in the group: 0 on a single-controller mesh."""

    def __init__(self, mesh: Mesh, axes: Tuple[str, ...], group_id: int = 0):
        self.mesh = mesh
        self.axes = tuple(axes)
        self.id = group_id

    @property
    def nranks(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.axes])) if self.axes else 1

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        """This process's mesh coordinates along the group axes, flattened
        in axis order."""
        coords = process_mesh_coords(self.mesh)
        r = 0
        for a in self.axes:
            r = r * self.mesh.shape[a] + coords[a]
        return r

    def __repr__(self):
        return f"CommGroup(axes={self.axes}, nranks={self.nranks})"


class HybridCommunicateGroup:
    """The reference's ``HybridCommunicateGroup`` over a :class:`Mesh`: its
    topology, the per-axis groups (data, model, pipe, sharding, sep), the
    fused data×sep and check groups, the global group, and this process's
    rank on each axis."""

    def __init__(self, topology: Optional[CommunicateTopology] = None, *,
                 mesh: Optional[Mesh] = None, dp: int = 1, pp: int = 1, sharding: int = 1,
                 sep: int = 1, mp: int = 1):
        if mesh is None:
            if topology is not None:
                dims = dict(zip(topology.get_hybrid_group_names(), topology._dims))
                mesh = build_mesh(dims.get("data", 1), dims.get("pipe", 1),
                                  dims.get("sharding", 1), dims.get("sep", 1),
                                  dims.get("model", 1))
            else:
                mesh = build_mesh(dp, pp, sharding, sep, mp)
        self.mesh = mesh
        self._topo = CommunicateTopology(_HYBRID_AXES, [mesh.shape[a] for a in _HYBRID_AXES])
        self.nranks = mesh.size
        self.global_rank = process_rank()

    # degrees
    def get_data_parallel_world_size(self) -> int:
        return self.mesh.shape["data"]

    def get_model_parallel_world_size(self) -> int:
        return self.mesh.shape["model"]

    def get_pipe_parallel_world_size(self) -> int:
        return self.mesh.shape["pipe"]

    def get_sharding_parallel_world_size(self) -> int:
        return self.mesh.shape["sharding"]

    def get_sep_parallel_world_size(self) -> int:
        return self.mesh.shape["sep"]

    # groups
    def get_data_parallel_group(self) -> CommGroup:
        return CommGroup(self.mesh, ("data",))

    def get_model_parallel_group(self) -> CommGroup:
        return CommGroup(self.mesh, ("model",))

    def get_pipe_parallel_group(self) -> CommGroup:
        return CommGroup(self.mesh, ("pipe",))

    def get_sharding_parallel_group(self) -> CommGroup:
        return CommGroup(self.mesh, ("sharding",))

    def get_sep_parallel_group(self) -> CommGroup:
        return CommGroup(self.mesh, ("sep",))

    def get_dp_sep_parallel_group(self) -> CommGroup:
        return CommGroup(self.mesh, ("data", "sep"))

    def get_check_parallel_group(self, sharding: bool = False) -> CommGroup:
        """The group over every axis but data (without sharding when
        ``sharding``): the inf/nan check and global-norm reduction."""
        axes = ("pipe", "sep", "model") if sharding else ("pipe", "sharding", "sep", "model")
        return CommGroup(self.mesh, axes)

    def get_global_group(self) -> CommGroup:
        return CommGroup(self.mesh, _HYBRID_AXES)

    # this process's coordinates (all 0 on a single-controller mesh)
    def get_data_parallel_rank(self) -> int:
        return process_mesh_coords(self.mesh)["data"]

    def get_model_parallel_rank(self) -> int:
        return process_mesh_coords(self.mesh)["model"]

    def get_sharding_parallel_rank(self) -> int:
        return process_mesh_coords(self.mesh)["sharding"]

    def get_sep_parallel_rank(self) -> int:
        return process_mesh_coords(self.mesh)["sep"]

    def get_stage_id(self) -> int:
        return process_mesh_coords(self.mesh)["pipe"]

    def topology(self) -> CommunicateTopology:
        return self._topo


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]) -> None:
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
