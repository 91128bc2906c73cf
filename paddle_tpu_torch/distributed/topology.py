"""Hybrid-parallel topology over the devices one process drives (port of
the reference's ``distributed/topology.py``).

The reference lays ``["data", "pipe", "sharding", "sep", "model"]`` out as
the axes of a ``jax.sharding.Mesh`` and lets XLA run one program per device.
The port's :class:`Mesh` is the same bookkeeping over ``torch.device``
members: an array of devices with named axes and ``shape`` as a dict.  One
process drives every member, as the JAX engine's single controller does, so
a member is a position on the mesh, not a process, and ``devices=`` may
repeat a device: n ring members can share one card, or the CPU.

Only the ``sep`` axis (context parallelism: :mod:`.meta_parallel.context_parallel`)
runs here.  A degree above 1 on ``data``, ``pipe``, ``sharding`` or
``model`` needs the multi-process NCCL core and raises
``NotImplementedError`` (ROADMAP A6).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import devices as _visible_devices

__all__ = ["Mesh", "CommunicateTopology", "CommGroup", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group", "build_mesh"]

_HYBRID_AXES = ("data", "pipe", "sharding", "sep", "model")


class Mesh:
    """``devices``: an array of ``torch.device`` members, one axis per
    name of ``axis_names``; ``shape`` maps each axis to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

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
    others = {a: v for a, v in degrees.items() if a != "sep" and v > 1}
    if others:
        raise NotImplementedError(
            f"build_mesh: degrees {others} need the multi-process NCCL core, which is "
            f"not ported to paddle_tpu_torch yet (ROADMAP A6); only sep runs here")
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


class CommGroup:
    """A communication group: a set of mesh axes.  One process drives every
    member, so its rank in any group is 0."""

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
        return 0

    def __repr__(self):
        return f"CommGroup(axes={self.axes}, nranks={self.nranks})"


class HybridCommunicateGroup:
    """The reference's ``HybridCommunicateGroup`` over a :class:`Mesh`: its
    topology, and the sep degree, group and rank (the other axes wait for
    ROADMAP A6)."""

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
        self.global_rank = 0

    def get_sep_parallel_world_size(self) -> int:
        return self.mesh.shape["sep"]

    def get_sep_parallel_group(self) -> CommGroup:
        return CommGroup(self.mesh, ("sep",))

    def get_sep_parallel_rank(self) -> int:
        return 0

    def topology(self) -> CommunicateTopology:
        return self._topo


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]) -> None:
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
