"""The semi-automatic parallel API (port of the reference's
``distributed/auto_parallel/__init__.py``; paddle's
``auto_parallel/api.py``: ``shard_tensor`` :126, ``reshard`` :304,
``shard_layer`` :403, ``shard_optimizer`` :736), the reference's
recommended distributed API.

A ``ProcessMesh`` names the dims of an array of members;
``Shard(d)`` / ``Replicate()`` / ``Partial()``, one per mesh dim, place a
tensor on it.  The port's design is a tensor with placement: on the single
controller a distributed tensor is the GLOBAL ``torch.Tensor`` on the
mesh's first member, tagged with its mesh, placements, pending Partial
axes and spec (``_dist_attr``), the global-array view the reference's
``Tensor`` holds.  Every op sees the global value, so placement is
bookkeeping until a step reads it: ``DistributedTrainStep`` takes a
parameter's spec from its tag when the tag's mesh has the hybrid mesh's
axes and sizes (``engine._current_spec``), as the reference's reads the
array's ``NamedSharding``, so a ``shard_layer``-ed parameter keeps its
layout there.

Partial values follow the reference's "eager-avg" rule
(``_partial_axes_of``): ``data`` given to ``shard_tensor`` is the global,
already reduced value; an avg-Partial stores it divided by the axis
degree, so resolving any Partial to Replicate or Shard is a value
identity, and ``reshard`` converts sum <-> avg by the source degree.

``ProcessMesh`` takes its members from the visible cards and refuses a
mesh larger than them, as the reference does; the keyword-only
``devices=`` (a departure, ROADMAP §C) names them, so members may share
a card or the CPU, as ``fleet.init(devices=...)`` allows.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...device import devices as _visible_devices
from ..topology import Mesh

__all__ = ["ProcessMesh", "Shard", "Replicate", "Partial", "Placement", "shard_tensor",
           "dtensor_from_fn", "reshard", "shard_layer", "shard_optimizer",
           "get_mesh", "set_mesh", "to_partition_spec", "sharding_of", "shard_constraint",
           "Engine"]


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = int(dim)

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, o):
        return isinstance(o, Shard) and o.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, o):
        return isinstance(o, Replicate)

    def __hash__(self):
        return hash("replicate")


class Partial(Placement):
    """A pending reduction over its mesh dim (``"sum"`` or ``"avg"``); laid
    out as Replicate, its value by the eager-avg rule (module docstring)."""

    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"


class ProcessMesh:
    """An N-D array of member ids with named dims (reference
    ``process_mesh.py``).  ``mesh`` (ids) or ``shape`` (ids 0..n-1); member
    i is ``devices[i]`` (keyword-only; default the visible cards, and a
    mesh larger than them raises).  ``mesh`` may also be a ``topology.Mesh``
    (a hybrid group's), which is wrapped as it is."""

    def __init__(self, mesh=None, dim_names: Optional[Sequence[str]] = None,
                 shape: Optional[Sequence[int]] = None, *, devices=None):
        if isinstance(mesh, Mesh):
            self._mesh = mesh
            self._dim_names = list(mesh.axis_names)
            self._shape = [mesh.shape[a] for a in mesh.axis_names]
            return
        if mesh is None and shape is not None:
            mesh = np.arange(int(np.prod(shape))).reshape(shape)
        arr = np.asarray(mesh)
        self._shape = list(arr.shape)
        self._dim_names = list(dim_names) if dim_names is not None else \
            [f"d{i}" for i in range(arr.ndim)]
        devs = [torch.device(d) for d in (devices if devices is not None
                                          else _visible_devices())]
        if arr.size > len(devs):
            raise ValueError(f"mesh needs {arr.size} devices; {len(devs)} visible")
        members = np.empty(arr.size, dtype=object)
        members[:] = [devs[i] for i in arr.reshape(-1)]
        self._mesh = Mesh(members.reshape(arr.shape), self._dim_names)

    @property
    def mesh(self) -> Mesh:
        """The members as a ``topology.Mesh``."""
        return self._mesh

    @property
    def shape(self) -> List[int]:
        return list(self._shape)

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def process_ids(self) -> List[int]:
        return list(range(int(np.prod(self._shape))))

    @property
    def device(self) -> torch.device:
        """Where a distributed tensor's global value lies: the first member."""
        return self._mesh.devices.flat[0]

    def get_dim_size(self, name: str) -> int:
        return self._shape[self._dim_names.index(name)]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh) and self._shape == other._shape and
                self._dim_names == other._dim_names)

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dim_names={self._dim_names})"


_global_mesh: Optional[ProcessMesh] = None


def set_mesh(mesh) -> None:
    global _global_mesh
    _global_mesh = mesh if isinstance(mesh, ProcessMesh) else ProcessMesh(mesh)


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh


def to_partition_spec(placements: Sequence[Placement], mesh: ProcessMesh,
                      ndim: Optional[int] = None) -> tuple:
    """``[Shard(0), Replicate(), ...]`` (one per MESH dim) → the spec tuple
    over tensor dims that ``DistributedTrainStep`` keeps (an entry a dim:
    None, an axis name, or a tuple of names; the reference's
    ``PartitionSpec``)."""
    entries: Dict[int, List[str]] = {}
    for axis_name, placement in zip(mesh.dim_names, placements):
        if isinstance(placement, Shard):
            entries.setdefault(placement.dim, []).append(axis_name)
    if not entries:
        return ()
    max_dim = (ndim - 1) if ndim is not None else max(entries)
    spec = []
    for d in range(max_dim + 1):
        names = entries.get(d, [])
        spec.append(None if not names else names[0] if len(names) == 1 else tuple(names))
    return tuple(spec)


def _partial_axes_of(placements: Sequence[Placement], mesh: ProcessMesh) -> dict:
    """mesh dim name → (reduce_type, the dim's degree) for every Partial
    placement; the degree is the mesh's the tensor was placed on."""
    out = {}
    for axis, pl in zip(mesh.dim_names, placements):
        if isinstance(pl, Partial):
            if pl.reduce_type not in ("sum", "avg"):
                raise NotImplementedError(
                    f"Partial reduce_type {pl.reduce_type!r} (sum/avg supported)")
            out[axis] = (pl.reduce_type, mesh.get_dim_size(axis))
    return out


class DistAttr(NamedTuple):
    """A distributed tensor's tag: its mesh, placements, pending Partial
    axes and spec over its dims."""
    process_mesh: ProcessMesh
    placements: tuple
    partial_axes: dict
    spec: tuple


class Sharding(NamedTuple):
    """What ``sharding_of`` returns (the reference's ``NamedSharding``)."""
    mesh: ProcessMesh
    spec: tuple


def _placed(value: torch.Tensor, like, mesh: ProcessMesh, placements, partial_axes,
            stop_gradient: Optional[bool]) -> torch.Tensor:
    """``value`` on the mesh's first member as a new tensor (a Parameter
    when ``like`` is one, keeping its attributes), tagged."""
    value = value.detach().to(mesh.device)
    grad = like.requires_grad if stop_gradient is None else not stop_gradient
    if isinstance(like, nn.Parameter):
        out = nn.Parameter(value, requires_grad=grad)
        for k, v in vars(like).items():
            if k != "_dist_attr":
                setattr(out, k, v)
    else:
        out = value.requires_grad_(grad) if value.is_floating_point() else value
    spec = to_partition_spec(placements, mesh, ndim=value.dim())
    out._dist_attr = DistAttr(mesh, tuple(placements), dict(partial_axes),
                              spec + (None,) * (value.dim() - len(spec)))
    # the tag DistributedTrainStep reads: (the mesh's axes and sizes, spec)
    out._dist_spec = (tuple(zip(mesh.dim_names, mesh.shape)), out._dist_attr.spec)
    return out


def shard_tensor(data, mesh: ProcessMesh, placements: Sequence[Placement],
                 dtype=None, place=None, stop_gradient: Optional[bool] = None) -> torch.Tensor:
    """``data`` distributed over ``mesh`` (reference api.py:126): the global
    value on the mesh's first member, tagged, a new tensor (sharing
    ``data``'s storage when it lies there already and needs no change).  A
    Partial placement takes ``data`` as the reduced value (the reference's
    ``r_to_p``): a sum is the value itself, an avg the value over the
    dim's degree."""
    t = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.asarray(data))
    if dtype is not None:
        t = t.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    partial_axes = _partial_axes_of(placements, mesh)
    value = t.detach()
    for rt, degree in partial_axes.values():
        if rt == "avg":
            value = value / degree
    return _placed(value, t, mesh, placements, partial_axes, stop_gradient)


def dtensor_from_fn(fn: Callable, mesh: ProcessMesh, placements: Sequence[Placement],
                    *args, **kwargs) -> torch.Tensor:
    """``fn(*args, **kwargs)`` distributed over ``mesh`` (reference
    api.py:270)."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements, stop_gradient=False)


def reshard(x: torch.Tensor, mesh: ProcessMesh, placements: Sequence[Placement]) -> torch.Tensor:
    """``x`` placed anew (reference api.py:304).  Partial transitions by
    the eager-avg rule: resolving a pending dim is a value identity,
    entering an avg-Partial divides by the dim's degree, a pending sum
    becoming avg divides by the source degree and avg becoming sum
    multiplies by it."""
    attr = getattr(x, "_dist_attr", None)
    src_partial = dict(attr.partial_axes) if attr is not None else {}
    dst_partial = _partial_axes_of(placements, mesh)
    value = x.detach()
    for axis, (dst_rt, dst_deg) in list(dst_partial.items()):
        src_rt, src_deg = src_partial.get(axis, (None, None))
        if src_rt is None:
            if dst_rt == "avg":
                value = value / dst_deg
        else:
            dst_partial[axis] = (dst_rt, src_deg)
            if (src_rt, dst_rt) == ("sum", "avg"):
                value = value / src_deg
            elif (src_rt, dst_rt) == ("avg", "sum"):
                value = value * src_deg
    return _placed(value, x, mesh, placements, dst_partial, None)


def shard_constraint(x: torch.Tensor, mesh: ProcessMesh,
                     placements: Sequence[Placement]) -> torch.Tensor:
    """``reshard`` (the reference constrains a traced value inside jit; the
    port runs eagerly)."""
    return reshard(x, mesh, placements)


def sharding_of(x: torch.Tensor) -> Optional[Sharding]:
    """``x``'s mesh and spec, or None for a tensor never placed."""
    attr = getattr(x, "_dist_attr", None)
    return None if attr is None else Sharding(attr.process_mesh, attr.spec)


def shard_layer(layer: nn.Module, process_mesh: ProcessMesh,
                shard_fn: Optional[Callable] = None,
                input_fn: Optional[Callable] = None,
                output_fn: Optional[Callable] = None) -> nn.Module:
    """Distribute ``layer``'s parameters (reference api.py:403):
    ``shard_fn(name, sublayer, mesh)`` for every sublayer (the layer
    included), which places its parameters with ``shard_tensor`` and puts
    them back in ``sublayer._parameters``; by default every parameter is
    replicated.  ``input_fn(inputs, mesh)`` and ``output_fn(outputs, mesh)``
    become forward hooks.  Build the optimizer afterwards: the parameters
    are new objects."""

    def default_shard_fn(name, sublayer, mesh):
        for pname, p in list(sublayer._parameters.items()):
            if p is not None:
                sublayer._parameters[pname] = shard_tensor(
                    p, mesh, [Replicate() for _ in mesh.dim_names])

    fn = shard_fn or default_shard_fn
    for name, sub in layer.named_modules():
        fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(lambda mod, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(lambda mod, inp, out: output_fn(out, process_mesh))
    return layer


def shard_optimizer(optimizer, shard_fn: Optional[Callable] = None):
    """Distribute the optimizer's states (reference api.py:736): they take
    their parameters' placements by default (``DistributedTrainStep`` lays
    them out by the parameters' specs); ``shard_fn(slot, param, state)``
    replaces each state tensor."""
    if shard_fn is not None:
        for p in optimizer._parameter_list:
            st = optimizer._state_for(p)
            for k, v in list(st.items()):
                if isinstance(v, torch.Tensor):
                    st[k] = shard_fn(k, p, v)
    return optimizer


from .engine_api import Engine  # noqa: E402,F401
