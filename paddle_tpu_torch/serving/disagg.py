"""Tensor-parallel decode's mesh, parameter and arena placement (port of the
reference's ``serving/disagg.py``, its TP part: ``decode_mesh``,
``shard_llama_params``, ``arena_partition_spec``, ``shard_arenas``).

The reference commits a ``ServingEngine``'s parameters and KV arenas onto a
1-D ``"model"`` mesh with ``NamedSharding`` and lets GSPMD run the Megatron
decomposition.  The port's engine drives the members from one process
(``ServingEngine(tp=n)``), so placement here is explicit:

- a member is a position on the ``model`` axis; members go round-robin over
  the devices given (default: the visible devices of the default type), so
  several may share one card, as the context-parallel ring's do;
- a Megatron-split parameter (paddle ``[in, out]`` layout: q/k/v/gate/up
  split their out dim, o/down their in dim) keeps its global tensor and
  gains ``shards``, one a member: a view of the parameter for a member on
  the parameter's device (no memory), a resident copy on any other;
  ``split_axis`` and ``is_distributed`` mark it, as in the reference.
  Everything else (embeddings, norms, the LM head, the rope tables) stays
  whole on the model's device, where the engine computes it once;
- a KV arena is split along its kv-head axis into one contiguous resident
  tensor a member.

The depot frames, ``PrefillWorker``, ``DisaggCoordinator`` and
``take_prefilled`` (disaggregated prefill) wait for ROADMAP A8.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..device import devices as _visible_devices
from ..distributed.topology import Mesh, _HYBRID_AXES, _indexed

__all__ = ["decode_mesh", "shard_llama_params", "arena_partition_spec", "shard_arenas"]

# paddle Linear weight layout is [in, out]: column-parallel projections
# (q/k/v, gate/up) split the OUT dim, row-parallel ones (o, down) the IN
# dim; matching is on the dotted parameter name's suffix
_COL_SUFFIXES = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                 "gate_proj.weight", "up_proj.weight")
_ROW_SUFFIXES = ("o_proj.weight", "down_proj.weight")


def decode_mesh(tp: int, *, devices=None) -> Mesh:
    """A mesh whose ``model`` axis has ``tp`` members, member i on
    ``devices[i mod len(devices)]`` (default: the visible devices of the
    default type).  The reference needs ``tp`` devices and raises with
    fewer; one process drives the port's members, so they wrap."""
    devs = [_indexed(d) for d in (devices if devices is not None else _visible_devices())]
    if tp < 1 or not devs:
        raise ValueError(f"decode_mesh: tp={tp} over {len(devs)} device(s)")
    arr = np.empty(tp, dtype=object)
    arr[:] = [devs[i % len(devs)] for i in range(tp)]
    return Mesh(arr.reshape(1, 1, 1, 1, tp), _HYBRID_AXES)


def shard_llama_params(model, mesh) -> int:
    """Give every Megatron-split parameter of a llama-family ``model`` its
    member shards over ``mesh``'s ``model`` axis (``p.shards``, with
    ``split_axis`` and ``is_distributed``; module docstring).  Returns the
    number of split parameters.  In place, as the reference's: shards are
    views of the parameters, and a later call with another mesh replaces
    them, so an engine keeps the shards it was built with."""
    members = mesh.axis_devices("model")
    n = len(members)
    sharded = 0
    for name, p in model.named_parameters():
        if name.endswith(_COL_SUFFIXES):
            axis = 1
        elif name.endswith(_ROW_SUFFIXES):
            axis = 0
        else:
            continue
        if p.shape[axis] % n:
            raise ValueError(f"{name}: dim {axis} of {tuple(p.shape)} does not "
                             f"split over {n} members")
        w = p.shape[axis] // n
        p.shards = [p.detach().narrow(axis, j * w, w).to(dev)
                    for j, dev in enumerate(members)]
        p.split_axis, p.is_distributed = axis, True
        sharded += 1
    return sharded


def arena_partition_spec(key: str):
    """The axes of one arena plane, with the kv-head axis named
    ``"model"``: k/v pages ``[pages, page_tokens, kv_heads, head_dim]``,
    int8 scale planes ``[pages, page_tokens, kv_heads]`` (the reference's
    ``PartitionSpec`` as a tuple)."""
    if key in ("ks", "vs"):
        return (None, None, "model")
    return (None, None, "model", None)


def shard_arenas(arenas: Dict[str, list], mesh) -> List[Dict[str, list]]:
    """Split every arena of ``arenas`` ({plane: [one tensor a layer]})
    along its kv-head axis over ``mesh``'s ``model`` members: one dict a
    member, each plane's tensors contiguous and resident on the member's
    device."""
    members = mesh.axis_devices("model")
    n = len(members)
    out = [{} for _ in members]
    for key, arrs in arenas.items():
        axis = arena_partition_spec(key).index("model")
        for j, dev in enumerate(members):
            parts = []
            for a in arrs:
                w = a.shape[axis] // n
                parts.append(a.narrow(axis, j * w, w).to(dev).contiguous())
            out[j][key] = parts
    return out
