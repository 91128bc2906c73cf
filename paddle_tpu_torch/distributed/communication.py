"""The eager collective API (port of the reference's
``distributed/communication.py``; reference surface:
``python/paddle/distributed/communication/`` and ``process_group.h:47``).

The convention is the reference's: a "per-rank local tensor" is one slice
along the LEADING axis of a stacked tensor, and a group is a set of mesh
axes (:class:`~.topology.CommGroup`)::

    x = dist.scatter_stack(big, group)        # [g·m, ...]: member i's rows
    dist.all_reduce(x)                        # every slice := sum of slices
    ys = dist.all_gather(x, group)            # every slice sees the stack

Two modes, chosen by the group's mesh:

- **Single controller** (a mesh from ``build_mesh``): one process drives
  every member, so a stacked tensor is one tensor holding every member's
  rows, on the device of the mesh's first member (members may share it:
  four members on one card, or on the CPU).  A collective is tensor
  arithmetic over its [g, m, ...] blocks there, with the reference's
  results for the same numpy stack.  Members on several cards still
  compute on the first one: spreading a stack over the cards waits for
  ROADMAP A6d (a multi-card machine).
- **Multi-process** (the mesh of ``init_parallel_env``, one member a
  process): a stacked tensor is this process's own rows, on its device,
  and each call is one ``torch.distributed`` collective over the group's
  processes: NCCL for CUDA tensors, gloo for CPU ones, and a tensor on the
  other kind of device raises.  Results are this process's rows of the
  single-controller result, except the list form of ``all_gather``, which
  gives one tensor per rank as paddle does.

P2P is the reference's SPMD pairing: ``send`` stages a snapshot of the
value for a ring offset, and the matching ``recv`` moves it (one ring
``ppermute``); a ``recv`` with nothing staged raises.

Departures: ``ReduceOp.PROD`` is the product (the reference's
exp(Σ log x) is NaN for x ≤ 0); ``AVG`` of an integer tensor raises, since
its mean cannot be written back in place; ``reduce_scatter`` honours ``op``
(the reference always sums).  Collectives are not differentiable.  Each
executed collective is recorded in the telemetry layer
(``telemetry.record_collective``: kind, payload bytes, group, the analytic
link cost), as in the reference.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import devices as _visible_devices
from .topology import (CommGroup, build_mesh, get_hybrid_communicate_group,
                       process_mesh_coords, process_rank)

__all__ = ["ReduceOp", "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "broadcast", "reduce", "scatter", "barrier", "new_group", "get_group",
           "scatter_stack", "ppermute", "wait", "stream",
           "coalesced_reduce_scatter",
           "send", "recv", "isend", "irecv", "P2POp", "batch_isend_irecv"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN",
              ReduceOp.PROD: "PRODUCT", ReduceOp.AVG: "AVG"}

_default_group: Optional[CommGroup] = None
_groups: dict = {}
_next_group_id = 1


def _world_mesh():
    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.mesh
    global _default_group
    if _default_group is None:
        mesh = build_mesh(dp=len(_visible_devices()))
        _default_group = CommGroup(mesh, ("data",), group_id=0)
    return _default_group.mesh


def _resolve_group(group: Optional[CommGroup]) -> CommGroup:
    if group is not None:
        return group
    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.get_global_group()
    _world_mesh()
    return _default_group


def new_group(ranks: Optional[List[int]] = None, backend: Optional[str] = None,
              timeout=None, axes: Optional[Sequence[str]] = None) -> CommGroup:
    """A logical group: a set of MESH AXES (``axes=...``).  Arbitrary rank
    lists (reference `collective.py:180`) are taken only when they span the
    whole current mesh, as in the reference."""
    global _next_group_id
    mesh = _world_mesh()
    if axes is not None:
        g = CommGroup(mesh, tuple(axes), _next_group_id)
    elif ranks is None or len(ranks) == sum(mesh.shape.values()) - len(mesh.shape) + 1 \
            or len(ranks) == mesh.size:
        g = CommGroup(mesh, tuple(mesh.axis_names), _next_group_id)
    else:
        raise ValueError(
            "arbitrary rank-list groups are not mesh-expressible; pass axes=('data',) "
            "etc. to select mesh axes (groups are mesh axes, see module docstring)")
    _next_group_id += 1
    _groups[g.id] = g
    return g


def get_group(gid: int) -> Optional[CommGroup]:
    return _groups.get(gid)


# ---------------------------------------------------------------------------
# the two modes' plumbing
# ---------------------------------------------------------------------------

def _multi(g: CommGroup) -> bool:
    """Whether ``g``'s members are processes (a mesh of init_parallel_env)."""
    return g.mesh.procs is not None


# (mesh, axes) → (torch process group, global rank of each group member)
_process_groups: Dict[tuple, Tuple[object, List[int]]] = {}


def _process_group(g: CommGroup) -> Tuple[object, List[int]]:
    """The torch process group of this process's instance of ``g`` and the
    global ranks of its members in member order.  Every process creates
    every instance, in the same order, as ``torch.distributed.new_group``
    requires; the whole world is the default group."""
    key = (g.mesh, g.axes)
    hit = _process_groups.get(key)
    if hit is None:
        names = g.mesh.axis_names
        order = [names.index(a) for a in g.axes]
        rest = [i for i in range(len(names)) if i not in order]
        rows = np.transpose(g.mesh.procs, rest + order).reshape(-1, g.nranks)
        me, world = process_rank(), dist.get_world_size()
        for row in rows:
            ranks = [int(r) for r in row]
            pg = dist.group.WORLD if ranks == list(range(world)) else dist.new_group(ranks)
            if me in ranks:
                hit = (pg, ranks)
        _process_groups[key] = hit
    return hit


def _own_device(g: CommGroup) -> torch.device:
    coords = process_mesh_coords(g.mesh)
    return g.mesh.devices[tuple(coords[a] for a in g.mesh.axis_names)]


def _home_device(g: CommGroup) -> torch.device:
    return _own_device(g) if _multi(g) else g.mesh.devices.flat[0]


def _check_local(x: torch.Tensor) -> None:
    """A multi-process collective's tensor must lie where its backend
    works: NCCL on the card, gloo on the CPU.  Nothing is moved."""
    backend = dist.get_backend()
    want = "cuda" if backend == "nccl" else "cpu"
    if x.device.type != want:
        raise RuntimeError(f"a {backend} collective got a {x.device.type} tensor; "
                           f"its tensors lie on the {want}")


def _torch_op(op: str):
    """(torch reduce op, divide by the group size after) for ``op``: gloo
    has no AVG of its own, so it sums and divides."""
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    if op == ReduceOp.AVG and dist.get_backend() != "nccl":
        return dist.ReduceOp.SUM, True
    return getattr(dist.ReduceOp, _TORCH_OPS[op]), False


def _check_avg(x: torch.Tensor, op: str) -> None:
    if op == ReduceOp.AVG and not (x.is_floating_point() or x.is_complex()):
        raise TypeError(f"ReduceOp.AVG needs a floating tensor, got {x.dtype}")


def _blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """The stacked tensor as [n, m, ...], member i's rows at [i]: a view of
    ``x`` (splitting one axis always is), so writing it writes ``x``."""
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"a stacked tensor's dim 0 must be a multiple of the group "
                         f"size {n}, got shape {tuple(x.shape)}")
    return x.unflatten(0, (n, x.shape[0] // n))


def _reduce(blocks: torch.Tensor, op: str) -> torch.Tensor:
    if op == ReduceOp.SUM:
        return blocks.sum(0)
    if op == ReduceOp.AVG:
        return blocks.sum(0) / blocks.shape[0]
    if op == ReduceOp.MAX:
        return blocks.amax(0)
    if op == ReduceOp.MIN:
        return blocks.amin(0)
    if op == ReduceOp.PROD:
        return blocks.prod(0)
    raise ValueError(f"unsupported reduce op {op}")


def _mp_all_reduce(x: torch.Tensor, op: str, g: CommGroup) -> None:
    """One torch.distributed all_reduce of ``x`` over ``g``, in place."""
    _check_local(x)
    pg, _ = _process_group(g)
    top, divide = _torch_op(op)
    dist.all_reduce(x, op=top, group=pg)
    if divide:
        x.div_(g.nranks)


def _mp_reduce_scatter(x: torch.Tensor, op: str, g: CommGroup) -> torch.Tensor:
    _check_local(x)
    pg, _ = _process_group(g)
    top, divide = _torch_op(op)
    out = torch.empty((x.shape[0] // g.nranks, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    rs(out, x.contiguous(), op=top, group=pg)
    return out.div_(g.nranks) if divide else out


def _mp_ppermute(x: torch.Tensor, perm, g: CommGroup) -> torch.Tensor:
    _check_local(x)
    pg, ranks = _process_group(g)
    me, x = g.rank, x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[d], pg))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _telemetry_record(kind: str, tensor: torch.Tensor, g: CommGroup) -> None:
    """Report one executed collective to the telemetry layer (payload
    bytes, the group's axes and size), after it ran: a collective that
    raises does not count.  Never allowed to break the collective."""
    try:
        from .. import telemetry

        telemetry.record_collective(kind, nbytes=tensor.numel() * tensor.element_size(),
                                    axes=g.axes, group_size=g.nranks)
    except Exception:
        pass


@torch.no_grad()
def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM,
               group: Optional[CommGroup] = None, sync_op: bool = True) -> torch.Tensor:
    """Every group slice := the reduction over the slices.  In place on
    ``tensor`` (paddle semantics), which is also returned."""
    g = _resolve_group(group)
    _check_avg(tensor, op)
    if _multi(g):
        _mp_all_reduce(tensor, op, g)
    else:
        blocks = _blocks(tensor, g.nranks)
        blocks.copy_(_reduce(blocks, op).unsqueeze(0))
    _telemetry_record("all_reduce", tensor, g)
    return tensor


@torch.no_grad()
def all_gather(tensor_or_list, tensor: Optional[torch.Tensor] = None,
               group: Optional[CommGroup] = None, sync_op: bool = True):
    """paddle signature: ``all_gather(out_list, x, group)``; also callable
    functionally: ``stacked = all_gather(x, group=g)``, every slice of
    which holds the whole stack ([g·g·m, ...] on a single controller, the
    [g·m, ...] stack on each process)."""
    if isinstance(tensor_or_list, list):
        out_list, x = tensor_or_list, tensor
    else:
        out_list, x = None, tensor_or_list
        if tensor is not None and group is None and isinstance(tensor, CommGroup):
            group = tensor
    g = _resolve_group(group)
    n = g.nranks
    if _multi(g):
        _check_local(x)
        pg, _ = _process_group(g)
        x = x.contiguous()
        gathered = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                               device=x.device)
        ag = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        ag(gathered, x, group=pg)
        parts = list(gathered.chunk(n))          # one per rank, as paddle's
    else:
        _blocks(x, n)
        gathered = x.repeat(n, *([1] * (x.dim() - 1)))
        parts = [x.clone() for _ in range(n)]    # the reference's n views of the stack
    _telemetry_record("all_gather", x, g)
    if out_list is not None:
        out_list.clear()
        out_list.extend(parts)
        return out_list
    return gathered


@torch.no_grad()
def reduce_scatter(tensor: torch.Tensor, tensor_list=None, op: str = ReduceOp.SUM,
                   group: Optional[CommGroup] = None, sync_op: bool = True) -> torch.Tensor:
    """Each member's rows [g·k, ...] reduced over the members, member j
    keeping block j: the stacked result is [m, ...] for a [g·m, ...] stack.
    With ``tensor_list`` (one input per rank), their concatenation is the
    input and the result is also written into ``tensor``."""
    x = tensor if tensor_list is None else torch.cat(list(tensor_list))
    g = _resolve_group(group)
    _check_avg(x, op)
    if _multi(g):
        if x.dim() == 0 or x.shape[0] % g.nranks:
            raise ValueError(f"reduce_scatter needs dim 0 divisible by the group size "
                             f"{g.nranks}, got shape {tuple(x.shape)}")
        out = _mp_reduce_scatter(x, op, g)
    else:
        out = _reduce(_blocks(x, g.nranks), op)
    _telemetry_record("reduce_scatter", x, g)
    if tensor_list is not None:
        tensor.copy_(out.reshape(tensor.shape))
    return out


def _bucket_bytes(override: Optional[float]) -> int:
    """The bucket payload target in bytes: ``override`` wins, else
    ``PADDLE_TPU_BUCKET_MB`` (MB, default 25); <= 0 puts everything of one
    dtype in one bucket (the reference's ``grad_bucket_bytes``)."""
    if override is not None:
        return max(0, int(override))
    try:
        mb = float(os.environ.get("PADDLE_TPU_BUCKET_MB", 25.0))
    except ValueError:
        mb = 25.0
    return max(0, int(mb * 2 ** 20))


def _plan_buckets(sizes: Sequence[int], keys: Sequence, target: int) -> List[List[int]]:
    """Indices in reverse order cut into buckets of at most ``target``
    bytes (a lone larger tensor forms its own), never mixing ``keys`` (the
    reference's ``GradientBucketer`` plan with ``reverse=True``)."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes, cur_key = 0, None
    for i in reversed(range(len(sizes))):
        if cur and (cur_key != keys[i] or (target > 0 and cur_bytes + sizes[i] > target)):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += sizes[i]
        cur_key = keys[i]
    if cur:
        buckets.append(cur)
    return buckets


@torch.no_grad()
def coalesced_reduce_scatter(tensor_list, group: Optional[CommGroup] = None,
                             bucket_bytes: Optional[int] = None) -> List[torch.Tensor]:
    """``[reduce_scatter(t) for t in tensor_list]`` (sums), as ONE
    collective per size-targeted bucket (``bucket_bytes``, else
    ``PADDLE_TPU_BUCKET_MB``), planned in reverse order and never mixing
    dtypes.  On a single controller each output is the summed [m, ...] of
    a [g·m, ...] input; across processes, this process's rows of it (each
    local dim 0 divisible by the group size)."""
    g = _resolve_group(group)
    n = g.nranks
    vals = [torch.as_tensor(t) for t in tensor_list]
    for v in vals:
        if v.dim() < 1 or v.shape[0] % n:
            raise ValueError(
                f"coalesced_reduce_scatter needs dim0 divisible by the "
                f"group size {n}, got shape {tuple(v.shape)}")
    sizes = [v.numel() * v.element_size() for v in vals]
    out: List[Optional[torch.Tensor]] = [None] * len(vals)
    for b in _plan_buckets(sizes, [v.dtype for v in vals], _bucket_bytes(bucket_bytes)):
        # [n, L]: row j holds every member tensor's j-th block, flattened
        flat = torch.cat([vals[i].reshape(n, -1) for i in b], dim=1)
        if _multi(g):
            summed = _mp_reduce_scatter(flat.reshape(-1), ReduceOp.SUM, g)
        else:
            summed = flat.sum(0)
        off = 0
        for i in b:
            shape = (vals[i].shape[0] // n, *vals[i].shape[1:])
            cnt = int(np.prod(shape))
            out[i] = summed[off:off + cnt].reshape(shape)
            off += cnt
    return out


@torch.no_grad()
def _all_to_all(x: torch.Tensor, g: CommGroup) -> torch.Tensor:
    n = g.nranks
    if _multi(g):
        _check_local(x)
        if x.dim() == 0 or x.shape[0] % n:
            raise ValueError(f"all_to_all needs dim 0 divisible by the group size {n}, "
                             f"got shape {tuple(x.shape)}")
        pg, _ = _process_group(g)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=pg)
        return out
    blocks = _blocks(x, n)
    if blocks.shape[1] % n:
        raise ValueError(f"all_to_all needs each member's rows divisible by the group "
                         f"size {n}, got shape {tuple(x.shape)}")
    # [source, destination, k, ...] → [destination, source, k, ...]
    split = blocks.reshape(n, n, blocks.shape[1] // n, *x.shape[1:])
    return split.transpose(0, 1).reshape(x.shape)


def all_to_all(out_tensor_list, in_tensor_list=None, group: Optional[CommGroup] = None,
               sync_op: bool = True):
    """Functional form: ``y = all_to_all(x, group=g)``, x's rows on each
    member split into one block per destination; member j receives every
    member's block j, in member order."""
    g = _resolve_group(group)
    x = out_tensor_list if isinstance(out_tensor_list, torch.Tensor) \
        else torch.cat(list(in_tensor_list))
    y = _all_to_all(x, g)
    _telemetry_record("all_to_all", x, g)
    if isinstance(out_tensor_list, torch.Tensor):
        return y
    out_tensor_list.clear()
    out_tensor_list.extend(y.chunk(len(in_tensor_list)))
    return out_tensor_list


@torch.no_grad()
def broadcast(tensor: torch.Tensor, src: int = 0, group: Optional[CommGroup] = None,
              sync_op: bool = True) -> torch.Tensor:
    """Every slice := member ``src``'s slice (``src`` a member index of the
    group), in place."""
    g = _resolve_group(group)
    if _multi(g):
        _check_local(tensor)
        pg, ranks = _process_group(g)
        dist.broadcast(tensor, src=ranks[src], group=pg)
    else:
        blocks = _blocks(tensor, g.nranks)
        blocks.copy_(blocks[src].clone().unsqueeze(0))
    _telemetry_record("broadcast", tensor, g)
    return tensor


def reduce(tensor: torch.Tensor, dst: int = 0, op: str = ReduceOp.SUM,
           group: Optional[CommGroup] = None, sync_op: bool = True) -> torch.Tensor:
    """A reduce to ``dst`` is an all_reduce, as in the reference: every
    slice receives the value."""
    return all_reduce(tensor, op, group)


@torch.no_grad()
def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group: Optional[CommGroup] = None, sync_op: bool = True) -> torch.Tensor:
    """``scatter_stack`` of ``concat(tensor_list)`` (or of ``tensor``).  On
    a single controller the stack is whole where it is given; across
    processes it is first broadcast from member ``src``, so only its values
    count."""
    stacked = torch.cat(list(tensor_list)) if tensor_list is not None else tensor
    g = _resolve_group(group)
    if _multi(g):
        stacked = stacked.to(_own_device(g), copy=True).contiguous()
        _check_local(stacked)
        pg, ranks = _process_group(g)
        dist.broadcast(stacked, src=ranks[src], group=pg)
    return scatter_stack(stacked, g)


def scatter_stack(x, group: Optional[CommGroup] = None) -> torch.Tensor:
    """Lay ``x``'s leading axis out over the group (host → per-rank
    slices): a copy of the whole stack on a single controller's first
    member, or this process's rows on its own device."""
    g = _resolve_group(group)
    x = torch.as_tensor(x).detach()
    if _multi(g):
        x = _blocks(x, g.nranks)[g.rank]
    return x.to(_home_device(g), copy=True).contiguous()


@torch.no_grad()
def ppermute(tensor: torch.Tensor, perm, group: Optional[CommGroup] = None) -> torch.Tensor:
    """Collective permute: member d receives member s's slice for each
    ``(s, d)`` of ``perm``; a member that receives nothing gets zeros (as
    ``jax.lax.ppermute``)."""
    g = _resolve_group(group)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if _multi(g):
        out = _mp_ppermute(tensor, perm, g)
    else:
        blocks = _blocks(tensor, g.nranks)
        out = torch.zeros_like(blocks)
        for s, d in perm:
            out[d] = blocks[s]
        out = out.reshape(tensor.shape)
    _telemetry_record("ppermute", tensor, g)
    return out


# ---------------------------------------------------------------------------
# p2p send/recv (reference: `python/paddle/distributed/communication/
# {send,recv,batch_isend_irecv}.py`).
#
# As in the reference, a point-to-point transfer IS a collective permute:
# a send(dst)/recv(src) PAIR lowers to one ``ppermute`` whose permutation
# is the ring offset (dst − src) mod n, applied SPMD-symmetrically (every
# rank r sends its slice to r+offset: the pattern of pipeline p2p,
# `pp_utils/p2p_communication.py:313`).  Both halves of a pair are issued
# by the program; a recv with no matching pending send raises instead of
# deadlocking.
# ---------------------------------------------------------------------------

class _P2PTask:
    """Returned by isend/irecv (the reference returns a distributed task)."""

    def __init__(self, result: Optional[torch.Tensor] = None):
        self._result = result

    def wait(self) -> None:
        if self._result is not None:
            wait(self._result)

    def is_completed(self) -> bool:
        return True


# (mesh, axes, ring_offset) → FIFO of pending send tensors.  Keyed on the
# group's mesh and axes, not its id: every HCG-derived group shares id 0,
# and a group IS its axes for collective purposes.
_pending_sends: dict = {}
_MAX_PENDING_SENDS = 64


def _p2p_key(g: CommGroup, off: int):
    return (g.mesh, g.axes, off)


def clear_pending_p2p() -> None:
    """Drop all staged, un-received sends (e.g. after an aborted step)."""
    _pending_sends.clear()


def send(tensor: torch.Tensor, dst: int = 0, group: Optional[CommGroup] = None,
         sync_op: bool = True) -> _P2PTask:
    """Stage this group's stacked tensor for a ring transfer to ``dst``.
    The data moves when the matching ``recv`` is issued (see section note)."""
    g = _resolve_group(group)
    off = (dst - g.rank) % g.nranks
    queue = _pending_sends.setdefault(_p2p_key(g, off), [])
    if len(queue) >= _MAX_PENDING_SENDS:
        raise RuntimeError(
            f"{_MAX_PENDING_SENDS} sends staged without a matching recv on ring "
            f"offset {off} — likely a leaked send from an aborted step; call "
            "paddle_tpu_torch.distributed.communication.clear_pending_p2p()")
    # snapshot the VALUE: mutating the tensor after send must not change
    # what the matching recv delivers (the reference sends at call time)
    queue.append(tensor.detach().clone())
    return _P2PTask()


def isend(tensor: torch.Tensor, dst: int = 0, group: Optional[CommGroup] = None) -> _P2PTask:
    return send(tensor, dst, group, sync_op=False)


def _ring_transfer(x: torch.Tensor, offset: int, g: CommGroup) -> torch.Tensor:
    n = g.nranks
    return ppermute(x, tuple((r, (r + offset) % n) for r in range(n)), g)


def recv(tensor: Optional[torch.Tensor] = None, src: int = 0,
         group: Optional[CommGroup] = None, sync_op: bool = True) -> _P2PTask:
    """Complete the pending ``send`` whose ring offset matches ``src``→here;
    the result is written into ``tensor`` (paddle's in-place recv buffer)."""
    g = _resolve_group(group)
    off = (g.rank - src) % g.nranks
    queue = _pending_sends.get(_p2p_key(g, off))
    if not queue:
        raise RuntimeError(
            f"recv(src={src}): no matching send pending for ring offset {off}. "
            "p2p is SPMD-symmetric: issue both send() and recv() in the same "
            "program (see communication.py p2p section note)")
    moved = _ring_transfer(queue.pop(0), off, g)
    if tensor is not None:
        with torch.no_grad():
            tensor.copy_(moved)
        return _P2PTask(tensor)
    return _P2PTask(moved)


def irecv(tensor: Optional[torch.Tensor] = None, src: int = 0,
          group: Optional[CommGroup] = None) -> _P2PTask:
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One half of a batched p2p exchange (reference batch_isend_irecv.py:25)."""

    def __init__(self, op, tensor: torch.Tensor, peer: int,
                 group: Optional[CommGroup] = None):
        if op not in (isend, irecv, send, recv):
            raise ValueError("P2POp op must be paddle_tpu_torch.distributed.isend/irecv")
        self.op = isend if op in (isend, send) else irecv
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list) -> list:
    """Fuse a list of P2POps into one ppermute per distinct ring offset
    (reference batch_isend_irecv.py:90 fuses into one NCCL group call).
    Recv buffers are written in place; returns one task per op."""
    if not p2p_op_list:
        return []
    g = _resolve_group(p2p_op_list[0].group)
    for op in p2p_op_list[1:]:
        og = _resolve_group(op.group)
        if og.mesh is not g.mesh or og.axes != g.axes:
            raise ValueError("batch_isend_irecv: all ops must share one group "
                             "(as the reference requires); got axes "
                             f"{g.axes} vs {og.axes}")
    n, rank = g.nranks, g.rank
    sends = {}
    seen_recv_offs = set()
    for op in p2p_op_list:
        if op.op is isend:
            off = (op.peer - rank) % n
            if off in sends:
                raise ValueError(f"duplicate send offset {off} in one batch")
            sends[off] = op.tensor
        else:
            off = (rank - op.peer) % n
            if off in seen_recv_offs:
                raise ValueError(f"duplicate recv offset {off} in one batch: two "
                                 "irecvs would alias one transferred tensor")
            seen_recv_offs.add(off)
    # transfer only in-batch-matched sends; stage the rest for a later recv()
    # (an unbatched send would stage too — data must never be dropped)
    results = {}
    for off, t in sends.items():
        if off in seen_recv_offs:
            results[off] = _ring_transfer(t, off, g)
        else:
            _pending_sends.setdefault(_p2p_key(g, off), []).append(t.detach().clone())
    tasks = []
    for op in p2p_op_list:
        if op.op is isend:
            tasks.append(_P2PTask())
        else:
            off = (rank - op.peer) % n
            if off not in results:
                # a send staged earlier by an unbatched send()
                queue = _pending_sends.get(_p2p_key(g, off))
                if not queue:
                    raise RuntimeError(
                        f"batch_isend_irecv: irecv(peer={op.peer}) has no "
                        f"matching isend at ring offset {off} (in this batch "
                        "or staged earlier)")
                results[off] = _ring_transfer(queue.pop(0), off, g)
            with torch.no_grad():
                op.tensor.copy_(results[off])
            tasks.append(_P2PTask(op.tensor))
    return tasks


def barrier(group: Optional[CommGroup] = None) -> None:
    """An all_reduce of zeros over the group, waited for."""
    g = _resolve_group(group)
    wait(all_reduce(scatter_stack(torch.zeros(g.nranks), g), group=g))


def wait(tensor: torch.Tensor, group=None, use_calc_stream: bool = True) -> None:
    """Block until the work queued on ``tensor``'s card is done (nothing to
    wait for on the CPU)."""
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)


class stream:
    """Parity namespace for paddle.distributed.stream.* (the calls above
    already run on the current stream)."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    all_to_all = staticmethod(all_to_all)
    broadcast = staticmethod(broadcast)
