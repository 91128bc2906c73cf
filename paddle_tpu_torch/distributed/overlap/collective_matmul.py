"""Ring-decomposed collective matmul (port of the reference's
``distributed/overlap/collective_matmul.py``; Wang et al., "Overlapping
Communication with Computation in Tensor-Parallel Matmuls").

A tensor-parallel layer's all-gather (column-parallel input) or
reduce-scatter (row-parallel output) becomes p - 1 ring steps over the
``model`` axis, each beside a partial matmul on the chunk in hand, so the
transfer can hide under the matmul.  Four primitives, each a
``torch.autograd.Function`` whose backward is the MIRRORED ring, as the
reference's ``custom_vjp`` is, not what autograd would derive:

- :func:`all_gather_matmul`: ``gather(X) @ W`` (column-parallel); backward
  dX by the matmul-reduce-scatter ring, dW by an X-circulating ring;
- :func:`matmul_reduce_scatter`: ``reduce_scatter(X @ W)`` (row-parallel);
  backward dX by the gather-matmul ring, dW by a grad-circulating ring;
- :func:`all_gather_matmul_seq` / :func:`matmul_reduce_scatter_seq`: the
  same rings one rank up, on [b, s, K] tensors whose sequence is split over
  the ring (sequence parallelism).

The layouts are the reference's: rows of X over (the sized batch axes of
``data``, ``sharding``, ``sep``, then ``model``), W's columns (rows for the
row form) over ``model``.  Ring step i of member d holds the chunk that
started at member (d + i) mod p; the ring moves chunks one member back
(d receives from d + 1).  The partial products are plain ``torch.matmul``
calls (the reference leaves them to XLA); no kernel is written for them.

Two modes, as ``distributed.topology`` has them:

- **Single controller**: the arguments and result are GLOBAL tensors;
  each batch-axis group's ring runs its p members in turn, a member's
  blocks on the member's device (moved by ``.to()``, so the ring's
  rotation is index arithmetic when the members share a card).  The
  weight gradient sums the batch groups' partials, as the reference's
  ``psum`` over the batch axes does.
- **Multi-process** (``Mesh.procs``): the arguments and result are this
  process's blocks in the same layouts; each ring step's transfer is a
  ``batch_isend_irecv`` to the ring neighbours over the model group,
  started before the step's partial matmul and waited for after it.  The
  batch axes are left to the data-parallel gradient sync.

The gates (:func:`should_decompose`, :func:`should_decompose_seq`) are the
reference's: ``PADDLE_TPU_TP_OVERLAP`` (on unless "0" or "false"), a model
degree of 2 or more, ``PADDLE_TPU_TP_OVERLAP_MIN_ROWS`` ring-chunk rows a
member (default 256), divisible rows and a pipe degree of 1.  The
reference also gates off inside another manual ``shard_map`` region; the
port has no such region.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_gather_matmul", "matmul_reduce_scatter",
           "all_gather_matmul_seq", "matmul_reduce_scatter_seq",
           "should_decompose", "should_decompose_seq",
           "tp_overlap_enabled", "overlap_min_rows", "MODEL_AXIS"]

MODEL_AXIS = "model"
_DEFAULT_MIN_ROWS = 256
_ROW_AXES = ("data", "sharding", "sep")


def tp_overlap_enabled() -> bool:
    """``PADDLE_TPU_TP_OVERLAP``: "0" or "false" turns the ring off; unset
    or anything else leaves it on (it gates itself on the model degree)."""
    return os.environ.get("PADDLE_TPU_TP_OVERLAP", "1") not in ("0", "false")


def overlap_min_rows() -> int:
    """Ring-chunk rows a member below which the fused form is kept
    (``PADDLE_TPU_TP_OVERLAP_MIN_ROWS``)."""
    try:
        return int(os.environ.get("PADDLE_TPU_TP_OVERLAP_MIN_ROWS", _DEFAULT_MIN_ROWS))
    except ValueError:
        return _DEFAULT_MIN_ROWS


def _row_axes(mesh) -> Tuple[str, ...]:
    """The sized batch axes that keep splitting the rows inside a ring; on
    a process mesh, none (a process holds its own rows)."""
    if mesh.procs is not None:
        return ()
    return tuple(a for a in _ROW_AXES if mesh.shape.get(a, 1) > 1)


def should_decompose(x_shape: Sequence[int], mesh, axis: str = MODEL_AXIS) -> bool:
    """Ring or fused form for one layer call, from static shapes."""
    if not tp_overlap_enabled():
        return False
    p = mesh.shape.get(axis, 1)
    if p < 2 or mesh.shape.get("pipe", 1) > 1 or len(x_shape) < 2:
        return False
    rows = math.prod(int(d) for d in x_shape[:-1])
    denom = p * math.prod(mesh.shape[a] for a in _row_axes(mesh))
    if rows <= 0 or rows % denom:
        return False
    return rows // denom >= overlap_min_rows()


def should_decompose_seq(x_shape: Sequence[int], mesh, axis: str = MODEL_AXIS) -> bool:
    """Gate of the sequence-parallel rings: ``x_shape`` is the global
    [..., s, K] activation.  :func:`should_decompose`'s gates, plus the
    sequence divisible by the ring, the leading dims by the batch axes, and
    no ``sep`` degree (context parallelism owns the sequence there)."""
    if len(x_shape) < 3:
        return False
    p = mesh.shape.get(axis, 1)
    if p < 2 or int(x_shape[-2]) % p or mesh.shape.get("sep", 1) > 1:
        return False
    b = math.prod(int(d) for d in x_shape[:-2])
    for a in _row_axes(mesh):
        if b % mesh.shape[a]:
            return False
        b //= mesh.shape[a]
    return should_decompose(x_shape, mesh, axis)


# ---------------------------------------------------------------------------
# the rings: a member's view
# ---------------------------------------------------------------------------

class _MemberRing:
    """The p members of one ring driven from this process: ``idx`` their
    positions, a block list holds one tensor a member; a rotation is index
    arithmetic, with ``.to()`` onto the receiving member's device."""

    def __init__(self, devices: List[torch.device]):
        self.p = len(devices)
        self.idx = list(range(self.p))
        self.devices = devices

    def start(self, blocks: List[torch.Tensor]):
        return [blocks[(d + 1) % self.p].to(self.devices[d]) for d in self.idx]

    def finish(self, handle):
        return handle


class _ProcessRing:
    """This process's place on a ring across processes: its block goes to
    member d - 1 and member d + 1's comes in, by ``batch_isend_irecv`` over
    the model group; ``start`` issues the pair, ``finish`` waits."""

    def __init__(self, mesh, axis: str):
        from ..communication import _process_group
        from ..topology import CommGroup, process_mesh_coords

        group = CommGroup(mesh, (axis,))
        self.pg, self.ranks = _process_group(group)
        self.p = group.nranks
        self.idx = [process_mesh_coords(mesh)[axis]]

    def start(self, blocks: List[torch.Tensor]):
        (t,) = blocks
        t = t.contiguous()
        buf = torch.empty_like(t)
        d = self.idx[0]
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, self.ranks[(d - 1) % self.p], group=self.pg),
            dist.P2POp(dist.irecv, buf, self.ranks[(d + 1) % self.p], group=self.pg)])
        return reqs, buf, t

    def finish(self, handle):
        reqs, buf, _ = handle
        for r in reqs:
            r.wait()
        return [buf]


def _rows(t: torch.Tensor, dim: int, blk: int, m: int) -> torch.Tensor:
    return t.narrow(dim, blk * m, m)


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _ag_mm(ring, xs, ws, dim):
    """gather(X) @ W: xs[k] [.., m, K] member k's chunk (``dim`` the ring's),
    ws[k] [K, n] -> [.., p*m, n], all chunks against member k's columns."""
    p, m = ring.p, xs[0].shape[dim]
    outs = []
    for x, w in zip(xs, ws):
        shape = list(x.shape)
        shape[dim], shape[-1] = p * m, w.shape[-1]
        outs.append(torch.empty(shape, dtype=torch.result_type(x, w), device=w.device))
    chunks = xs
    for i in range(p):
        nxt = ring.start(chunks) if i != p - 1 else None
        for c, w, o, d in zip(chunks, ws, outs, ring.idx):
            _rows(o, dim, (d + i) % p, m).copy_(torch.matmul(c, w))
        if nxt is not None:
            chunks = ring.finish(nxt)
    return outs


def _mm_rs(ring, as_, bs, dim):
    """reduce_scatter(A @ B): as_[k] [.., M, j], bs[k] [j, n] -> [.., M/p, n],
    member k's row block summed: at step i a member adds its partial for
    block (d + i + 1) mod p to the accumulator received, and passes it on."""
    p = ring.p
    m = as_[0].shape[dim] // p
    acc, pending = None, None
    for i in range(p):
        parts = [torch.matmul(_rows(a, dim, (d + i + 1) % p, m), b)
                 for a, b, d in zip(as_, bs, ring.idx)]
        acc = parts if acc is None else [x + y for x, y in zip(ring.finish(pending), parts)]
        if i != p - 1:
            pending = ring.start(acc)
    return acc


def _dw_x(ring, xs, gs, dim):
    """dW of :func:`_ag_mm`: gather(X)^T @ G_k, summed while the X chunks
    circulate."""
    p, m = ring.p, xs[0].shape[dim]
    dws = [torch.zeros(x.shape[-1], g.shape[-1], dtype=torch.result_type(x, g),
                       device=g.device) for x, g in zip(xs, gs)]
    chunks = xs
    for i in range(p):
        nxt = ring.start(chunks) if i != p - 1 else None
        dws = [dw + (_flat(c).T @ _flat(_rows(g, dim, (d + i) % p, m))).to(dw.dtype)
               for dw, c, g, d in zip(dws, chunks, gs, ring.idx)]
        if nxt is not None:
            chunks = ring.finish(nxt)
    return dws


def _dw_g(ring, xs, gs, dim):
    """dW of :func:`_mm_rs`: X_k^T @ gather(G), summed while the scattered
    output-grad chunks circulate."""
    p, m = ring.p, gs[0].shape[dim]
    dws = [torch.zeros(x.shape[-1], g.shape[-1], dtype=torch.result_type(x, g),
                       device=g.device) for x, g in zip(xs, gs)]
    chunks = gs
    for i in range(p):
        nxt = ring.start(chunks) if i != p - 1 else None
        dws = [dw + (_flat(_rows(x, dim, (d + i) % p, m)).T @ _flat(c)).to(dw.dtype)
               for dw, x, c, d in zip(dws, xs, chunks, ring.idx)]
        if nxt is not None:
            chunks = ring.finish(nxt)
    return dws


def _transposed(ws):
    return [w.transpose(-2, -1) for w in ws]


# a leg: (body, transpose the second operand, its operands' layouts, the
# result's layout, sum over the batch groups).  A layout names, a dim, how
# it splits: None whole, "row" over the batch groups, "ring" over the model
# members, "rowring" over both (batch group major).
_LEGS = {
    "ag": dict(
        fwd=(_ag_mm, False, (("rowring", None), (None, "ring")), ("row", "ring"), False),
        dx=(_mm_rs, True, (("row", "ring"), (None, "ring")), ("rowring", None), False),
        dw=(_dw_x, False, (("rowring", None), ("row", "ring")), (None, "ring"), True)),
    "rs": dict(
        fwd=(_mm_rs, False, (("row", "ring"), ("ring", None)), ("rowring", None), False),
        dx=(_ag_mm, True, (("rowring", None), ("ring", None)), ("row", "ring"), False),
        dw=(_dw_g, False, (("row", "ring"), ("rowring", None)), ("ring", None), True)),
    "ag_seq": dict(
        fwd=(_ag_mm, False, (("row", "ring", None), (None, "ring")), ("row", None, "ring"),
             False),
        dx=(_mm_rs, True, (("row", None, "ring"), (None, "ring")), ("row", "ring", None),
            False),
        dw=(_dw_x, False, (("row", "ring", None), ("row", None, "ring")), (None, "ring"),
            True)),
    "rs_seq": dict(
        fwd=(_mm_rs, False, (("row", None, "ring"), ("ring", None)), ("row", "ring", None),
             False),
        dx=(_ag_mm, True, (("row", "ring", None), ("ring", None)), ("row", None, "ring"),
            False),
        dw=(_dw_g, False, (("row", None, "ring"), ("row", "ring", None)), ("ring", None),
            True)),
}


def _split(kind: Optional[str], r: int, j: int, R: int, p: int) -> Tuple[int, int]:
    """(blocks along a dim, this member's block) for a layout entry."""
    if kind == "row":
        return R, r
    if kind == "ring":
        return p, j
    if kind == "rowring":
        return R * p, r * p + j
    return 1, 0


def _block(t: torch.Tensor, layout, r, j, R, p) -> torch.Tensor:
    for dim, kind in enumerate(layout):
        n, at = _split(kind, r, j, R, p)
        if n > 1:
            w = t.shape[dim] // n
            t = t.narrow(dim, at * w, w)
    return t


def _groups(mesh, axis: str):
    """The member devices of each batch group's ring, groups in row-major
    order over the sized batch axes."""
    names = mesh.axis_names
    rows = _row_axes(mesh)
    out = []
    for pos in itertools.product(*(range(mesh.shape[a]) for a in rows)):
        coords = dict(zip(rows, pos))
        out.append([mesh.devices[tuple(j if a == axis else coords.get(a, 0) for a in names)]
                    for j in range(mesh.shape[axis])])
    return out


def _run_members(mesh, axis, leg, a, b, dim):
    """One leg on a single-controller mesh: global operands in, the global
    result out on ``a``'s device."""
    body, trans, layouts, out_layout, psum = leg
    groups = _groups(mesh, axis)
    R, p = len(groups), mesh.shape[axis]
    out = None
    for r, devs in enumerate(groups):
        blocks = [[_block(t, lay, r, j, R, p).to(devs[j]) for j in range(p)]
                  for t, lay in zip((a, b), layouts)]
        if trans:
            blocks[1] = _transposed(blocks[1])
        res = body(_MemberRing(devs), blocks[0], blocks[1], dim)
        if out is None:
            shape = list(res[0].shape)
            for d, kind in enumerate(out_layout):
                shape[d] *= _split(kind, 0, 0, R, p)[0]
            out = torch.empty(shape, dtype=res[0].dtype, device=a.device)
        for j, blk in enumerate(res):
            dst = _block(out, out_layout, r, j, R, p)
            if psum and r > 0:
                dst.add_(blk.to(out.device))
            else:
                dst.copy_(blk)
    return out


def _run_process(mesh, axis, leg, a, b, dim):
    """One leg on a process mesh: this process's blocks in and out."""
    body, trans = leg[:2]
    bb = b.transpose(-2, -1) if trans else b
    return body(_ProcessRing(mesh, axis), [a], [bb], dim)[0]


class _RingMatmul(torch.autograd.Function):
    """Forward one ring, backward the two mirrored rings."""

    @staticmethod
    def forward(ctx, x, w, kind, mesh, axis):
        ctx.save_for_backward(x, w)
        ctx.kind, ctx.mesh, ctx.axis = kind, mesh, axis
        return _leg(mesh, axis, _LEGS[kind]["fwd"], x, w, _dim(kind))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        legs, mesh, axis = _LEGS[ctx.kind], ctx.mesh, ctx.axis
        g = g.contiguous()
        dim = _dim(ctx.kind)
        dx = _leg(mesh, axis, legs["dx"], g, w, dim).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        dw = _leg(mesh, axis, legs["dw"], x, g, dim).to(w.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None


def _dim(kind: str) -> int:
    """The dim the ring splits: the sequence of [b, s, K] for the _seq
    forms, the rows otherwise."""
    return 1 if kind.endswith("_seq") else 0


def _leg(mesh, axis, leg, a, b, dim):
    run = _run_process if mesh.procs is not None else _run_members
    return run(mesh, axis, leg, a, b, dim)


def _record(kind: str, nbytes: int, p: int, axis: str) -> None:
    """Telemetry, as the reference's: the ring moves (p-1)/p of the
    payload as permutes, recorded as a trace-time record so that the
    executed bytes stay with the traced programs."""
    try:
        from ... import telemetry

        telemetry.record_collective(
            "ppermute", nbytes=int(nbytes * (p - 1) / p), axes=(axis,),
            group_size=p, trace_time=True, source="collective_matmul")
    except Exception:
        pass


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis: str = MODEL_AXIS):
    """``gather(X over axis) @ W`` as a ring of partial matmuls.  Single
    controller: ``x`` global [rows, K] (rows divisible by the batch axes x
    p), ``w`` global [K, N] (N over ``axis``); returns ``x @ w``.  On a
    process mesh: this process's [rows / p, K] chunk and [K, N / p] columns
    give its [rows, N / p]."""
    _record("all_gather_matmul", _nbytes(x), mesh.shape[axis], axis)
    return _RingMatmul.apply(x, w, "ag", mesh, axis)


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, mesh, axis: str = MODEL_AXIS):
    """``reduce_scatter(X @ W over axis)`` as a ring fused with the partial
    matmuls.  Single controller: ``x`` global [rows, K] (K over ``axis``),
    ``w`` global [K, N]; returns ``x @ w`` (the members' partials summed
    along the ring).  On a process mesh: this process's [rows, K / p] and
    [K / p, N] give its summed [rows / p, N] row block."""
    p = mesh.shape[axis]
    _record("matmul_reduce_scatter", _nbytes(x) // max(1, p), p, axis)
    return _RingMatmul.apply(x, w, "rs", mesh, axis)


def _seq_call(kind: str, x: torch.Tensor, w: torch.Tensor, mesh, axis: str):
    lead = x.shape[:-2]
    x3 = x.reshape((-1, x.shape[-2], x.shape[-1]))
    out = _RingMatmul.apply(x3, w, kind, mesh, axis)
    return out.reshape((*lead, out.shape[-2], out.shape[-1]))


def all_gather_matmul_seq(x: torch.Tensor, w: torch.Tensor, mesh, axis: str = MODEL_AXIS):
    """Sequence-parallel ``gather(X over seq) @ W``: ``x`` [..., s, K] with
    s over ``axis`` (a process's [..., s / p, K] on a process mesh), ``w``
    [K, N] with N over ``axis``; returns [..., s, N], N over ``axis``."""
    _record("all_gather_matmul_seq", _nbytes(x), mesh.shape[axis], axis)
    return _seq_call("ag_seq", x, w, mesh, axis)


def matmul_reduce_scatter_seq(x: torch.Tensor, w: torch.Tensor, mesh,
                              axis: str = MODEL_AXIS):
    """Sequence-parallel ``reduce_scatter(X @ W over seq)``: ``x`` [..., s,
    K] with K over ``axis``, ``w`` [K, N] with K over ``axis``; returns
    [..., s, N] with s over ``axis`` (a process's [..., s / p, N])."""
    p = mesh.shape[axis]
    _record("matmul_reduce_scatter_seq", _nbytes(x) // max(1, p), p, axis)
    return _seq_call("rs_seq", x, w, mesh, axis)
