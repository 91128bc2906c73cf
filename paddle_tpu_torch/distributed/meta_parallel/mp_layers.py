"""Tensor-parallel layers over the ``model`` mesh axis (port of the
reference's ``distributed/meta_parallel/mp_layers.py``:
``VocabParallelEmbedding``, ``ColumnParallelLinear``, ``RowParallelLinear``,
``ParallelCrossEntropy``; paddle's ``fleet/layers/mpu/mp_layers.py``).

The reference gives each parameter a ``NamedSharding`` over ``model`` and
lets GSPMD insert the identity / all-reduce / all-gather collectives that
paddle's ``mp_ops`` PyLayers code by hand.  The port codes them, in the
two modes of ``distributed.topology``:

- **Single controller** (a mesh from ``build_mesh``, driven from one
  process): a parameter is held ONCE, at its global shape and paddle's
  ``[in, out]`` layout, on the device it was made on; ``state_dict`` keys
  and shapes are the reference's, so ``convert.py`` carries a JAX state
  dict across unchanged.  A forward takes each member's shard as a view of
  the parameter (``narrow`` along ``split_axis``), moved to the member's
  device when it lies elsewhere (then a copy a forward), so the members
  sharing one card share its storage.  Activations are global tensors on
  the caller's device: each member computes on its shard, and the
  row-parallel sum, the vocab-parallel lookup sum and the cross entropy's
  max and sums are reductions over the members, added in member order on
  the caller's device, in f32 (:func:`member_sum`).  Autograd
  differentiates the slices and sums, which gives the reference's
  gradients.
- **Multi-process** (``Mesh.procs``: one member a process): a parameter
  holds this process's shard (paddle's own layout: ``[in, out / mp]`` for
  a column-parallel weight), and each reduction is one
  ``torch.distributed`` call over the model group, carried by an autograd
  Function that pairs it with its backward (identity forward / all-reduce
  backward and the reverse, all-gather / split).

Every parameter records ``split_axis`` and ``is_distributed`` as the
reference's do; a parameter the reference replicates (a row-parallel bias)
is held whole, once.  ``PADDLE_TPU_TP_OVERLAP`` set on asks for the
reference's collective-matmul ring (``overlap/collective_matmul.py``),
which waits for ROADMAP A6c and raises; unset, the port takes the fused
form (the reference's default decomposes above its row threshold: the
same math, another schedule).  Weights are drawn from N(0, ``std``) with
the caller's generator at the global shape (the port's initializer for
every Linear; ``ParamAttr`` and initializers wait for A3), so a process
of a multi-process job holds the same values as the global weight's
shard.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ...nn import functional as F
from ...nn.layer.common import check_attr
from ..topology import CommGroup, get_hybrid_communicate_group, process_mesh_coords

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear", "RowParallelLinear",
           "ParallelCrossEntropy"]


def _mesh():
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("call fleet.init / init_parallel_env (or set a "
                           "HybridCommunicateGroup) before building parallel layers")
    return hcg.mesh


def _refuse_overlap() -> None:
    v = os.environ.get("PADDLE_TPU_TP_OVERLAP")
    if v is not None and v not in ("0", "false"):
        raise NotImplementedError(
            f"PADDLE_TPU_TP_OVERLAP={v}: the collective-matmul ring "
            "(distributed/overlap) is not ported yet (ROADMAP A6c); unset it "
            "or set it to 0 for the fused form")


class _Model:
    """The model axis of ``mesh`` as a layer sees it: its members and, in
    multi-process mode, this process's group and position on it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = CommGroup(mesh, ("model",))
        self.n = mesh.shape["model"]
        self.multi = mesh.procs is not None
        self.rank = process_mesh_coords(mesh)["model"] if self.multi else 0
        self.members = mesh.axis_devices("model")

    def check(self, what: str, size: int) -> None:
        if size % self.n:
            raise ValueError(f"{what} {size} not divisible by mp degree {self.n}")

    def shards(self, p: torch.Tensor, axis: int) -> List[torch.Tensor]:
        """Member j's shard of the global ``p`` on its device (single
        controller)."""
        w = p.shape[axis] // self.n
        return [p.narrow(axis, j * w, w).to(dev) for j, dev in enumerate(self.members)]

    def local(self, full: torch.Tensor, axis: int) -> torch.Tensor:
        """This process's shard of a global tensor (multi-process)."""
        w = full.shape[axis] // self.n
        return full.narrow(axis, self.rank * w, w).contiguous()


def _param(shape, std, generator, device, dtype, model: _Model, axis: Optional[int]):
    """A weight drawn at its global ``shape``; a process of a multi-process
    mesh keeps its shard along ``axis``."""
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, std, generator=generator)
    if model.multi and axis is not None:
        w = model.local(w, axis)
    return _mark(nn.Parameter(w), axis)


def _zeros(n, device, dtype, model: _Model, axis: Optional[int]):
    size = n // model.n if model.multi and axis is not None else n
    return _mark(nn.Parameter(torch.zeros(size, device=device, dtype=dtype)), axis)


def _mark(p: nn.Parameter, axis: Optional[int]) -> nn.Parameter:
    p.is_distributed = axis is not None
    if axis is not None:
        p.split_axis = axis
    return p


def member_sum(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The members' partials added on ``device`` in member order, in f32,
    then rounded once to their dtype (one member: its partial itself)."""
    if len(parts) == 1:
        return parts[0].to(device)
    out = parts[0].to(device, torch.float32)
    for t in parts[1:]:
        out = out + t.to(device, torch.float32)
    return out.to(parts[0].dtype)


# -- the multi-process pairs (paddle's mp_ops) ------------------------------

def _all_reduce(x: torch.Tensor, group: CommGroup, op=dist.ReduceOp.SUM) -> torch.Tensor:
    from ..communication import _check_local, _process_group

    _check_local(x)
    out = x.clone()
    dist.all_reduce(out, op=op, group=_process_group(group)[0])
    return out


def _all_gather(x: torch.Tensor, group: CommGroup, dim: int) -> torch.Tensor:
    from ..communication import _check_local, _process_group

    _check_local(x)
    parts = [torch.empty_like(x) for _ in range(group.nranks)]
    dist.all_gather(parts, x.contiguous(), group=_process_group(group)[0])
    return torch.cat(parts, dim)


class _CIdentity(torch.autograd.Function):
    """Identity forward, sum over the model group backward (``_c_identity``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy.contiguous(), ctx.group), None


class _MpAllReduce(torch.autograd.Function):
    """Sum over the model group forward, identity backward (``_mp_allreduce``)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's slice backward
    (``_c_concat``); with ``reduce`` the backward sums over the group and
    scatters (``AllGatherOp``'s reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, rank, dim, reduce=False):
        ctx.group, ctx.rank, ctx.dim, ctx.reduce = group, rank, dim, reduce
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        if ctx.reduce:
            dy = _all_reduce(dy.contiguous(), ctx.group)
        w = dy.shape[ctx.dim] // ctx.group.nranks
        return dy.narrow(ctx.dim, ctx.rank * w, w).contiguous(), None, None, None, None


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim`` forward, all-gather backward
    (``_c_split``); with ``reduce`` the forward sums over the group first
    (``ReduceScatterOp``)."""

    @staticmethod
    def forward(ctx, x, group, rank, dim, reduce=False):
        ctx.group, ctx.dim = group, dim
        if reduce:
            x = _all_reduce(x.contiguous(), group)
        w = x.shape[dim] // group.nranks
        return x.narrow(dim, rank * w, w).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, ctx.group, ctx.dim), None, None, None, None


class VocabParallelEmbedding(nn.Module):
    """Embedding with the vocab dim split over ``model`` (``split_axis``
    0): each member looks up the ids in its vocab range (zero rows
    elsewhere) and the members' rows are summed, the reference's masked
    lookup + all-reduce."""

    def __init__(self, num_embeddings: int, embedding_dim: int, weight_attr=None,
                 mp_group=None, name=None, *, std: float = 0.02,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_attr(weight_attr, "VocabParallelEmbedding weight", droppable=False)
        self._model = _Model(_mesh())
        self._model.check("vocab size", num_embeddings)
        self._num_embeddings = num_embeddings
        self.weight = _param((num_embeddings, embedding_dim), std, generator, device,
                             dtype, self._model, 0)

    def _lookup(self, ids: torch.Tensor, w: torch.Tensor, lo: int) -> torch.Tensor:
        local = ids.long().to(w.device) - lo
        hit = (local >= 0) & (local < w.shape[0])
        return F.embedding(torch.where(hit, local, 0), w).masked_fill(~hit[..., None], 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self._model
        per = self._num_embeddings // m.n
        if m.multi:
            return _MpAllReduce.apply(self._lookup(x, self.weight, m.rank * per), m.group)
        return member_sum([self._lookup(x, w, j * per)
                     for j, w in enumerate(m.shards(self.weight, 0))], x.device)


class ColumnParallelLinear(nn.Module):
    """Linear with the out features split over ``model`` (weight
    ``split_axis`` 1, bias 0).  Single controller: the output is the
    members' column blocks joined, whatever ``gather_output``; across
    processes it is this process's columns, all-gathered with
    ``gather_output``."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 fuse_matmul_bias=False, mp_group=None, name=None, *, std: float = 0.02,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_attr(weight_attr, "ColumnParallelLinear weight", droppable=False)
        self._model = _Model(_mesh())
        self._model.check("out_features", out_features)
        self.gather_output = gather_output
        self.weight = _param((in_features, out_features), std, generator, device, dtype,
                             self._model, 1)
        self.bias = _zeros(out_features, device, dtype, self._model, 0) if has_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _refuse_overlap()
        m = self._model
        if m.multi:
            out = F.linear(_CIdentity.apply(x, m.group), self.weight, self.bias)
            return _Gather.apply(out, m.group, m.rank, out.dim() - 1) \
                if self.gather_output else out
        biases = m.shards(self.bias, 0) if self.bias is not None else [None] * m.n
        outs = [F.linear(x.to(w.device), w, b).to(x.device)
                for w, b in zip(m.shards(self.weight, 1), biases)]
        return torch.cat(outs, -1)


class RowParallelLinear(nn.Module):
    """Linear with the in features split over ``model`` (weight
    ``split_axis`` 0): each member multiplies its slice of the input by its
    rows, the partials are summed over the members, and the replicated bias
    is added after the sum.  Single controller: the input is global
    whatever ``input_is_parallel``; across processes it is this process's
    slice with ``input_is_parallel``, else the full input, split here."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *, std: float = 0.02,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_attr(weight_attr, "RowParallelLinear weight", droppable=False)
        self._model = _Model(_mesh())
        self._model.check("in_features", in_features)
        self.input_is_parallel = input_is_parallel
        self.weight = _param((in_features, out_features), std, generator, device, dtype,
                             self._model, 0)
        self.bias = _zeros(out_features, device, dtype, self._model, None) \
            if has_bias else None

    def _partial(self, x: torch.Tensor) -> torch.Tensor:
        """The members' partial products summed: global [.., out]."""
        m = self._model
        if m.multi:
            if not self.input_is_parallel:
                x = _Split.apply(x, m.group, m.rank, x.dim() - 1)
            return _MpAllReduce.apply(F.linear(x, self.weight), m.group)
        xs = x.chunk(m.n, -1) if x.shape[-1] % m.n == 0 else None
        if xs is None:
            raise ValueError(f"input features {x.shape[-1]} not divisible by mp degree {m.n}")
        return member_sum([F.linear(xj.to(w.device), w)
                     for xj, w in zip(xs, m.shards(self.weight, 0))], x.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _refuse_overlap()
        out = self._partial(x)
        return out if self.bias is None else out + self.bias


class ParallelCrossEntropy(nn.Module):
    """Softmax cross entropy over logits whose class dim is split over
    ``model`` (reference: local max + all-reduce max, local exp-sum +
    all-reduce sum, the gold logit picked where it lies + all-reduce sum),
    in f32: ``loss = log Σ exp(x - max) + max - x[label]``, 0 where the
    label is ``ignore_index``.  ``input`` [..., V] (single controller: the
    global logits; across processes: this process's V / mp columns),
    ``label`` [...] or [..., 1]; returns the per-sample loss [..., 1]."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self._model = _Model(_mesh())
        self.ignore_index = ignore_index

    def forward(self, input: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        m = self._model
        lab = torch.as_tensor(label, device=input.device).long()
        lab = lab[..., 0] if lab.dim() == input.dim() else lab
        ignore = lab == self.ignore_index
        safe = torch.where(ignore, 0, lab)
        if m.multi:
            lg = input.float()
            per = lg.shape[-1]
            mx = _all_reduce(lg.detach().amax(-1), m.group, dist.ReduceOp.MAX)
            sumexp = _MpAllReduce.apply(torch.exp(lg - mx[..., None]).sum(-1), m.group)
            gold = _MpAllReduce.apply(self._pick(lg, safe - m.rank * per), m.group)
        else:
            blocks = [b.to(dev).float() for b, dev in
                      zip(input.chunk(m.n, -1), m.members)]
            per = blocks[0].shape[-1]
            mx = torch.stack([b.detach().amax(-1).to(input.device) for b in blocks]).amax(0)
            sumexp = member_sum([torch.exp(b - mx.to(b.device)[..., None]).sum(-1)
                           for b in blocks], input.device)
            gold = member_sum([self._pick(b, safe.to(b.device) - j * per)
                         for j, b in enumerate(blocks)], input.device)
        loss = torch.log(sumexp) + mx - gold
        return torch.where(ignore, torch.zeros_like(loss), loss)[..., None]

    @staticmethod
    def _pick(lg: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
        """x[label] where the label's class lies in this block, else 0."""
        hit = (local >= 0) & (local < lg.shape[-1])
        got = lg.gather(-1, torch.where(hit, local, 0)[..., None])[..., 0]
        return torch.where(hit, got, torch.zeros_like(got))
