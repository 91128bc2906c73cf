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
is held whole, once.  Above the ring gate (``overlap.should_decompose``:
``PADDLE_TPU_TP_OVERLAP`` on, the default, model degree 2 or more, 256
ring-chunk rows a member, pipe degree 1) the column and row linears take
the reference's collective-matmul ring (``overlap/collective_matmul.py``):
the same product as a ring of partial matmuls, with the mirrored ring as
its backward; below it, the fused form above.  The layers are
``nn.Layer``s: ``weight_attr`` takes a ``ParamAttr``, an initializer or a
name, as in the reference (``False`` refuses: a weight cannot be left
out).  A weight is drawn at its global shape, on the layer's device, with
its generator (the constructor's ``device=``/``generator=`` or the
enclosing ``placement``), by the attribute's initializer, else from N(0,
``std``) (the port's default for every Linear), so a process of a
multi-process job holds the same values as the global weight's shard; the
parameter carries the attribute's name (``param_name``), learning-rate
multiplier, regularizer, ``need_clip`` and ``trainable``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ...amp import maybe_autocast_tensors
from ...framework.param_attr import ParamAttr
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer.layers import Layer
from ..overlap import all_gather_matmul, matmul_reduce_scatter, should_decompose
from ..topology import CommGroup, get_hybrid_communicate_group, process_mesh_coords

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear", "RowParallelLinear",
           "ParallelCrossEntropy"]


def _mesh():
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("call fleet.init / init_parallel_env (or set a "
                           "HybridCommunicateGroup) before building parallel layers")
    return hcg.mesh


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


def _weight(layer: Layer, shape, attr, what: str, std: float, dtype, model: _Model,
            axis: Optional[int]) -> nn.Parameter:
    """The weight of ``layer`` under ``attr``, drawn at its global
    ``shape``; a process of a multi-process mesh keeps its shard along
    ``axis``."""
    attr = ParamAttr._to_attr(attr)
    if attr is None:
        raise ValueError("attr=False is handled by the calling layer (means: no "
                         f"parameter), and {what} cannot be left out")
    init = attr.initializer or I.Normal(0.0, std)
    device, gen = layer._home(), layer._generator
    if gen is not None and gen.device.type != device.type:
        gen = None   # the device's global generator
    w = init(tuple(shape), dtype, gen, device)
    if model.multi and axis is not None:
        w = model.local(w, axis)
    p = nn.Parameter(w, requires_grad=bool(attr.trainable))
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    p.param_name = attr.name
    return _mark(p, axis)


def _zeros(n, layer: Layer, dtype, model: _Model, axis: Optional[int]):
    size = n // model.n if model.multi and axis is not None else n
    return _mark(nn.Parameter(torch.zeros(size, device=layer._home(), dtype=dtype)), axis)


def _mark(p: nn.Parameter, axis: Optional[int]) -> nn.Parameter:
    p.is_distributed = axis is not None
    if axis is not None:
        p.split_axis = axis
    return p


def _bias(out: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``out + bias``; under ``amp.auto_cast`` the bias in the amp dtype, as
    the reference's linears cast it ("linear")."""
    if bias is None:
        return out
    (bias,) = maybe_autocast_tensors("linear", bias)
    return out + bias


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


class VocabParallelEmbedding(Layer):
    """Embedding with the vocab dim split over ``model`` (``split_axis``
    0): each member looks up the ids in its vocab range (zero rows
    elsewhere) and the members' rows are summed, the reference's masked
    lookup + all-reduce."""

    def __init__(self, num_embeddings: int, embedding_dim: int, weight_attr=None,
                 mp_group=None, name=None, *, std: float = 0.02,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._place(device, generator)
        self._model = _Model(_mesh())
        self._model.check("vocab size", num_embeddings)
        self._num_embeddings = num_embeddings
        self.weight = _weight(self, (num_embeddings, embedding_dim), weight_attr,
                              "VocabParallelEmbedding weight", std, dtype, self._model, 0)

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


class ColumnParallelLinear(Layer):
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
        self._place(device, generator)
        self._model = _Model(_mesh())
        self._model.check("out_features", out_features)
        self.gather_output = gather_output
        self.weight = _weight(self, (in_features, out_features), weight_attr,
                              "ColumnParallelLinear weight", std, dtype, self._model, 1)
        self.bias = _zeros(out_features, self, dtype, self._model, 0) if has_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self._model
        ring = should_decompose(tuple(x.shape), m.mesh)
        if m.multi:
            if ring:   # this process's row chunk through the ring
                chunk = _Split.apply(x.reshape(-1, x.shape[-1]), m.group, m.rank, 0)
                chunk, w = maybe_autocast_tensors("linear", chunk, self.weight)
                out = _bias(all_gather_matmul(chunk, w, m.mesh).reshape(*x.shape[:-1], -1),
                            self.bias)
            else:
                out = F.linear(_CIdentity.apply(x, m.group), self.weight, self.bias)
            return _Gather.apply(out, m.group, m.rank, out.dim() - 1) \
                if self.gather_output else out
        if ring:
            rows, w = maybe_autocast_tensors("linear", x.reshape(-1, x.shape[-1]), self.weight)
            return _bias(all_gather_matmul(rows, w, m.mesh).reshape(*x.shape[:-1], -1),
                         self.bias)
        return self._fused(x)

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """Single controller: each member's columns, joined."""
        m = self._model
        biases = m.shards(self.bias, 0) if self.bias is not None else [None] * m.n
        outs = [F.linear(x.to(w.device), w, b).to(x.device)
                for w, b in zip(m.shards(self.weight, 1), biases)]
        return torch.cat(outs, -1)


class RowParallelLinear(Layer):
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
        self._place(device, generator)
        self._model = _Model(_mesh())
        self._model.check("in_features", in_features)
        self.input_is_parallel = input_is_parallel
        self.weight = _weight(self, (in_features, out_features), weight_attr,
                              "RowParallelLinear weight", std, dtype, self._model, 0)
        self.bias = _zeros(out_features, self, dtype, self._model, None) \
            if has_bias else None

    def _partial(self, x: torch.Tensor) -> torch.Tensor:
        """The members' partial products summed: global [.., out]; above
        the ring gate, by the matmul-reduce-scatter ring (across processes
        its row blocks are then all-gathered)."""
        m = self._model
        ring = should_decompose(tuple(x.shape), m.mesh)
        if m.multi:
            if not self.input_is_parallel:
                x = _Split.apply(x, m.group, m.rank, x.dim() - 1)
            if ring:
                rows = matmul_reduce_scatter(*maybe_autocast_tensors(
                    "linear", x.reshape(-1, x.shape[-1]), self.weight), m.mesh)
                return _Gather.apply(rows, m.group, m.rank, 0).reshape(*x.shape[:-1], -1)
            return _MpAllReduce.apply(F.linear(x, self.weight), m.group)
        if x.shape[-1] % m.n:
            raise ValueError(f"input features {x.shape[-1]} not divisible by mp degree {m.n}")
        if ring:
            rows, w = maybe_autocast_tensors("linear", x.reshape(-1, x.shape[-1]), self.weight)
            return matmul_reduce_scatter(rows, w, m.mesh).reshape(*x.shape[:-1], -1)
        return self._fused(x)

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """Single controller: each member's partial product, summed."""
        m = self._model
        return member_sum([F.linear(xj.to(w.device), w)
                           for xj, w in zip(x.chunk(m.n, -1), m.shards(self.weight, 0))],
                          x.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _bias(self._partial(x), self.bias)


class ParallelCrossEntropy(Layer):
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
