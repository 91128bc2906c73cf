"""Megatron-style sequence parallelism over the ``model`` axis (port of the
reference's ``distributed/meta_parallel/sequence_parallel.py``; paddle's
``fleet/utils/sequence_parallel_utils.py``: ScatterOp, GatherOp,
AllGatherOp, ReduceScatterOp, ColumnSequenceParallelLinear,
RowSequenceParallelLinear, mark_as_sequence_parallel_parameter; Korthikanti
et al., "Reducing Activation Recomputation in Large Transformer Models").

Between tensor-parallel regions the activations live split along the
sequence over ``model`` (the SP residency): norms and residual adds touch
1/mp of the tokens, and the region's two collectives become an all-gather
before the column matmul and a reduce-scatter after the row matmul.

The residency is a layout, never a change of the math, and the two modes
of ``distributed.topology`` hold it differently:

- **Single controller**: activations are global tensors on the caller's
  device (as the reference's are global arrays), so the four ops are value
  identities, as the reference's sharding constraints are, and the SP
  linears compute what the plain tensor-parallel ones do.  A norm's weight
  sees every token, so its gradient is already the sum over the members.
- **Multi-process**: a process holds its sequence block; the ops are
  autograd Functions over the model group (Scatter: split / all-gather;
  Gather: all-gather / split; AllGather: all-gather / reduce-scatter;
  ReduceScatter: reduce-scatter / all-gather), and
  :func:`register_sequence_parallel_allreduce_hooks` sums a marked
  parameter's gradient over the group, as paddle's backward hooks do.

``sequence_parallel_enabled`` is the one gate (the flag, then
``PADDLE_TPU_SP``, then on when mp > 1).  The reference's ring lowering
(``PADDLE_TPU_TP_OVERLAP``) waits for ROADMAP A6c and raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from ...nn import functional as F
from ..topology import get_hybrid_communicate_group
from .mp_layers import (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
                        _all_reduce, _Gather, _mesh, _Model, _refuse_overlap, _Split)

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter", "is_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks",
           "sequence_parallel_enabled", "sp_fingerprint"]


def sequence_parallel_enabled(flag: Optional[bool] = None) -> bool:
    """The one sequence-parallel gate.  An explicit ``flag`` wins; else
    ``PADDLE_TPU_SP`` ("0"/"false" off, anything else on); else on exactly
    when a hybrid group with model degree >= 2 is live."""
    if flag is not None:
        return bool(flag)
    v = os.environ.get("PADDLE_TPU_SP")
    if v is not None:
        return v not in ("0", "false")
    hcg = get_hybrid_communicate_group()
    return hcg is not None and hcg.mesh.shape.get("model", 1) > 1


def sp_fingerprint() -> dict:
    """The SP configuration as key material (the reference folds it into
    its compile-cache key).  The port compiles nothing, so no cache reads
    it; it is kept so that code keying its own caches on it carries over."""
    return {"sp_env": os.environ.get("PADDLE_TPU_SP"),
            "sp": sequence_parallel_enabled()}


def _op(x: torch.Tensor, seq_dim: int, multi_fn) -> torch.Tensor:
    m = _Model(_mesh())
    return multi_fn(m, seq_dim % x.dim()) if m.multi else x


class ScatterOp:
    """Split activations along the sequence over the model group: a
    process keeps its block (backward: all-gather)."""

    @staticmethod
    def apply(x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        return _op(x, seq_dim, lambda m, d: _Split.apply(x, m.group, m.rank, d))


class GatherOp:
    """Re-assemble the sequence (backward: this process's block)."""

    @staticmethod
    def apply(x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        return _op(x, seq_dim, lambda m, d: _Gather.apply(x, m.group, m.rank, d))


class AllGatherOp:
    """Re-assemble the sequence before a column matmul (backward: the
    reduce-scatter of the partial input gradients)."""

    @staticmethod
    def apply(x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        return _op(x, seq_dim, lambda m, d: _Gather.apply(x, m.group, m.rank, d, True))


class ReduceScatterOp:
    """Sum the partials over the model group and keep this process's
    sequence block (backward: all-gather)."""

    @staticmethod
    def apply(x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        return _op(x, seq_dim, lambda m, d: _Split.apply(x, m.group, m.rank, d, True))


def mark_as_sequence_parallel_parameter(parameter: torch.Tensor) -> None:
    """Tag a parameter of the SP region (a norm's weight, a row-parallel
    bias): across processes each sees 1/mp of the tokens, so its gradient
    is summed over the model group."""
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter: torch.Tensor) -> bool:
    return getattr(parameter, "sequence_parallel", False)


def register_sequence_parallel_allreduce_hooks(
        model: nn.Module, accumulation_steps: int = 1,
        fuse_sequence_parallel_allreduce: bool = False) -> nn.Module:
    """Mark the parameters of ``model``'s SP-region layers (every layer but
    the parallel linears and embeddings, and only parameters that are not
    split) and record ``accumulation_steps`` on each
    (``p._sp_accumulation_steps``).  Across processes, hook each marked
    parameter so that every ``accumulation_steps``-th accumulation of its
    gradient is summed over the model group; on a single-controller mesh
    the gradient is already whole.  ``fuse_sequence_parallel_allreduce``
    (one fused all-reduce) is refused, as in the reference."""
    if fuse_sequence_parallel_allreduce:
        raise NotImplementedError(
            "fuse_sequence_parallel_allreduce=True is the reference's "
            "manually-fused allreduce, which it refuses too; each marked "
            "parameter's gradient is summed on its own. Leave it False.")
    if accumulation_steps < 1:
        raise ValueError(f"accumulation_steps must be >= 1, got {accumulation_steps}")
    tp_types = (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    for layer in model.modules():
        if isinstance(layer, tp_types):
            continue
        for p in layer.parameters(recurse=False):
            # (``Tensor.is_distributed`` is also a method of torch's)
            if vars(p).get("is_distributed") is not True:
                mark_as_sequence_parallel_parameter(p)
    m = _Model(_mesh())
    for p in model.parameters():
        if not is_sequence_parallel_parameter(p):
            continue
        p._sp_accumulation_steps = accumulation_steps
        if m.multi and p.requires_grad and not getattr(p, "_sp_hooked", False):
            p.register_post_accumulate_grad_hook(_sum_over_model(m, accumulation_steps))
            p._sp_hooked = True
    return model


def _sum_over_model(m: _Model, steps: int):
    count = [0]

    def hook(p: torch.Tensor) -> None:
        count[0] += 1
        if count[0] % steps == 0:
            p.grad.copy_(_all_reduce(p.grad, m.group))
    return hook


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-parallel linear whose input arrives sequence-split: across
    processes it is all-gathered along the sequence before the matmul (its
    backward reduce-scatters the input gradient); on a single-controller
    mesh, the column-parallel linear."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 gather_output=False, mp_group=None, name=None, *, std: float = 0.02,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, weight_attr, has_bias, gather_output,
                         False, mp_group, name, std=std, generator=generator,
                         device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self._model
        if not m.multi:
            return super().forward(x)
        _refuse_overlap()
        out = F.linear(_Gather.apply(x, m.group, m.rank, 1, True), self.weight, self.bias)
        return _Gather.apply(out, m.group, m.rank, out.dim() - 1) if self.gather_output else out


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-parallel linear whose output leaves sequence-split: across
    processes the partial products are reduce-scattered along ``seq_dim``,
    then the bias (replicated, marked SP) is added; on a single-controller
    mesh, the row-parallel linear."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=True, mp_group=None, name=None, *, std: float = 0.02,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         input_is_parallel, False, mp_group, name, std=std,
                         generator=generator, device=device, dtype=dtype)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        m = self._model
        if not m.multi:
            return super().forward(x)
        _refuse_overlap()
        if not self.input_is_parallel:
            x = _Split.apply(x, m.group, m.rank, x.dim() - 1)
        out = _Split.apply(F.linear(x, self.weight), m.group, m.rank, seq_dim % x.dim(), True)
        return out if self.bias is None else out + self.bias
