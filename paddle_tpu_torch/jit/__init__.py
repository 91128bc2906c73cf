"""The training step (port of the reference's ``jit/__init__.py``
``TrainStep``).

The reference compiles gradients, clipping and the update into one XLA
program with donated state.  PyTorch runs eagerly, so the port's step is
the same sequence in eager code: clear the gradients, ``loss_fn(model,
*batch)``, ``backward``, clip, update.  The numbers follow the reference:
the reference differentiates with respect to the f32 master weights, so a
bf16 parameter's gradient is its bf16 cotangent cast to f32, which is what
the optimizer does with ``.grad`` before the clip.  ``gradient_merge=k``
splits every batch argument into k micro-batches along dim 0, sums their
gradients in f32, and divides by k (the reference's default averaging;
``optimizer._gradient_merge_avg`` False, which ``fleet`` sets from its
strategy, keeps the sum); the loss returned is the mean of the
micro-batch losses.  Without ``gradient_merge``, k comes from
``optimizer._gradient_merge_k`` (set by ``fleet.distributed_optimizer``),
as in the reference.

``donate`` is accepted and has no effect: the reference donates the
state buffers to its compiled step, and the eager step updates them in
place anyway.  A model with an ``apply_collective_grads`` method (a
``distributed.DataParallel``) has its gradients synchronised after each
(micro-batch) backward and before the clip and update: across processes,
the mean over the data-parallel group, which the reference's compiled step
gets from XLA's gradient all-reduce over a batch sharded on ``data``.

The reference's ``health_guard``, ``snapshotter`` and SDC monitor wait
for the health and checkpoint layers (ROADMAP A7) and raise.
``persistent_cache`` keeps compiled XLA programs across processes; an
eager step compiles no program, so it raises too, naming the compile
service (ROADMAP A10).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt)``;
    ``loss = step(x, y)`` updates the model and optimizer in place and
    returns the loss, an f32 scalar tensor on the model's device.  Batch
    arguments may be tensors or numpy arrays; they are moved to the
    model's device."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 donate: bool = True, gradient_merge: Optional[int] = None,
                 health_guard=None, persistent_cache=None, snapshotter=None):
        for name, value in (("health_guard", health_guard),
                            ("snapshotter", snapshotter)):
            if value is not None:
                raise NotImplementedError(
                    f"TrainStep {name}= is not ported yet (ROADMAP A7)")
        if persistent_cache is not None:
            raise NotImplementedError(
                "TrainStep persistent_cache= caches compiled XLA programs across "
                "processes; the eager step compiles none, so it has nothing to "
                "cache (the compile service is ROADMAP A10)")
        self.model = model
        self._sync_grads = getattr(model, "apply_collective_grads", None)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        if gradient_merge is None:
            gradient_merge = getattr(optimizer, "_gradient_merge_k", 1)
        self._merge_k = max(1, int(gradient_merge or 1))
        self._merge_avg = bool(getattr(optimizer, "_gradient_merge_avg", True))
        self._params = [p for p in model.parameters() if p.requires_grad]

    def attach_sdc_monitor(self, monitor) -> None:
        raise NotImplementedError(
            "TrainStep SDC monitor is not ported yet (ROADMAP A7)")

    def _batch(self, batch) -> List[torch.Tensor]:
        device = next(iter(self.model.parameters())).device
        arrays = [torch.as_tensor(b, device=device) for b in batch]
        if self._merge_k > 1:
            for a in arrays:
                if a.dim() == 0 or a.shape[0] % self._merge_k:
                    raise ValueError(
                        f"gradient_merge k={self._merge_k} needs every batch "
                        f"arg's dim0 divisible by k, got shape {tuple(a.shape)}")
        return arrays

    def __call__(self, *batch) -> torch.Tensor:
        loss, grads = self._loss_and_grads(self._batch(batch))
        self._update(grads)
        return loss

    def _loss_and_grads(self, arrays: List[torch.Tensor]):
        """The loss (an f32 scalar) and the ``[(param, grad)]`` the update
        takes: the optimizer's parameters with their ``.grad``, or, under
        gradient merge, the merged f32 gradients."""
        for p in self._params:
            p.grad = None
        k = self._merge_k
        if k == 1:
            loss = self.loss_fn(self.model, *arrays).float()
            loss.backward()
            if self._sync_grads is not None:
                self._sync_grads()
            return loss.detach(), [(p, p.grad) for p in self.optimizer._parameter_list
                                   if p.requires_grad and p.grad is not None]
        merged: Dict[int, torch.Tensor] = {}
        loss_sum = torch.zeros((), dtype=torch.float32, device=arrays[0].device)
        for i in range(k):
            micro = [a.chunk(k)[i] for a in arrays]
            loss_i = self.loss_fn(self.model, *micro).float()
            loss_i.backward()
            if self._sync_grads is not None:   # the mean over ranks is linear:
                self._sync_grads()             # synchronise each micro-batch
            loss_sum += loss_i.detach()
            for p in self._params:
                if p.grad is not None:
                    g = p.grad.float()
                    merged[id(p)] = g if id(p) not in merged else merged[id(p)] + g
                    p.grad = None
        div = k if self._merge_avg else 1
        return loss_sum / k, [(p, merged[id(p)] / div) for p in self._params
                              if id(p) in merged]

    def _update(self, grads) -> None:
        """Clip and update (the optimizer's ``_apply``), then re-apply the
        ``incubate.asp`` masks of pruned parameters, as the reference's
        step does."""
        from ..incubate.asp import ASPHelper

        self.optimizer._apply(grads)
        ASPHelper.apply_masks(self.optimizer)


# the reference's exports that wait for ROADMAP A3d
_UNPORTED = frozenset({"to_static", "not_to_static", "ignore_module", "save", "load",
                       "InputSpec", "StaticFunction", "TranslatedLayer"})


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"jit.{name} is not ported yet (ROADMAP A3d: to_static, jit.save/load)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
