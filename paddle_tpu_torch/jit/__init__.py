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
gradients in f32, and divides by k (the reference's default averaging);
the loss returned is the mean of the micro-batch losses.

``donate`` is accepted and has no effect: the reference donates the
state buffers to its compiled step, and the eager step updates them in
place anyway.  A model with an ``apply_collective_grads`` method (a
``distributed.DataParallel``) has its gradients synchronised after each
(micro-batch) backward and before the clip and update: across processes,
the mean over the data-parallel group, which the reference's compiled step
gets from XLA's gradient all-reduce over a batch sharded on ``data``.

The reference's ``health_guard``, ``persistent_cache``, ``snapshotter`` and
SDC monitor are not ported yet (ROADMAP A5, after A7) and raise.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

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
                            ("persistent_cache", persistent_cache),
                            ("snapshotter", snapshotter)):
            if value is not None:
                raise NotImplementedError(
                    f"TrainStep {name}= is not ported yet (ROADMAP A5)")
        self.model = model
        self._sync_grads = getattr(model, "apply_collective_grads", None)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._merge_k = max(1, int(gradient_merge or 1))
        self._params = [p for p in model.parameters() if p.requires_grad]

    def attach_sdc_monitor(self, monitor) -> None:
        raise NotImplementedError(
            "TrainStep SDC monitor is not ported yet (ROADMAP A5)")

    def _batch(self, batch) -> List[torch.Tensor]:
        device = next(self.model.parameters()).device
        arrays = [torch.as_tensor(b, device=device) for b in batch]
        if self._merge_k > 1:
            for a in arrays:
                if a.dim() == 0 or a.shape[0] % self._merge_k:
                    raise ValueError(
                        f"gradient_merge k={self._merge_k} needs every batch "
                        f"arg's dim0 divisible by k, got shape {tuple(a.shape)}")
        return arrays

    def __call__(self, *batch) -> torch.Tensor:
        arrays = self._batch(batch)
        for p in self._params:
            p.grad = None
        k = self._merge_k
        if k == 1:
            loss = self.loss_fn(self.model, *arrays).float()
            loss.backward()
            if self._sync_grads is not None:
                self._sync_grads()
            self.optimizer.step()
            return loss.detach()
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
        grads = [(p, merged[id(p)] / k) for p in self._params if id(p) in merged]
        self.optimizer._apply(grads)
        return loss_sum / k
