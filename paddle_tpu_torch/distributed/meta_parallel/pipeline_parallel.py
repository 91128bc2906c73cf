"""Host pipeline runtimes (port of the reference's
``distributed/meta_parallel/pipeline_parallel.py``; paddle's
``fleet/meta_parallel/pipeline_parallel.py:440`` 1F1B and ``:906``
interleaved).

:class:`PipelineParallel` runs the reference's 1F1B micro-batch order over
a :class:`~.pp_layers.PipelineLayer` in the one process (warm-up
forwards, steady one-forward-one-backward pairs, cool-down backwards),
each micro-batch's backward through autograd, its loss scaled by
1/``accumulate_steps``; ``static_scheduler`` gives the "f0;f1;b0;..."
order of a stage.  :class:`PipelineParallelWithInterleave` runs the
interleaved order over virtual chunks.  The schedule-driven engines are
:class:`~paddle_tpu_torch.distributed.pipeline_1f1b.OneFOneBLayers` and
:class:`~paddle_tpu_torch.distributed.engine.GPipeLayers`.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel", "PipelineParallelWithInterleave"]


def _first(loss):
    return loss[0] if isinstance(loss, tuple) else loss


def _mean(losses) -> torch.Tensor:
    with torch.no_grad():
        total = losses[0].detach()
        for l in losses[1:]:
            total = total + l.detach()
        return total * (1.0 / len(losses))


class PipelineParallel:
    """Host 1F1B over a ``PipelineLayer``'s stages."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None,
                 accumulate_steps: Optional[int] = None):
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel requires a PipelineLayer")
        self.pipeline = layers
        self.num_stages = layers.num_stages
        self.accumulate_steps = accumulate_steps or self.num_stages
        self._loss_fn = layers._loss_fn

    def static_scheduler(self, stage_id: int) -> str:
        """Stage ``stage_id``'s event order, "f0;f1;b0;...;" (reference
        :447)."""
        acc = self.accumulate_steps
        startup = min(self.num_stages - stage_id - 1, acc)
        events: List[str] = [f"f{i}" for i in range(startup)]
        fwd_i, bwd_i = startup, 0
        for _ in range(acc - startup):
            events += [f"f{fwd_i}", f"b{bwd_i}"]
            fwd_i += 1
            bwd_i += 1
        events += [f"b{i}" for i in range(bwd_i, acc)]
        return ";".join(events) + ";"

    def forward_backward_pipeline(self, data: torch.Tensor, labels: torch.Tensor,
                                  scaler=None) -> torch.Tensor:
        """1F1B forwards and backwards of ``accumulate_steps`` micro-batches,
        without the optimizer step (reference :440): the gradients
        accumulate on the parameters; returns the mean micro-batch loss."""
        return self._run_1f1b(data, labels, scaler)

    def _micro(self, x, y):
        acc = self.accumulate_steps
        return x.chunk(acc), y.chunk(acc)

    def _backward(self, loss, scaler) -> None:
        scaled = loss * (1.0 / self.accumulate_steps)
        if scaler is not None:
            scaled = scaler.scale(scaled)
        scaled.backward()

    def _run_1f1b(self, x, y, scaler=None) -> torch.Tensor:
        acc = self.accumulate_steps
        micro_x, micro_y = self._micro(x, y)
        losses: List[torch.Tensor] = []
        pending: List[torch.Tensor] = []

        def fwd(i):
            h = micro_x[i]
            for s in range(self.num_stages):
                h = self.pipeline.stage_forward(s, h)
            loss = _first(self._loss_fn(h, micro_y[i]) if self._loss_fn else h)
            losses.append(loss)
            return loss

        idx = 0
        for _ in range(min(self.num_stages - 1, acc)):
            pending.append(fwd(idx))
            idx += 1
        while idx < acc:
            pending.append(fwd(idx))
            idx += 1
            self._backward(pending.pop(0), scaler)
        while pending:
            self._backward(pending.pop(0), scaler)
        return _mean(losses)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None) -> torch.Tensor:
        """One pipeline batch and the optimizer step (reference :657)."""
        if not isinstance(data, (tuple, list)):
            raise ValueError("train_batch expects (inputs, labels)")
        x, y = data
        mean_loss = self._run_1f1b(x, y, scaler)
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return mean_loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss: bool = True):
        x, y = data
        h = x
        for s in range(self.num_stages):
            h = self.pipeline.stage_forward(s, h)
        if compute_loss and self._loss_fn is not None:
            return self._loss_fn(h, y)
        return h


class PipelineParallelWithInterleave(PipelineParallel):
    """Interleaved 1F1B (reference :906; Megatron's
    ``forward_backward_pipelining_with_interleaving``): each stage holds v =
    ``num_virtual_pipeline_stages`` chunks (chunk c of stage s = segment
    c·P + s); a micro-step takes one micro-batch through one chunk, in the
    interleaved order, and a micro-batch's backward runs through autograd
    at its last backward micro-step, so losses and gradients equal the
    sequential ones while the forwards follow the interleaved order."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None,
                 accumulate_steps: Optional[int] = None):
        super().__init__(layers, hcg, strategy, accumulate_steps)
        self.num_model_chunks = layers._num_virtual_pipeline_stages
        if self.num_model_chunks < 2:
            raise ValueError(
                "PipelineParallelWithInterleave requires a PipelineLayer built "
                "with num_virtual_pipeline_stages >= 2")
        if self.accumulate_steps % self.num_stages != 0:
            raise ValueError("interleaved 1F1B requires accumulate_steps to be "
                             "a multiple of the pipe degree (as the reference)")

    def _virtual_chunk(self, micro_step: int, forward: bool) -> int:
        pos = micro_step % (self.num_stages * self.num_model_chunks)
        chunk = pos // self.num_stages
        return chunk if forward else self.num_model_chunks - 1 - chunk

    def _micro_batch_id(self, micro_step: int) -> int:
        group = micro_step // (self.num_stages * self.num_model_chunks)
        return group * self.num_stages + micro_step % self.num_stages

    def _num_warmup(self, stage_id: int) -> int:
        p, v, m = self.num_stages, self.num_model_chunks, self.accumulate_steps
        total = m * v
        if m == p:
            return total  # all forwards, then all backwards
        return min((p - stage_id - 1) * 2 + (v - 1) * p, total)

    def _event(self, kind: str, k: int) -> str:
        return f"{kind}{self._virtual_chunk(k, kind == 'f')}_{self._micro_batch_id(k)}"

    def interleave_scheduler(self, stage_id: int) -> str:
        """Stage ``stage_id``'s "f{chunk}_{mb};...;b{chunk}_{mb};..." order."""
        total = self.accumulate_steps * self.num_model_chunks
        warmup = self._num_warmup(stage_id)
        events = [self._event("f", k) for k in range(warmup)]
        for j in range(total - warmup):
            events += [self._event("f", warmup + j), self._event("b", j)]
        events += [self._event("b", k) for k in range(total - warmup, total)]
        return ";".join(events) + ";"

    def _run_1f1b(self, x, y, scaler=None) -> torch.Tensor:
        acc = self.accumulate_steps
        p, v = self.num_stages, self.num_model_chunks
        micro_x, micro_y = self._micro(x, y)
        total, warmup = acc * v, self._num_warmup(0)
        acts: dict = {}
        done_fwd, done_bwd = [0] * acc, [0] * acc
        losses: List[Optional[torch.Tensor]] = [None] * acc

        def fwd_step(k):
            mb = self._micro_batch_id(k)
            chunk = done_fwd[mb]
            h = acts.get(mb, micro_x[mb])
            for s in range(p):
                h = self.pipeline.chunk_forward(s, chunk, h)
            done_fwd[mb] += 1
            if done_fwd[mb] == v:
                losses[mb] = _first(self._loss_fn(h, micro_y[mb]) if self._loss_fn else h)
                acts.pop(mb, None)
            else:
                acts[mb] = h

        def bwd_step(k):
            mb = self._micro_batch_id(k)
            done_bwd[mb] += 1
            if done_bwd[mb] == v:
                self._backward(losses[mb], scaler)

        fwd_k = bwd_k = 0
        for _ in range(warmup):
            fwd_step(fwd_k)
            fwd_k += 1
        for _ in range(total - warmup):
            fwd_step(fwd_k)
            fwd_k += 1
            bwd_step(bwd_k)
            bwd_k += 1
        while bwd_k < total:
            bwd_step(bwd_k)
            bwd_k += 1
        return _mean(losses)
