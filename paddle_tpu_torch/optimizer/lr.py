"""Learning-rate schedulers (port of the reference's ``optimizer/lr.py``:
``LRScheduler``, ``LinearWarmup``, ``CosineAnnealingDecay``).

The same stateful API: ``scheduler.step()`` advances, ``scheduler()`` and
``get_lr()`` read.  The other schedules of the reference are not ported yet
(ROADMAP queue A)."""

from __future__ import annotations

import math
from typing import Optional

__all__ = ["LRScheduler", "LinearWarmup", "CosineAnnealingDecay"]


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.step()

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch: Optional[int] = None) -> None:
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        self.last_lr = self.get_lr()

    def __call__(self) -> float:
        return self.last_lr

    def state_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if not callable(v)}

    def set_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)


class LinearWarmup(LRScheduler):
    """From ``start_lr`` to ``end_lr`` linearly over ``warmup_steps``, then
    ``learning_rate`` (a float, or a scheduler advanced by the steps past
    the warm-up)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        if step < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * step / self.warmup_steps
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.last_epoch = step - self.warmup_steps
            return self.lr_after.get_lr()
        return float(self.lr_after)


class CosineAnnealingDecay(LRScheduler):
    """eta_min + (base − eta_min)·(1 + cos(π·min(step, T_max)/T_max))/2."""

    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * min(step, self.T_max) / self.T_max)) / 2)
