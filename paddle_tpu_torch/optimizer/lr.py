"""Learning-rate schedulers (port of the reference's ``optimizer/lr.py``:
``LRScheduler`` and its 18 schedules).

The same stateful API: ``scheduler.step()`` advances, ``scheduler()`` and
``get_lr()`` read; ``state_dict``/``set_state_dict`` (``set_dict``) carry
the state.  Every schedule is closed-form in ``last_epoch`` but
``MultiplicativeDecay`` (a running product) and ``ReduceOnPlateau``, whose
``step(metrics)`` takes a number or a 0-d tensor (on the card too: it is
read once).  :meth:`LRScheduler.as_fn` gives the schedule as a pure
step-to-lr function, evaluated on the host.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, List, Optional

__all__ = [
    "LRScheduler", "NoamDecay", "ExponentialDecay", "NaturalExpDecay", "InverseTimeDecay",
    "PolynomialDecay", "PiecewiseDecay", "LinearWarmup", "CosineAnnealingDecay",
    "StepDecay", "MultiStepDecay", "LambdaDecay", "ReduceOnPlateau", "MultiplicativeDecay",
    "OneCycleLR", "CyclicLR", "ConstantLR", "LinearLR", "CosineAnnealingWarmRestarts",
]


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.verbose = verbose    # stored, printing nothing, as the reference's
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

    set_dict = set_state_dict

    def as_fn(self) -> Callable[[int], float]:
        """The schedule as a function of the step, on a copy of this
        scheduler (this one does not move)."""
        proto = copy.deepcopy(self)

        def fn(step):
            proto.last_epoch = step
            return proto.get_lr()

        return fn


class NoamDecay(LRScheduler):
    """lr = base * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (reference lr.py NoamDecay)."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * (self.d_model ** -0.5) *
                min(step ** -0.5, step * (self.warmup_steps ** -1.5)))


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** max(self.last_epoch, 0))


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * max(self.last_epoch, 0))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * max(self.last_epoch, 0))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0, cycle=False,
                 last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        if self.cycle:
            div = math.ceil(step / self.decay_steps) if step > 0 else 1
            decay_steps = self.decay_steps * max(div, 1)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr) *
                (1 - step / decay_steps) ** self.power + self.end_lr)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: List[int], values: List[float], last_epoch=-1,
                 verbose=False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        for b, v in zip(self.boundaries, self.values):
            if step < b:
                return v
        return self.values[len(self.boundaries)]


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1,
                 verbose=False):
        self.lr_after = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        if step < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * step / self.warmup_steps
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.last_epoch = step - self.warmup_steps
            return self.lr_after.get_lr()
        return float(self.lr_after)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * min(step, self.T_max) / self.T_max)) / 2)


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0.0, last_epoch=-1, verbose=False):
        self.T_0, self.T_mult, self.eta_min = T_0, T_mult, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        t, ti = step, self.T_0
        while t >= ti:
            t -= ti
            ti *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / ti)) / 2


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1, verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (max(self.last_epoch, 0) // self.step_size))


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1, verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        n = sum(1 for m in self.milestones if step >= m)
        return self.base_lr * (self.gamma ** n)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(max(self.last_epoch, 0))


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class ConstantLR(LRScheduler):
    def __init__(self, learning_rate, factor=1.0 / 3, total_iters=5, last_epoch=-1,
                 verbose=False):
        self.factor, self.total_iters = factor, total_iters
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if max(self.last_epoch, 0) < self.total_iters:
            return self.base_lr * self.factor
        return self.base_lr


class LinearLR(LRScheduler):
    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3, end_factor=1.0,
                 last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor, self.end_factor = start_factor, end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = min(max(self.last_epoch, 0), self.total_steps)
        f = self.start_factor + (self.end_factor - self.start_factor) * step / self.total_steps
        return self.base_lr * f


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10, threshold=1e-4,
                 threshold_mode="rel", cooldown=0, min_lr=0, epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.epsilon = cooldown, min_lr, epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._lr = float(learning_rate)
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self._lr

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            self.last_lr = self._lr
            return
        m = float(metrics)
        if self.best is None or self._is_better(m):
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new_lr = max(self._lr * self.factor, self.min_lr)
            if self._lr - new_lr > self.epsilon:
                self._lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        self.last_lr = self._lr

    def _is_better(self, m):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return m < self.best * (1 - self.threshold)
            return m < self.best - self.threshold
        if self.threshold_mode == "rel":
            return m > self.best * (1 + self.threshold)
        return m > self.best + self.threshold


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, anneal_strategy="cos",
                 three_phase=False, last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.up_steps = int(phase_pct * total_steps)
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        step = min(max(self.last_epoch, 0), self.total_steps)
        if step <= self.up_steps:
            pct = step / max(self.up_steps, 1)
            return self.initial_lr + (self.max_lr - self.initial_lr) * \
                (1 - math.cos(math.pi * pct)) / 2
        pct = (step - self.up_steps) / max(self.total_steps - self.up_steps, 1)
        return self.end_lr + (self.max_lr - self.end_lr) * (1 + math.cos(math.pi * pct)) / 2


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up, step_size_down=None,
                 mode="triangular", exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        cycle_len = self.up + self.down
        cycle = step // cycle_len
        pos = step - cycle * cycle_len
        if pos <= self.up:
            pct = pos / self.up
        else:
            pct = 1 - (pos - self.up) / self.down
        scale = {"triangular": 1.0,
                 "triangular2": 1.0 / (2 ** cycle),
                 "exp_range": self.exp_gamma ** step}[self.mode]
        return self.base_lr + (self.max_lr - self.base_lr) * pct * scale
