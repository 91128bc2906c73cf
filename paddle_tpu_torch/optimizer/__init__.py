"""Optimizers (port of the reference's ``optimizer/__init__.py``:
``Optimizer``, ``Adam``, ``AdamW``).

The reference's API: an explicit ``parameters`` list, per-parameter
accumulators, ``grad_clip``, an ``LRScheduler`` or a float learning rate,
and ``state_dict`` keys ``<name>.moment1``, ``<name>.moment2``,
``<name>.@t``, ``<name>.master_weight`` and ``@step``.  ``step()`` reads
each parameter's ``.grad``.  With ``multi_precision`` (set by
``amp.decorate``) a bf16 or fp16 parameter keeps an f32 master weight: its
gradient is cast to f32 before the clip, the update runs on the master,
and the parameter receives the master cast back.

Parameters are named as in the reference, ``param.name`` or
``param_<i>``; ``parameters`` may also be ``(name, param)`` pairs (as
``model.named_parameters()`` yields), which name them.  The update rules
keep the reference's arithmetic order.  With ``use_fused_adamw`` on, Adam
and AdamW run the one-sweep AdamW (B5: the hand kernel on CUDA tensors,
its plain twin on CPU ones), which updates the master weight (or the f32
parameter) and both moments IN PLACE; so, as with ``torch.optim``, a
``state_dict`` holds live tensors: save or clone it before the next step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..framework.flags import get_flags
from ..ops.fused_ln_swiglu import fused_adamw
from . import lr as lr_module
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]

lr = lr_module

_HALF = (torch.bfloat16, torch.float16)


class Optimizer:
    """Base optimizer.  State: ``_accumulators[id(param)][slot]`` and
    ``_master_weights[id(param)]``, exposed by ``state_dict`` under the
    parameters' names."""

    _slot_names: Tuple[str, ...] = ()

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision: bool = False, name=None):
        if parameters is None:
            raise ValueError("optimizers need an explicit parameters= list, "
                             "e.g. parameters=model.parameters()")
        self._parameter_list: List[torch.Tensor] = []
        self._names: Dict[int, str] = {}
        for i, item in enumerate(parameters):
            pname, p = item if isinstance(item, tuple) else (None, item)
            self._parameter_list.append(p)
            self._names[id(p)] = pname or getattr(p, "name", None) or f"param_{i}"
        self._learning_rate = learning_rate
        self._weight_decay = float(weight_decay) if weight_decay else 0.0
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: Dict[int, Dict[str, Any]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    # -- state ----------------------------------------------------------
    def _has_master(self, p: torch.Tensor) -> bool:
        return self._multi_precision and p.dtype in _HALF

    def _master(self, p: torch.Tensor) -> torch.Tensor:
        """The tensor the update runs on: the f32 master weight of a half
        parameter under ``multi_precision`` (made at first use), else the
        parameter itself."""
        if not self._has_master(p):
            return p
        mw = self._master_weights.get(id(p))
        if mw is None:
            mw = self._master_weights[id(p)] = p.detach().float()
        return mw

    def _init_state(self, p: torch.Tensor) -> Dict[str, Any]:
        st: Dict[str, Any] = {s: torch.zeros_like(self._master(p))
                              for s in self._slot_names}
        st["@t"] = 0
        return st

    def _state_for(self, p: torch.Tensor) -> Dict[str, Any]:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._init_state(p)
        return st

    # -- core step --------------------------------------------------------
    def _update_rule(self, p: torch.Tensor, g: torch.Tensor, state: Dict[str, Any],
                     lr: float, param: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(new value of ``p``, new slots) from the gradient ``g``."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self) -> None:
        """Update every parameter that has a ``.grad``."""
        self._apply([(p, p.grad) for p in self._parameter_list
                     if p.requires_grad and p.grad is not None])

    @torch.no_grad()
    def _apply(self, params_grads: List[Tuple[torch.Tensor, torch.Tensor]]) -> None:
        """Cast each gradient to its update's dtype (f32 for a master
        weight), clip, and update.  ``jit.TrainStep`` calls this with its
        merged f32 gradients."""
        params_grads = [(p, g.to(self._master(p).dtype)) for p, g in params_grads]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        base_lr = self.get_lr()
        for p, g in params_grads:
            lr_mult = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
            st = self._state_for(p)
            new_p, new_state = self._update_rule(self._master(p), g, st,
                                                 base_lr * lr_mult, p)
            st.update(new_state)
            if self._has_master(p):
                self._master_weights[id(p)] = new_p
            p.copy_(new_p)
        self._step_count += 1

    @torch.no_grad()
    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameter_list:
            if p.grad is not None and set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None


    # -- checkpointing ------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for p in self._parameter_list:
            key = self._names[id(p)]
            # a never-stepped parameter shows its default slots, uncached
            st = self._accumulators.get(id(p))
            if st is None and p.requires_grad:
                st = self._init_state(p)
            for slot, v in (st or {}).items():
                out[f"{key}.{slot}"] = v
            mw = self._master_weights.get(id(p))
            if mw is not None:
                out[f"{key}.master_weight"] = mw
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state: Dict[str, Any]) -> None:
        for p in self._parameter_list:
            key = self._names[id(p)]
            st = {slot: state[f"{key}.{slot}"] for slot in self._slot_names + ("@t",)
                  if f"{key}.{slot}" in state}
            if st:
                self._accumulators[id(p)] = {
                    k: v if isinstance(v, int) else torch.as_tensor(v, device=p.device)
                    for k, v in st.items()}
            mw = state.get(f"{key}.master_weight")
            if mw is not None:
                self._master_weights[id(p)] = torch.as_tensor(mw, device=p.device)
        if "LR_Scheduler" in state and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        self._step_count = int(state.get("@step", 0))


class Adam(Optimizer):
    """Adam with L2 weight decay coupled into the gradient."""

    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _decoupled(self) -> bool:
        return False

    def _should_decay(self, param: Optional[torch.Tensor]) -> bool:
        return bool(self._weight_decay)

    def _update_rule(self, p, g, state, lr, param):
        if not self._decoupled() and self._weight_decay:
            g = g + self._weight_decay * p
        t = state["@t"] + 1
        b1, b2 = self._beta1, self._beta2
        if get_flags("use_fused_adamw")["use_fused_adamw"]:
            # one sweep, p, m and v in place (the reference returns new
            # arrays): three f32 copies of every parameter fewer a step;
            # lr and the bias corrections in f32, as the reference's kernel
            decay = self._decoupled() and self._should_decay(param)
            m, v = state["moment1"].float(), state["moment2"].float()
            fused_adamw(p, g, m, v, lr, t, b1, b2, self._epsilon,
                        self._weight_decay, decay)
            return p, {"moment1": m, "moment2": v, "@t": t}
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g.square()
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        new_p = p - lr * mhat / (vhat.sqrt() + self._epsilon)
        if self._decoupled() and self._should_decay(param):
            new_p = new_p - lr * self._weight_decay * p
        return new_p, {"moment1": m, "moment2": v, "@t": t}


class AdamW(Adam):
    """Adam with decoupled weight decay.  ``apply_decay_param_fun(name)``
    exempts parameters by name; ``lr_ratio(param)`` scales a parameter's
    learning rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision, name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decoupled(self) -> bool:
        return True

    def _update_rule(self, p, g, state, lr, param):
        if self._lr_ratio is not None:
            lr = lr * float(self._lr_ratio(param))
        return super()._update_rule(p, g, state, lr, param)

    def _should_decay(self, param):
        if not self._weight_decay:
            return False
        if self._apply_decay_param_fun is not None:
            return bool(self._apply_decay_param_fun(self._names[id(param)]))
        return True
