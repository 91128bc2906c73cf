"""Optimizers (port of the reference's ``optimizer/__init__.py``):
``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adamax``,
``Adagrad``, ``Adadelta``, ``RMSProp``, ``Lamb``, ``L1Decay`` and ``L2Decay``.

The reference's API: an explicit ``parameters`` list, per-parameter
accumulators, ``grad_clip``, an ``LRScheduler`` or a float learning rate
(``set_lr``, ``set_lr_scheduler``), ``minimize`` (the update from the
gradients ``backward`` left, which it does not clear), and ``state_dict``
keys ``<name>.<slot>`` (``moment1``, ``velocity``, ``moment2_max``, ...),
``<name>.@t``, ``<name>.master_weight`` and ``@step``.  ``step()`` reads
each parameter's ``.grad``.  With ``multi_precision`` (set by
``amp.decorate``) a bf16 or fp16 parameter keeps an f32 master weight: its
gradient is cast to f32 before the clip, the update runs on the master,
and the parameter receives the master cast back.

``weight_decay`` is a float (L2) or an ``L2Decay``/``L1Decay``: every rule
but AdamW's decoupled decay and Lamb's adds it to the gradient
(``g + c·p``, or ``g + c·sign(p)`` for L1), and leaves out a parameter
whose ``ParamAttr`` names a ``regularizer``, as the reference does.

Parameters are named as in the reference, ``param.name`` or
``param_<i>``; ``parameters`` may also be ``(name, param)`` pairs (as
``model.named_parameters()`` yields), which name them.  The update rules
keep the reference's arithmetic order.  With ``use_fused_adamw`` on, Adam
and AdamW run the one-sweep AdamW (B5: the hand kernel on CUDA tensors,
its plain twin on CPU ones), which updates the master weight (or the f32
parameter) and both moments IN PLACE; so, as with ``torch.optim``, a
``state_dict`` holds live tensors: save or clone it before the next step.
``amsgrad=True`` keeps ``moment2_max`` and takes the plain path, as in the
reference; ``lazy_mode`` and ``use_multi_tensor`` are accepted and change
nothing, as there.  The other rules are plain PyTorch on the tensors, as
the reference leaves them to XLA.

Each gradient is cast to its update's dtype when its turn comes, and the
global-norm clip reads every cast gradient once for the norm before the
updates: the arithmetic and its order are the reference's, and at most one
parameter's f32 gradient copy is alive at a time (27 GB fewer at
Llama-2-7B's full depth).  ZeRO offload (``DistributedTrainStep(offload=
True)``) holds the masters and moments in pinned host memory
(``_host_arena``): the update runs B5 with the gradient on the card and
the states on the host, and B5 also writes the new value into the card's
parameter; ``set_state_dict`` copies into the pinned tensors.  Any other
rule given offloaded states raises.  Lamb's trust ratio is taken over the
whole parameter: under a ZeRO layout on one controller over all its
blocks; a ZeRO split across processes refuses Lamb.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..framework.flags import get_flags
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from ..ops.fused_ln_swiglu import fused_adamw
from . import lr as lr_module
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb", "lr", "L1Decay", "L2Decay"]

lr = lr_module

_HALF = (torch.bfloat16, torch.float16)


class L2Decay:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)


class Optimizer:
    """Base optimizer.  State: ``_accumulators[id(param)][slot]`` and
    ``_master_weights[id(param)]``, exposed by ``state_dict`` under the
    parameters' names."""

    _slot_names: Tuple[str, ...] = ()
    _whole_tensor = False       # the rule reads the whole parameter (Lamb's norms)

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
        if isinstance(weight_decay, (L2Decay, L1Decay)):
            self._weight_decay = weight_decay.coeff
            self._decay_mode = "l1" if isinstance(weight_decay, L1Decay) else "l2"
        else:
            self._weight_decay = float(weight_decay) if weight_decay else 0.0
            self._decay_mode = "l2"
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: Dict[int, Dict[str, Any]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        # id(param) -> (dim, n): its slots and master are held as n member
        # blocks along dim, stacked [n, *block] (a DistributedTrainStep's
        # ZeRO layout); state_dict shows them in the parameter's layout
        self._layouts: Dict[int, Tuple[int, int]] = {}
        # ZeRO offload: the pinned host block holding the masters and slots
        self._host_arena = None
        self._step_count = 0

    # -- lr ------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler; call "
                               "scheduler.step() instead")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler) -> None:
        self._learning_rate = scheduler

    # -- state ----------------------------------------------------------
    def _has_master(self, p: torch.Tensor) -> bool:
        return self._multi_precision and p.dtype in _HALF

    def _update_dtype(self, p: torch.Tensor) -> torch.dtype:
        """The dtype the update of ``p`` runs in (its master's, or its own)."""
        return torch.float32 if self._has_master(p) else p.dtype

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

    def _slot_init(self, slot: str) -> float:
        """The value a slot starts at."""
        return 0.0

    def _init_state(self, p: torch.Tensor) -> Dict[str, Any]:
        st: Dict[str, Any] = {s: torch.full_like(self._master(p), self._slot_init(s))
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
                     lr: float, param: torch.Tensor, out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(new value of ``p``, new slots) from the gradient ``g``; ``out``
        (an offloaded master's parameter on the card) also receives the new
        value in its dtype."""
        raise NotImplementedError

    def _coupled_decay(self, p: torch.Tensor, g: torch.Tensor,
                       param: Optional[torch.Tensor]) -> torch.Tensor:
        """``g`` with the coupled decay added: L2 ``g + c·p``, L1
        ``g + c·sign(p)``; a parameter with a ``regularizer`` is left out."""
        if self._weight_decay and getattr(param, "regularizer", None) is None:
            if self._decay_mode == "l2":
                return g + self._weight_decay * p
            return g + self._weight_decay * torch.sign(p)
        return g

    @staticmethod
    def _resident(p: torch.Tensor, g: torch.Tensor, state: Dict[str, Any],
                  out: Optional[torch.Tensor]) -> None:
        """Raise if the states lie in host memory (ZeRO offload), which only
        B5 updates."""
        if out is not None or any(isinstance(t, torch.Tensor) and t.device != g.device
                                  for t in (p, *state.values())):
            raise RuntimeError(
                "optimizer states offloaded to host memory are updated by the fused "
                "AdamW kernel (B5) only: use AdamW or Adam with use_fused_adamw, or turn "
                "offload off")

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
        base_lr = self.get_lr()
        for p, g in self._clipped(params_grads):
            lr_mult = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
            self._update_param(p, g, base_lr * lr_mult)
        self._step_count += 1

    def _clipped(self, params_grads):
        """``(p, g)`` in order, each gradient cast to its update's dtype and
        clipped, cast only when its turn comes (a global-norm clip takes its
        norm over the cast gradients first, one at a time)."""
        def cast(p, g):
            return g if g is None else g.to(self._update_dtype(p))

        clip = self._grad_clip
        if clip is None:
            return ((p, cast(p, g)) for p, g in params_grads)
        if not isinstance(clip, ClipGradByGlobalNorm):
            return iter(clip([(p, cast(p, g)) for p, g in params_grads]))
        scale = clip.global_scale((p, cast(p, g)) for p, g in params_grads)
        return ((p, clip.scaled(p, cast(p, g), scale)) for p, g in params_grads)

    def _update_param(self, p: torch.Tensor, g: torch.Tensor, lr: float) -> None:
        """One update of ``p`` whole; an offloaded master (on the host) has
        the kernel write ``p`` on the card."""
        st = self._state_for(p)
        work = self._master(p)
        out = p if work.device != p.device else None
        new_p, new_state = self._update_rule(work, g, st, lr, p, out=out)
        held = self._host_arena is not None     # offloaded states keep their place
        for k, v in new_state.items():
            if held and isinstance(v, torch.Tensor) and st[k] is not v:
                st[k].copy_(v)
            else:
                st[k] = v
        if self._has_master(p):
            if held and new_p is not work:
                work.copy_(new_p)
            else:
                self._master_weights[id(p)] = new_p
        if out is None:
            p.copy_(new_p)

    def minimize(self, loss=None, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The update from the gradients ``loss.backward()`` left; they are
        not cleared (the reference's contract)."""
        self.step()
        return None, None

    @torch.no_grad()
    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameter_list:
            if p.grad is not None and set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- checkpointing ------------------------------------------------
    def _global(self, p: torch.Tensor, v: Any) -> Any:
        """A slot or master in ``p``'s own layout."""
        if id(p) not in self._layouts or not isinstance(v, torch.Tensor):
            return v
        dim, _ = self._layouts[id(p)]
        return torch.cat(v.unbind(0), dim)

    def _blocked(self, p: torch.Tensor, v: Any, held: Any = None) -> torch.Tensor:
        """A loaded slot or master on ``p``'s device, in its held layout;
        with offload, copied into ``held`` (the tensor it replaces, in the
        host arena)."""
        v = torch.as_tensor(v, device=p.device)
        if id(p) in self._layouts:
            dim, n = self._layouts[id(p)]
            v = torch.stack(v.chunk(n, dim)).contiguous()
        if self._host_arena is not None and isinstance(held, torch.Tensor):
            return held.copy_(v)
        return v

    def state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for p in self._parameter_list:
            key = self._names[id(p)]
            # a never-stepped parameter shows its default slots, uncached
            st = self._accumulators.get(id(p))
            if st is None and p.requires_grad:
                st = self._init_state(p)
            for slot, v in (st or {}).items():
                out[f"{key}.{slot}"] = self._global(p, v)
            mw = self._master_weights.get(id(p))
            if mw is not None:
                out[f"{key}.master_weight"] = self._global(p, mw)
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
                held = self._accumulators.get(id(p), {})
                self._accumulators[id(p)] = {
                    k: v if isinstance(v, int) else self._blocked(p, v, held.get(k))
                    for k, v in st.items()}
            mw = state.get(f"{key}.master_weight")
            if mw is not None:
                self._master_weights[id(p)] = self._blocked(
                    p, mw, self._master_weights.get(id(p)))
        if "LR_Scheduler" in state and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        self._step_count = int(state.get("@step", 0))


class SGD(Optimizer):
    """``p - lr·g``, with the coupled decay."""

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update_rule(self, p, g, state, lr, param, out=None):
        self._resident(p, g, state, out)
        g = self._coupled_decay(p, g, param)
        return p - lr * g, {}


class Momentum(Optimizer):
    """Heavy-ball momentum: ``v = μ·v + g``, ``p - lr·v``; Nesterov's
    ``p - lr·(g + μ·v)``."""

    _slot_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _update_rule(self, p, g, state, lr, param, out=None):
        self._resident(p, g, state, out)
        g = self._coupled_decay(p, g, param)
        v = self._momentum * state["velocity"] + g
        if self._use_nesterov:
            new_p = p - lr * (g + self._momentum * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}


class Adam(Optimizer):
    """Adam with the coupled decay; ``amsgrad`` divides by the running
    maximum of the second moment (``moment2_max``)."""

    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = amsgrad
        if amsgrad:
            self._slot_names = ("moment1", "moment2", "moment2_max")

    def _decoupled(self) -> bool:
        return False

    def _should_decay(self, param: Optional[torch.Tensor]) -> bool:
        return bool(self._weight_decay)

    def _update_rule(self, p, g, state, lr, param, out=None):
        offloaded = out is not None or any(
            isinstance(t, torch.Tensor) and t.device != g.device for t in (p, *state.values()))
        if offloaded and not self._decoupled() and self._weight_decay:
            raise NotImplementedError(
                "offloaded optimizer states take the decoupled update (AdamW) only: "
                "Adam's coupled decay would read the master on the host")
        if not self._decoupled():
            g = self._coupled_decay(p, g, param)
        t = state["@t"] + 1
        b1, b2 = self._beta1, self._beta2
        if get_flags("use_fused_adamw")["use_fused_adamw"] and not self._amsgrad:
            # one sweep, p, m and v in place (the reference returns new
            # arrays): three f32 copies of every parameter fewer a step;
            # lr and the bias corrections in f32, as the reference's kernel
            decay = self._decoupled() and self._should_decay(param)
            m, v = state["moment1"].float(), state["moment2"].float()
            fused_adamw(p, g, m, v, lr, t, b1, b2, self._epsilon,
                        self._weight_decay, decay, out=out)
            return p, {"moment1": m, "moment2": v, "@t": t}
        if offloaded:
            raise RuntimeError(
                "optimizer states offloaded to host memory are updated by the fused "
                "AdamW kernel (B5) only: set use_fused_adamw (without amsgrad), or turn "
                "offload off")
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g.square()
        mhat = m / (1 - b1 ** t)
        if self._amsgrad:
            prev = state.get("moment2_max")
            vmax = v if prev is None else torch.maximum(prev, v)
            vhat = vmax / (1 - b2 ** t)
        else:
            vhat = v / (1 - b2 ** t)
        new_p = p - lr * mhat / (vhat.sqrt() + self._epsilon)
        if self._decoupled() and self._should_decay(param):
            new_p = new_p - lr * self._weight_decay * p
        new_state = {"moment1": m, "moment2": v, "@t": t}
        if self._amsgrad:
            new_state["moment2_max"] = vmax
        return new_p, new_state


class AdamW(Adam):
    """Adam with decoupled weight decay.  ``apply_decay_param_fun(name)``
    exempts parameters by name; ``lr_ratio(param)`` scales a parameter's
    learning rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, amsgrad=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decoupled(self) -> bool:
        return True

    def _update_rule(self, p, g, state, lr, param, out=None):
        if self._lr_ratio is not None:
            lr = lr * float(self._lr_ratio(param))
        return super()._update_rule(p, g, state, lr, param, out=out)

    def _should_decay(self, param):
        if not self._weight_decay:
            return False
        if self._apply_decay_param_fun is not None:
            return bool(self._apply_decay_param_fun(self._names[id(param)]))
        return True


class Adamax(Optimizer):
    """Adam with the infinity norm: ``u = max(β2·u, |g|)``."""

    _slot_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, False, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update_rule(self, p, g, state, lr, param, out=None):
        self._resident(p, g, state, out)
        g = self._coupled_decay(p, g, param)
        t = state["@t"] + 1
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], g.abs())
        new_p = p - (lr / (1 - self._beta1 ** t)) * m / (u + self._epsilon)
        return new_p, {"moment": m, "inf_norm": u, "@t": t}


class Adagrad(Optimizer):
    """``G += g²``, ``p - lr·g / (√G + ε)``; ``G`` starts at
    ``initial_accumulator_value``."""

    _slot_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, False, name)
        self._epsilon = epsilon
        self._init_value = initial_accumulator_value

    def _slot_init(self, slot: str) -> float:
        return float(self._init_value)

    def _init_state(self, p):
        return {"moment": torch.full_like(self._master(p), self._slot_init("moment"))}

    def _update_rule(self, p, g, state, lr, param, out=None):
        self._resident(p, g, state, out)
        g = self._coupled_decay(p, g, param)
        mom = state["moment"] + g.square()
        return p - lr * g / (mom.sqrt() + self._epsilon), {"moment": mom}


class Adadelta(Optimizer):
    """Running averages of g² and of the update's square scale the step."""

    _slot_names = ("avg_sq_grad", "avg_sq_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, False, name)
        self._epsilon, self._rho = epsilon, rho

    def _update_rule(self, p, g, state, lr, param, out=None):
        self._resident(p, g, state, out)
        g = self._coupled_decay(p, g, param)
        asg = self._rho * state["avg_sq_grad"] + (1 - self._rho) * g.square()
        update = g * (state["avg_sq_update"] + self._epsilon).sqrt() / \
            (asg + self._epsilon).sqrt()
        asu = self._rho * state["avg_sq_update"] + (1 - self._rho) * update.square()
        return p - lr * update, {"avg_sq_grad": asg, "avg_sq_update": asu}


class RMSProp(Optimizer):
    """``ms = ρ·ms + (1-ρ)·g²`` (``centered``: minus the square of the
    running mean gradient), with momentum on ``lr·g / √(… + ε)``."""

    _slot_names = ("mean_square", "mean_grad", "momentum")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, False, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update_rule(self, p, g, state, lr, param, out=None):
        self._resident(p, g, state, out)
        g = self._coupled_decay(p, g, param)
        ms = self._rho * state["mean_square"] + (1 - self._rho) * g.square()
        if self._centered:
            mg = self._rho * state["mean_grad"] + (1 - self._rho) * g
            denom = (ms - mg.square() + self._epsilon).sqrt()
        else:
            mg = state["mean_grad"]
            denom = (ms + self._epsilon).sqrt()
        mom = self._momentum * state["momentum"] + lr * g / denom
        return p - mom, {"mean_square": ms, "mean_grad": mg, "momentum": mom}


class Lamb(Optimizer):
    """Adam's direction plus ``lamb_weight_decay·p``, scaled by the trust
    ratio ‖p‖ / ‖update‖ (1 where either is 0) over the whole parameter's
    f32 master; ``exclude_from_weight_decay_fn(param)`` exempts one."""

    _slot_names = ("moment1", "moment2")
    _whole_tensor = True

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_rule(self, p, g, state, lr, param, out=None):
        self._resident(p, g, state, out)
        t = state["@t"] + 1
        m = self._beta1 * state["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * state["moment2"] + (1 - self._beta2) * g.square()
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        r = mhat / (vhat.sqrt() + self._epsilon)
        decay = self._weight_decay
        if self._exclude_fn is not None and param is not None and self._exclude_fn(param):
            decay = 0.0
        update = r + decay * p
        w_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        return p - lr * trust * update, {"moment1": m, "moment2": v, "@t": t}
