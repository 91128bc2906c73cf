"""Automatic mixed precision (port of the reference's ``amp/__init__.py``):
``auto_cast`` (O1), the loss scalers and ``decorate`` (O2).

O1 is the reference's mechanism, not ``torch.autocast``: ``auto_cast``
pushes its settings on a thread-local stack, and the compute-heavy entry
points the reference casts at ask :func:`maybe_autocast_tensors` for their
inputs: ``F.linear`` and the ring linears of ``mp_layers`` and
``sequence_parallel`` ("linear"), the forward convolutions ("conv"),
``F.scaled_dot_product_attention`` ("sdpa", so bf16 q/k/v on the card reach
B3) and ``paddle.matmul`` ("matmul").  Every other op runs in its inputs'
dtype, as in the reference: torch's own lists would also cast softmax and
the norms, which the reference leaves alone.  ``custom_black_list`` takes
one of those names out; ``custom_white_list`` casts the inputs of a tensor
function of that name in the op funnel (``tensor.apply_op``).  Under the
flag ``use_bf16_default`` (on by default) ``dtype="float16"`` means
bfloat16, as in the reference.

The scalers keep the reference's arithmetic and order: ``scale``
multiplies the loss, the unscale multiplies every gradient by 1/scale in
f32 (back to its dtype) and folds their finiteness into one flag on the
device, read once: one host synchronisation for the whole parameter list.
``step`` skips the update on a non-finite gradient and, as the
reference's, also runs ``update()``.  ``attach_health_guard`` routes each
found-inf skip into a ``distributed.health.HealthGuard``'s skip counter and
anomaly window (``note_scaler_skip``).

O2 (``decorate``) is pure half precision: every floating-point parameter
is cast to the half dtype in place (the Parameter objects stay, so
optimizer lists stay valid), except those of the LayerNorm, batch norm and
GroupNorm layers (the port's and torch's).  As in the reference, RMSNorm
weights are cast too.  Buffers keep their dtype (the f32 rope tables).
Floating-point inputs of the model's forward are cast to the half dtype as
they enter, or the first op's type promotion would run the model in f32.
The optimizers get f32 master weights (``multi_precision``).
``save_dtype`` is accepted and has no effect, as in the reference.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Dict, Optional

import torch

from ..framework.dtype import convert_dtype
from ..framework.flags import get_flags

__all__ = ["auto_cast", "amp_guard", "GradScaler", "AmpScaler", "decorate",
           "is_auto_cast_enabled", "get_amp_dtype", "amp_dtype_if_enabled"]

_state = threading.local()


def _amp_state() -> list:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def is_auto_cast_enabled() -> bool:
    stack = _amp_state()
    return bool(stack) and stack[-1]["enable"]


def get_amp_dtype() -> Optional[torch.dtype]:
    stack = _amp_state()
    return stack[-1]["dtype"] if stack else None


def get_amp_level() -> str:
    stack = _amp_state()
    return stack[-1]["level"] if stack else "O0"


def amp_dtype_if_enabled(op_name: str = "") -> Optional[torch.dtype]:
    """The dtype a white-listed op casts its inputs to, or None."""
    stack = _amp_state()
    if not stack or not stack[-1]["enable"]:
        return None
    st = stack[-1]
    if op_name and op_name in st["custom_black_list"]:
        return None
    return st["dtype"]


def amp_white_listed(op_name: str) -> Optional[torch.dtype]:
    """The cast dtype of an op that is cast only when the user white-lists
    it (``custom_white_list``, read by the op funnel), or None."""
    stack = _amp_state()
    if not stack or not stack[-1]["enable"]:
        return None
    st = stack[-1]
    if op_name in st["custom_white_list"] and op_name not in st["custom_black_list"]:
        return st["dtype"]
    return None


class auto_cast:
    """Mixed precision inside a ``with`` block, or around a function when
    used as a decorator (``paddle.amp.auto_cast``)."""

    def __init__(self, enable: bool = True, custom_white_list=None, custom_black_list=None,
                 level: str = "O1", dtype: str = "bfloat16", use_promote: bool = True):
        if dtype in ("float16", "fp16", "half") and \
                get_flags("use_bf16_default")["use_bf16_default"]:
            dtype = "bfloat16"     # generic "half" is bfloat16 under the flag
        self._cfg = {
            "enable": enable,
            "dtype": convert_dtype(dtype),
            "level": level,
            "custom_white_list": set(custom_white_list or ()),
            "custom_black_list": set(custom_black_list or ()),
        }

    def __enter__(self):
        _amp_state().append(self._cfg)
        return self

    def __exit__(self, *exc):
        _amp_state().pop()

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with self:
                return fn(*a, **k)

        return wrapper


amp_guard = auto_cast


def maybe_autocast_tensors(op_name: str, *tensors):
    """``tensors`` with each floating-point one cast to the active amp dtype
    (the white-listed ops' inputs); as they are outside ``auto_cast``."""
    dt = amp_dtype_if_enabled(op_name)
    if dt is None:
        return tensors
    return tuple(t.to(dt) if isinstance(t, torch.Tensor) and t.is_floating_point()
                 and t.dtype != dt else t for t in tensors)


class AmpScaler:
    """Dynamic loss scaling: scale the loss, unscale the gradients before
    the update, skip the update and shrink the scale (never below 1.0)
    when a gradient holds NaN or Inf, grow it after
    ``incr_every_n_steps`` good steps."""

    def __init__(self, enable: bool = True, init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000, decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._already_unscaled = False
        self._health_guard = None

    def attach_health_guard(self, guard) -> None:
        """Route found-inf skips into a ``distributed.health.HealthGuard``'s
        skip counter and anomaly window (``None`` detaches it)."""
        self._health_guard = guard

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v: float) -> None:
        self._scale = float(v)

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return var
        self._already_unscaled = False
        return var * self._scale

    @torch.no_grad()
    def _unscale(self, optimizer) -> None:
        """Every gradient times 1/scale (in f32, back to its dtype); the
        finiteness of all of them read in one host synchronisation."""
        if not self._enable or self._already_unscaled:
            return
        self._already_unscaled = True
        with_grad = [p for p in optimizer._parameter_list if p.grad is not None]
        if not with_grad:
            self._found_inf = self._maybe_allreduce_found_inf(False)
            return
        inv = 1.0 / self._scale
        home = with_grad[0].grad.device
        finite = []
        for p in with_grad:
            f = p.grad.float() * inv
            finite.append(torch.isfinite(f).all().to(home, non_blocking=True))
            p.grad = f.to(p.grad.dtype)
        found = not bool(torch.stack(finite).all())    # the one host sync
        self._found_inf = self._maybe_allreduce_found_inf(found)
        if self._found_inf and self._health_guard is not None:
            self._health_guard.note_scaler_skip(scale=self._scale)

    def _maybe_allreduce_found_inf(self, found: bool) -> bool:
        """Hook for hybrid-parallel scalers to reduce the flag across groups."""
        return found

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._already_unscaled = False
        self.update()

    def minimize(self, optimizer, *args, **kwargs):
        """Unscale, update unless a gradient is not finite, refresh the
        scale.  The caller has run ``scaled.backward()``; the gradients are
        not cleared."""
        if not self._enable:
            return optimizer.minimize(*args, **kwargs)
        self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._already_unscaled = False
        self.update()

    def update(self) -> None:
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self) -> Dict[str, Any]:
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "incr_count": self._good_steps,
                "decr_count": self._bad_steps, "enable": self._enable,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)

    set_state_dict = load_state_dict


class GradScaler(AmpScaler):
    """``paddle.amp.GradScaler``: the scaler with its own defaults (2**16,
    2000 good steps to grow) and ``unscale_``."""

    def __init__(self, enable: bool = True, init_loss_scaling: float = 2.0 ** 16,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000, decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        super().__init__(enable, init_loss_scaling, incr_ratio, decr_ratio,
                         incr_every_n_steps, decr_every_n_nan_or_inf,
                         use_dynamic_loss_scaling)

    def unscale_(self, optimizer) -> None:
        self._unscale(optimizer)


def _cast(value: Any, dtype: torch.dtype) -> Any:
    """Floating-point tensors in ``value`` (nested in lists, tuples and
    dicts) cast to ``dtype``."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype) if value.is_floating_point() else value
    if isinstance(value, (list, tuple)):
        return type(value)(_cast(v, dtype) for v in value)
    if isinstance(value, dict):
        return {k: _cast(v, dtype) for k, v in value.items()}
    return value


def decorate(models, optimizers=None, level: str = "O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Cast ``models`` for ``level`` O2 and arm master weights on
    ``optimizers`` (unless ``master_weight`` is False).  Returns the
    models (and optimizers) in the shape they were given."""
    from torch import nn

    from ..nn.layer.norm import GroupNorm, LayerNorm, _BatchNormBase

    keep_f32 = (LayerNorm, _BatchNormBase, GroupNorm, nn.LayerNorm,
                nn.modules.batchnorm._BatchNorm, nn.GroupNorm)
    dt = convert_dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for model in model_list:
            for layer in model.modules():
                if isinstance(layer, keep_f32):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p.is_floating_point():
                        p.data = p.data.to(dt)
            model.register_forward_pre_hook(
                lambda _m, args, kwargs: (_cast(args, dt), _cast(kwargs, dt)),
                with_kwargs=True)
    if optimizers is None:
        return model_list[0] if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    for opt in opt_list:
        if master_weight is None or master_weight:
            opt._multi_precision = True
    if single_model and single_opt:
        return model_list[0], opt_list[0]
    return model_list, opt_list
