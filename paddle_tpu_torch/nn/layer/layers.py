"""Layer: the module system (port of the reference's ``nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module`` with the reference's API on top, so a
port layer is at once a paddle layer and a torch module: torch's
optimizers, ``state_dict`` recursion, ``.to()`` and hooks see a module,
and code written for the reference sees its ``Layer``.  Where torch and
the reference spell one method differently, the method takes both:

- ``named_parameters(prefix, include_sublayers)`` and torch's
  ``(prefix, recurse, remove_duplicate)``; ``parameters()`` and
  ``buffers()`` return lists, as the reference's do;
- ``state_dict(destination, include_sublayers, structured_name_prefix)``
  and torch's ``(destination=, prefix=, keep_vars=)``; the names are the
  reference's structured names (``a.b.weight``), which are torch's;
- ``register_buffer(name, tensor, persistable)`` and torch's
  ``persistent=``; ``to(device, dtype, blocking)`` and torch's dtype or
  device as the first argument.

Parameters come from :meth:`Layer.create_parameter`: a ``ParamAttr`` (or
an initializer, a name, ``None``; ``False`` means no parameter and is the
calling layer's to handle) picks the initializer, which draws on the
layer's device from the layer's generator: those given to the layer's
constructor (``device=``, ``generator=``, keyword-only, the port's own),
else those of an enclosing :func:`placement`; without a device, the
generator's, else the default device (the card unless the caller asked
for the CPU); without a generator on that device, the device's global
one (which :func:`~paddle_tpu_torch.framework.random.seed` and
``torch.manual_seed`` seed).  The
parameter carries the attribute's ``optimize_attr``, ``regularizer`` and
``need_clip``, which the optimizers and clips read, and its name as
``param_name`` (a torch tensor's ``name`` is read-only).  A plain tensor
assigned to a layer attribute becomes a non-persistable buffer, as in the
reference.
"""

from __future__ import annotations

import collections
import contextlib
import copy
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...device import resolve_device
from ...framework.param_attr import ParamAttr
from .. import initializer as I

__all__ = ["Layer"]

_layer_name_counters: Dict[str, int] = collections.defaultdict(int)

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64}

# (device, generator) of the innermost ``placement``
_placements: List[Tuple[Optional[torch.device], Optional[torch.Generator]]] = []


def to_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name (``"bfloat16"``) or a numpy
    dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def _to_device(device) -> torch.device:
    """A device from a torch device or a name; paddle's ``gpu``/``gpu:N``
    name the card."""
    if isinstance(device, str) and device.startswith("gpu"):
        device = "cuda" + device[3:]
    return resolve_device(device)


@contextlib.contextmanager
def placement(device=None, generator: Optional[torch.Generator] = None):
    """Layers built inside take ``device`` and ``generator`` where their
    constructor names none (a model's constructor places its whole tree
    with it)."""
    _placements.append((None if device is None else _to_device(device), generator))
    try:
        yield
    finally:
        _placements.pop()


class HookRemoveHelper:
    """The handle a hook registration returns: ``remove()`` takes the
    hook out."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self) -> None:
        self._handle.remove()


class Layer(nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        super().__init__()
        name_scope = name_scope or type(self).__name__.lower()
        _layer_name_counters[name_scope] += 1
        self._full_name = f"{name_scope}_{_layer_name_counters[name_scope] - 1}"
        self._dtype = to_dtype(dtype)
        outer_device, outer_gen = _placements[-1] if _placements else (None, None)
        self._device = outer_device
        self._generator = outer_gen

    def _place(self, device=None, generator: Optional[torch.Generator] = None) -> None:
        """The port's keyword-only ``device``/``generator`` of a layer's
        constructor, over those of the enclosing placement."""
        if device is not None:
            self._device = _to_device(device)
        if generator is not None:
            self._generator = generator

    def _home(self) -> torch.device:
        """The device the layer builds its tensors on: its own, else its
        generator's, else the default device."""
        gen = self._generator
        return resolve_device(self._device if self._device is not None
                              else None if gen is None else gen.device)

    # ------------------------------------------------------------------
    # parameter / buffer / sublayer registration
    # ------------------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias: bool = False,
                         default_initializer=None) -> nn.Parameter:
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            raise ValueError("attr=False is handled by the calling layer (means: no parameter)")
        dtype = to_dtype(dtype) if dtype is not None else self._dtype
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierNormal())
        device, gen = self._home(), self._generator
        if gen is not None and gen.device.type != device.type:
            gen = None   # the device's global generator
        value = init(tuple(int(s) for s in shape), dtype, gen, device)
        p = nn.Parameter(value, requires_grad=bool(attr.trainable))
        # the optimizers read these for lr scaling and the clips for exemption
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        p.is_distributed = False
        p.param_name = attr.name
        return p

    def add_parameter(self, name: str, parameter: Optional[torch.Tensor]
                      ) -> Optional[torch.Tensor]:
        if parameter is not None and not isinstance(parameter, torch.Tensor):
            raise TypeError(f"parameter must be a Tensor, got {type(parameter)}")
        if parameter is not None and not isinstance(parameter, nn.Parameter):
            parameter = nn.Parameter(parameter.detach(), requires_grad=parameter.requires_grad)
        self.register_parameter(name, parameter)
        return parameter

    def register_buffer(self, name: str, tensor: Optional[torch.Tensor],
                        persistable: bool = True, persistent: Optional[bool] = None
                        ) -> Optional[torch.Tensor]:
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(name, tensor,
                                persistent=persistable if persistent is None else persistent)
        return tensor

    def add_sublayer(self, name: str, sublayer: nn.Module) -> nn.Module:
        if not isinstance(sublayer, nn.Module):
            raise TypeError(f"sublayer must be a Layer, got {type(sublayer)}")
        self.add_module(name, sublayer)
        return sublayer

    def __setattr__(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor) and not isinstance(value, nn.Parameter) \
                and "_buffers" in self.__dict__ and name not in self._parameters \
                and name not in self._buffers and name not in self.__dict__:
            # the reference keeps a plain tensor attribute as a buffer
            self.register_buffer(name, value, persistable=False)
            return
        super().__setattr__(name, value)

    def __deepcopy__(self, memo):
        # a Parameter's deepcopy drops its attributes (optimize_attr,
        # need_clip, ...): copy the module, then carry them across
        new = copy._reconstruct(self, memo, *self.__reduce_ex__(4))
        for p in self.parameters():
            if id(p) in memo:
                memo[id(p)].__dict__.update(copy.deepcopy(p.__dict__, memo))
        return new

    # ------------------------------------------------------------------
    # traversal (the reference's spellings and torch's)
    # ------------------------------------------------------------------
    def named_parameters(self, prefix: str = "", include_sublayers: bool = True,
                         remove_duplicate: bool = True, *, recurse: Optional[bool] = None
                         ) -> Iterator[Tuple[str, nn.Parameter]]:
        recurse = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=recurse,
                                        remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers: bool = True, *,
                   recurse: Optional[bool] = None) -> List[nn.Parameter]:
        return [p for _, p in self.named_parameters(include_sublayers=include_sublayers,
                                                    recurse=recurse)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      remove_duplicate: bool = True, *, recurse: Optional[bool] = None
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
        recurse = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix=prefix, recurse=recurse,
                                     remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers: bool = True, *,
                recurse: Optional[bool] = None) -> List[torch.Tensor]:
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers,
                                                 recurse=recurse)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, nn.Module]]:
        for name, layer in self.named_modules(prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [layer for _, layer in self.named_sublayers(include_self=include_self)]

    # ------------------------------------------------------------------
    # state dict
    # ------------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True, *,
                   prefix: Optional[str] = None, keep_vars: Optional[bool] = None):
        if prefix is not None or keep_vars is not None:  # torch's spelling and recursion
            return super().state_dict(destination=destination, prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        # the reference joins the prefix and a name with a dot
        prefix = structured_name_prefix + "." if structured_name_prefix else ""
        out = super().state_dict(destination=destination, prefix=prefix)
        if not include_sublayers:
            own = {prefix + n for n, _ in self.named_parameters(recurse=False)}
            own |= {prefix + n for n, _ in self.named_buffers(recurse=False)}
            for name in [k for k in out if k not in own]:
                del out[name]
        return out

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict``'s tensors or arrays into the parameters and
        persistable buffers of the same names, cast to their dtypes; a shape
        mismatch raises.  Returns ``(missing, unexpected)`` names."""
        own = super().state_dict(keep_vars=True)
        missing, unexpected = [], [k for k in state_dict if k not in own]
        with torch.no_grad():
            for name, t in own.items():
                if name not in state_dict:
                    missing.append(name)
                    continue
                v = state_dict[name]
                if not isinstance(v, torch.Tensor):
                    # floats (bf16 from ml_dtypes included) cross as f32, then cast
                    v = np.asarray(v)
                    v = torch.from_numpy(np.array(v) if v.dtype.kind in "biu"
                                         else np.array(v, dtype=np.float32))
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"shape mismatch for {name!r}: checkpoint "
                                     f"{tuple(v.shape)} vs model {tuple(t.shape)}")
                t.copy_(v.to(device=t.device, dtype=t.dtype))
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ------------------------------------------------------------------
    # dtype / device
    # ------------------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, **kwargs) -> "Layer":
        """Move and/or cast: floating-point parameters and buffers take
        ``dtype``; ``device`` may also be a dtype (torch's ``to(dtype)``)."""
        if isinstance(device, torch.dtype) or (isinstance(device, str)
                                               and device in _DTYPES):
            device, dtype = None, device
        dev = None if device is None else _to_device(device)
        dt = None if dtype is None else to_dtype(dtype)
        super().to(device=dev, dtype=dt,
                   non_blocking=kwargs.pop("non_blocking", blocking is False))
        for layer in self.modules():
            if isinstance(layer, Layer):
                if dt is not None:
                    layer._dtype = dt
                if dev is not None:
                    layer._device = dev
        return self

    def astype(self, dtype) -> "Layer":
        return self.to(dtype=dtype)

    def float(self) -> "Layer":
        return self.to(dtype="float32")

    def half(self) -> "Layer":
        return self.to(dtype="float16")

    def bfloat16(self) -> "Layer":
        return self.to(dtype="bfloat16")

    # ------------------------------------------------------------------
    # hooks
    # ------------------------------------------------------------------
    def register_forward_pre_hook(self, hook: Callable, *, prepend: bool = False,
                                  with_kwargs: bool = False) -> HookRemoveHelper:
        """``hook(layer, inputs)``; a result that is not None replaces the
        inputs (a single value is wrapped in a tuple)."""
        return HookRemoveHelper(super().register_forward_pre_hook(
            hook, prepend=prepend, with_kwargs=with_kwargs))

    def register_forward_post_hook(self, hook: Callable) -> HookRemoveHelper:
        """``hook(layer, inputs, outputs)``; a result that is not None
        replaces the outputs."""
        return HookRemoveHelper(super().register_forward_hook(hook))

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------
    def full_name(self) -> str:
        return self._full_name

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None
