"""The tensor (port of the reference's ``tensor/tensor.py``).

The reference's ``Tensor`` is its own class over ``jax.Array`` with an
eager tape.  In the port, ``Tensor`` IS ``torch.Tensor``: no subclass and no
``__torch_function__``, so every module of the port takes and returns plain
torch tensors, the hand kernels take them without unwrapping, and torch's
autograd is the tape (ROADMAP §C).  The reference's tensor attributes that
torch lacks are attached to ``torch.Tensor`` once, when this module is
imported:

- ``stop_gradient``: the inverse of ``requires_grad``.  Setting it False on
  a leaf makes the leaf require grad (an integer or bool leaf never
  requires grad and is left as it is); on a tensor computed from ones that
  require grad it keeps the tensor's ``.grad`` (``retain_grad``), as the
  reference fills ``.grad`` of such a tensor.  Setting it True on such a
  tensor raises: torch cannot cut a graph in place, ``x = x.detach()`` does;
- ``place`` (a :class:`~paddle_tpu_torch.device.Place`), ``clear_grad`` /
  ``clear_gradient``, ``gradient()`` (the grad as a numpy array),
  ``astype`` / ``cast`` and ``set_value``.

Methods that torch already has keep torch's meaning (``transpose``, ``max``
and ``min`` with an axis, ``split``, ``numpy()`` on a card tensor or one
that requires grad, ``shape`` a ``torch.Size``, ...); the list is
``METHOD_DEPARTURES`` in ``tests/test_torch_signatures.py``.  The free
functions (``paddle.transpose(x, perm)``, ``paddle.max(x, axis)``,
``paddle.split(x, n, axis)``) take the reference's signatures.

:func:`apply_op` is the funnel of the tensor functions: it casts the inputs
of an op that ``amp.auto_cast``'s ``custom_white_list`` names, runs the
function (torch records the graph) and, with the ``check_nan_inf`` flag on,
raises ``FloatingPointError`` on a non-finite floating output, as the
reference's eager ops do.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..device import Place, resolve_device
from ..framework.dtype import convert_dtype
from ..framework.flags import get_flags

__all__ = ["Tensor", "to_tensor", "is_tensor", "apply_op", "unwrap", "wrap"]

Tensor = torch.Tensor


def _maybe_check_nan(name: str, out) -> None:
    if not get_flags("check_nan_inf")["check_nan_inf"]:
        return
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) \
                and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"NaN/Inf detected in output of op {name!r}")


def apply_op(name: str, fn: Callable, tensor_inputs: Sequence[torch.Tensor],
             multi_out: bool = False):
    """``fn(*tensor_inputs)``, checked for NaN/Inf under ``check_nan_inf``;
    a tuple when ``multi_out`` or when ``fn`` returns several tensors.  An
    op ``name`` on ``amp.auto_cast``'s ``custom_white_list`` gets its
    floating-point inputs in the amp dtype."""
    from ..amp import amp_white_listed

    wl_dtype = amp_white_listed(name)
    if wl_dtype is not None:
        tensor_inputs = [t.to(wl_dtype) if isinstance(t, torch.Tensor) and t.is_floating_point()
                         and t.dtype != wl_dtype else t for t in tensor_inputs]
    out = fn(*tensor_inputs)
    _maybe_check_nan(name, out)
    if multi_out or isinstance(out, (tuple, list)):
        return tuple(out)
    return out


def unwrap(x):
    """The reference's Tensor→array step: a port tensor is its own array,
    so ``x`` is returned as it is."""
    return x


def wrap(x, stop_gradient: bool = True):
    """numpy arrays (nested in lists, tuples and dicts) as host tensors;
    tensors and other values as they are."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(
            not stop_gradient and x.dtype.kind in "fc")
    if isinstance(x, (list, tuple)):
        return type(x)(wrap(v, stop_gradient) for v in x)
    if isinstance(x, dict):
        return {k: wrap(v, stop_gradient) for k, v in x.items()}
    return x


def _requires_grad_ok(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True) -> torch.Tensor:
    """``paddle.to_tensor``: a new leaf tensor holding a copy of ``data`` on
    ``place`` (a tensor's own device when ``data`` is a tensor and no place
    is given, else the default device: the card unless the caller asked for
    the CPU)."""
    dt = None if dtype is None else convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        dev = data.device if place is None else resolve_device(place)
        t = data.detach().to(device=dev, dtype=dt or data.dtype, copy=True)
    else:
        dev = resolve_device(place)
        if isinstance(data, (list, tuple)) and any(isinstance(d, torch.Tensor) for d in data):
            data = [d.detach().cpu() if isinstance(d, torch.Tensor) else d for d in data]
            t = torch.stack([torch.as_tensor(d) for d in data]).to(device=dev, dtype=dt)
        else:
            t = torch.tensor(np.asarray(data) if isinstance(data, np.generic) else data,
                             dtype=dt, device=dev)
    if not stop_gradient and _requires_grad_ok(t):
        t.requires_grad_(True)
    return t


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


# ---------------------------------------------------------------------------
# the reference's tensor attributes that torch lacks
# ---------------------------------------------------------------------------
def _get_stop_gradient(self) -> bool:
    return not self.requires_grad


def _set_stop_gradient(self, value: bool) -> None:
    value = bool(value)
    if self.is_leaf:
        if value or _requires_grad_ok(self):
            self.requires_grad_(not value)
    elif not value:
        self.retain_grad()
    else:
        raise RuntimeError(
            "stop_gradient=True on a tensor computed from tensors that require grad: "
            "torch cannot cut the graph in place; use x = x.detach()")


def _clear_grad(self) -> None:
    self.grad = None


def _gradient(self):
    g = self.grad
    if g is None:
        return None
    g = g.detach()
    return (g.float() if g.dtype == torch.bfloat16 else g).cpu().numpy()


def _astype(self, dtype) -> torch.Tensor:
    return self.to(convert_dtype(dtype))


def _set_value(self, value) -> None:
    v = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    if tuple(v.shape) != tuple(self.shape):
        raise ValueError(f"set_value shape mismatch: {tuple(v.shape)} vs {tuple(self.shape)}")
    with torch.no_grad():
        self.copy_(v)


_ATTRIBUTES = {
    "stop_gradient": property(_get_stop_gradient, _set_stop_gradient),
    "place": property(lambda self: Place(self.device)),
    "clear_grad": _clear_grad,
    "clear_gradient": _clear_grad,
    "gradient": _gradient,
    "astype": _astype,
    "cast": _astype,
    "set_value": _set_value,
}


def _install() -> None:
    for name, value in _ATTRIBUTES.items():
        if name not in vars(torch.Tensor):
            setattr(torch.Tensor, name, value)


_install()
