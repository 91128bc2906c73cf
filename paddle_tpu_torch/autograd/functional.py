"""Higher-order autodiff (port of the reference's ``autograd/functional.py``):
``jacobian``, ``hessian``, ``vjp`` and ``jvp`` over ``torch.func``.

``func`` maps tensors to tensors; a layer's parameters are constants, as
in the reference.  ``jacobian``'s ``mode`` is ``"rev"`` (``jacrev``) or
``"fwd"`` (``jacfwd``, which needs forward-mode rules: a hand kernel's
autograd Function has none); ``batch_axis=0`` gives per-sample Jacobians
(``vmap``).  The results are detached, as the reference's are.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..tensor.tensor import to_tensor

__all__ = ["jacobian", "hessian", "vjp", "jvp"]


def _args(xs) -> Tuple[torch.Tensor, ...]:
    xs = xs if isinstance(xs, (tuple, list)) else (xs,)
    return tuple(x.detach() if isinstance(x, torch.Tensor) else to_tensor(x) for x in xs)


def _detach(out):
    if isinstance(out, torch.Tensor):
        return out.detach()
    if isinstance(out, (tuple, list)):
        return type(out)(_detach(o) for o in out)
    return out


def _argnums(arrays):
    return tuple(range(len(arrays))) if len(arrays) > 1 else 0


def jacobian(ys_or_func, xs=None, batch_axis=None, mode: str = "rev"):
    """The Jacobian of ``func`` at ``xs``: ``jacobian(func, xs)``."""
    if not callable(ys_or_func):
        raise TypeError("jacobian(func, xs): pass the function (the reference's "
                        "ys-tensor form is not supported)")
    if mode not in ("rev", "fwd"):
        raise ValueError(f"mode={mode!r}: 'rev' (jacrev) or 'fwd' (jacfwd)")
    if batch_axis not in (None, 0):
        raise NotImplementedError("batch_axis must be None or 0")
    arrays = _args(xs)
    jac = (torch.func.jacrev if mode == "rev" else torch.func.jacfwd)(
        ys_or_func, argnums=_argnums(arrays))
    if batch_axis == 0:
        jac = torch.func.vmap(jac)
    return _detach(jac(*arrays))


def hessian(ys_or_func, xs=None, batch_axis=None):
    """The Hessian of a scalar-output ``func`` at ``xs``."""
    if not callable(ys_or_func):
        raise TypeError("hessian(func, xs): pass the function")
    if batch_axis not in (None, 0):
        raise NotImplementedError("batch_axis must be None or 0")
    if batch_axis == 0:
        raise NotImplementedError("batched hessian: vmap a per-sample closure")
    arrays = _args(xs)
    with torch.no_grad():
        probe = ys_or_func(*arrays)
    if tuple(probe.shape) not in ((), (1,)):
        raise ValueError("hessian requires a scalar-output function")

    def scalar(*a):
        return ys_or_func(*a).reshape(())

    return _detach(torch.func.hessian(scalar, argnums=_argnums(arrays))(*arrays))


def vjp(func: Callable, xs, v=None):
    """(outputs, the pull-back of ``v`` (ones by default) to ``xs``)."""
    arrays = _args(xs)
    out, pull = torch.func.vjp(func, *arrays)
    cot = torch.ones_like(out) if v is None else v
    grads = pull(cot)
    return _detach(out), _detach(grads[0] if len(arrays) == 1 else grads)


def jvp(func: Callable, xs, v=None):
    """(outputs, the push-forward of ``v`` (ones by default) from ``xs``)."""
    arrays = _args(xs)
    if v is None:
        tangents = tuple(torch.ones_like(a) for a in arrays)
    else:
        vs = v if isinstance(v, (tuple, list)) else (v,)
        tangents = tuple(t if isinstance(t, torch.Tensor) else to_tensor(t) for t in vs)
    out, tangent_out = torch.func.jvp(func, arrays, tangents)
    return _detach(out), _detach(tangent_out)
