"""Autograd (port of the reference's ``autograd/__init__.py``): ``backward``,
``grad``, the grad-mode switches, and ``PyLayer``.

torch's autograd is the tape: the reference's ``autograd/tape.py`` (a vjp
tape over JAX) has no counterpart in the port (ROADMAP §C).  ``grad``
leaves every ``.grad`` as it was (``torch.autograd.grad``) and returns
zeros for an input the outputs do not depend on, unless ``allow_unused``
(then None), as in the reference.  ``PyLayer`` is a ``torch.autograd.Function``
behind the reference's interface: subclass it with static ``forward(ctx,
*args, **kwargs)`` and ``backward(ctx, *grads)``, call ``.apply``; ``ctx``
is a :class:`PyLayerContext` (``save_for_backward`` / ``saved_tensor()``);
``backward`` returns one gradient for each tensor argument, in order
(None for none); a subclass is never instantiated.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "PyLayer", "PyLayerContext", "LegacyPyLayer",
           "jacobian", "hessian", "vjp", "jvp"]

def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    """Turn gradient recording on or off (also a context manager, as
    torch's is)."""
    return torch.set_grad_enabled(bool(mode))


def no_grad(fn: Optional[Callable] = None):
    """A context manager or decorator that records no graph
    (``paddle.no_grad()``, ``@paddle.no_grad``)."""
    return torch.no_grad()(fn) if fn is not None else torch.no_grad()


def enable_grad(fn: Optional[Callable] = None):
    return torch.enable_grad()(fn) if fn is not None else torch.enable_grad()


def _as_list(x):
    return [x] if isinstance(x, torch.Tensor) else list(x)


def backward(tensors, grad_tensors=None, retain_graph: bool = False) -> None:
    """Accumulate the gradients of ``tensors`` (seeded with
    ``grad_tensors``) into the leaves' ``.grad``."""
    tensors = _as_list(tensors)
    if grad_tensors is not None:
        grad_tensors = _as_list(grad_tensors)
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None, create_graph=False,
         only_inputs=True, allow_unused=False, no_grad_vars=None):
    """The gradients of ``outputs`` with respect to ``inputs``, leaving every
    ``.grad`` as it was.  An input the outputs do not depend on (or one that
    does not require grad) gets zeros, or None with ``allow_unused``."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    if grad_outputs is not None:
        grad_outputs = _as_list(grad_outputs)
    live = [t for t in inputs if t.requires_grad]
    got = torch.autograd.grad(outputs, live, grad_outputs, retain_graph=retain_graph,
                              create_graph=create_graph, allow_unused=True) if live else ()
    by_id = {id(t): g for t, g in zip(live, got)}
    results = []
    for t in inputs:
        g = by_id.get(id(t))
        if g is None and not allow_unused:
            g = torch.zeros_like(t)
        results.append(g)
    return results


class PyLayerContext:
    """What ``PyLayer.forward`` and ``backward`` share."""

    def __init__(self):
        self._saved: tuple = ()
        self.attrs: dict = {}

    def save_for_backward(self, *tensors) -> None:
        self._saved = tensors

    def saved_tensor(self):
        return self._saved

    saved_tensors = property(lambda self: self._saved)


class _Bridge(torch.autograd.Function):
    """The torch Function every ``PyLayer.apply`` runs through."""

    @staticmethod
    def forward(tctx, layer, kwargs, *args):
        ctx = PyLayerContext()
        outs = layer.forward(ctx, *args, **kwargs)
        tctx.layer, tctx.pyctx = layer, ctx
        tctx.tensor_args = [isinstance(a, torch.Tensor) for a in args]
        saved = ctx._saved
        if all(s is None or isinstance(s, torch.Tensor) for s in saved):
            # torch keeps saved tensors without a reference cycle through ctx
            tctx.save_for_backward(*saved)
            tctx.n_saved = len(saved)
            ctx._saved = ()
        else:
            tctx.n_saved = None
        return tuple(outs) if isinstance(outs, (tuple, list)) else outs

    @staticmethod
    def backward(tctx, *grads):
        ctx = tctx.pyctx
        if tctx.n_saved is not None:
            ctx._saved = tuple(tctx.saved_tensors)
        with torch.no_grad():
            gins = tctx.layer.backward(ctx, *grads)
        if isinstance(gins, torch.Tensor) or gins is None:
            gins = (gins,)
        gins = iter(gins)
        return (None, None) + tuple(next(gins, None) if is_t else None
                                    for is_t in tctx.tensor_args)


class _PyLayerMeta(type):
    def __call__(cls, *args, **kwargs):
        raise RuntimeError("PyLayer subclasses are used via .apply(), not instantiated")


class PyLayer(metaclass=_PyLayerMeta):
    """A function with its own backward (the reference's ``PyLayer``)."""

    @staticmethod
    def forward(ctx: PyLayerContext, *args: Any, **kwargs: Any):
        raise NotImplementedError

    @staticmethod
    def backward(ctx: PyLayerContext, *grads: Any):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args: Any, **kwargs: Any):
        outs = _Bridge.apply(cls, kwargs, *args)
        return list(outs) if isinstance(outs, list) else outs


class LegacyPyLayer(PyLayer):
    pass


from .functional import hessian, jacobian, jvp, vjp  # noqa: E402,F401
