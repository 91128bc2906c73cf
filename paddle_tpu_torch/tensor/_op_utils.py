"""Shared helpers of the tensor functions (port of the reference's
``tensor/_op_utils.py``).

A Python scalar operand of a binary function becomes a 0-d tensor on the
other operand's device; torch's promotion lets a 0-d tensor keep the other
operand's dtype within its kind (``bf16_tensor + 2.0`` stays bfloat16), as
JAX's weak types do in the reference.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .tensor import apply_op, to_tensor

__all__ = ["ensure_tensor", "unary_op", "binary_op", "nondiff"]


def ensure_tensor(x) -> torch.Tensor:
    """``x`` if it is a tensor, else a new tensor of it on the default
    device."""
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def _scalar_like(v, other: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, device=other.device)


def unary_op(name: str, fn: Callable, differentiable: bool = True):
    def op(x, name_: Any = None, **kwargs):
        x = ensure_tensor(x)
        f = (lambda v: fn(v, **kwargs)) if kwargs else fn
        if differentiable:
            return apply_op(name, f, (x,))
        with torch.no_grad():
            return f(x)

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"Elementwise/unary op `{name}`."
    return op


def binary_op(name: str, fn: Callable, differentiable: bool = True):
    def op(x, y, name_: Any = None):
        xs, ys = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
        if xs and not ys:
            y = _scalar_like(y, x)
        elif ys and not xs:
            x = _scalar_like(x, y)
        elif not (xs or ys):
            x, y = to_tensor(x), to_tensor(y)
        if differentiable:
            return apply_op(name, fn, (x, y))
        with torch.no_grad():
            return fn(x, y)

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"Broadcasting binary op `{name}`."
    return op


def nondiff(name: str, fn: Callable):
    """A function of integer or bool results: computed without a graph."""

    def op(*args, **kwargs):
        args = [ensure_tensor(a) if i == 0 else a for i, a in enumerate(args)]
        with torch.no_grad():
            return fn(*args, **kwargs)

    op.__name__ = name
    return op
