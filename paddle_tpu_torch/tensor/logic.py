"""Comparison and logical functions (port of the reference's
``tensor/logic.py``): bool results, outside any graph."""

from __future__ import annotations

import torch

from ._op_utils import ensure_tensor
from .tensor import to_tensor

__all__ = ["equal", "not_equal", "greater_than", "greater_equal", "less_than",
           "less_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
           "is_empty", "is_complex", "is_floating_point", "is_integer"]


def _operands(x, y):
    xs, ys = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
    if xs and not ys:
        y = torch.as_tensor(y, device=x.device)
    elif ys and not xs:
        x = torch.as_tensor(x, device=y.device)
    elif not (xs or ys):
        x, y = to_tensor(x), to_tensor(y)
    return x, y


def _cmp(name, fn):
    def op(x, y, name_=None):
        x, y = _operands(x, y)
        with torch.no_grad():
            return fn(x, y)

    op.__name__ = name
    op.__qualname__ = name
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)


def logical_not(x, out=None, name=None):
    return torch.logical_not(ensure_tensor(x))


def is_empty(x, name=None):
    x = ensure_tensor(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def is_complex(x) -> bool:
    return ensure_tensor(x).is_complex()


def is_floating_point(x) -> bool:
    return ensure_tensor(x).is_floating_point()


def is_integer(x) -> bool:
    t = ensure_tensor(x)
    return not (t.is_floating_point() or t.is_complex() or t.dtype == torch.bool)
