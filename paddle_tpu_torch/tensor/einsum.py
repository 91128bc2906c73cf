"""``einsum`` (port of the reference's ``tensor/einsum.py``)."""

from __future__ import annotations

import torch

from ._op_utils import ensure_tensor
from .tensor import apply_op

__all__ = ["einsum"]


def einsum(equation, *operands, name=None):
    ts = tuple(ensure_tensor(t) for t in operands)
    return apply_op("einsum", lambda *vs: torch.einsum(equation, *vs), ts)
