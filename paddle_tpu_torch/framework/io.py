"""``save`` and ``load`` (port of the reference's ``framework/io.py``;
paddle's ``framework/io.py:721,960``).

A pickle of the object with every tensor replaced by a payload holding its
values as a numpy array, so a file outlives the process and the device it
was saved from.  Nested dicts, lists and tuples, ``LRScheduler`` states and
plain Python values pass through.  ``load`` gives host tensors (or, with
``return_numpy``, the arrays); ``set_state_dict`` and ``load_state_dict``
move them to their parameters' devices.

Files cross between the packages: a state dict of plain arrays is the same
pickle in both, and ``load`` reads the reference's tensor payloads too.
numpy has no bfloat16, so a bf16 tensor is saved widened to f32 (exact)
with its dtype recorded, and narrowed again on load.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]

_PROTOCOL = 4
_NAMES = {torch.bfloat16: "bfloat16"}


class _TensorPayload:
    __slots__ = ("array", "stop_gradient", "name", "dtype")

    def __init__(self, array, stop_gradient, name, dtype=None):
        self.array = array
        self.stop_gradient = stop_gradient
        self.name = name
        self.dtype = dtype


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        dtype = _NAMES.get(t.dtype)
        array = (t.float() if dtype else t).numpy().copy()
        return _TensorPayload(array, not obj.requires_grad, getattr(obj, "name", None), dtype)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj: Any, return_numpy: bool) -> Any:
    if isinstance(obj, _TensorPayload):
        dtype = getattr(obj, "dtype", None)
        if return_numpy:
            return obj.array
        t = torch.from_numpy(np.ascontiguousarray(obj.array))
        return t.to(getattr(torch, dtype)) if dtype else t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    """Reads the reference's payload class as this module's."""

    def find_class(self, module, name):
        if name == "_TensorPayload" and module.endswith("framework.io"):
            return _TensorPayload
        return super().find_class(module, name)


def save(obj: Any, path: str, protocol: int = _PROTOCOL, **configs) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy)
