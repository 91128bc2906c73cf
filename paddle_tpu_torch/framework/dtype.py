"""The dtype names over ``torch.dtype`` (port of the reference's
``framework/dtype.py``).

``paddle_tpu_torch.float32`` is ``torch.float32``, and every function of the
port that takes a dtype takes a torch dtype, its name (``"bfloat16"``,
``"bf16"``, ``"float"``), a numpy dtype or a Python type.

The reference folds int64 to int32 and float64 to float32, because JAX's x64
mode is off on the TPU.  The port keeps torch's 64-bit types: an index
(``argmax``, ``topk``, ``nonzero``, ``randperm``, ``one_hot``'s input) is
int64, a Python float list makes float32 (torch's default dtype) and a
float64 numpy array stays float64.  So :func:`canonical_dtype` is
:func:`convert_dtype` (ROADMAP §C).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = [
    "bfloat16", "float16", "float32", "float64",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "bool_", "complex64", "complex128",
    "convert_dtype", "canonical_dtype", "is_floating_point", "is_integer",
    "default_float_dtype", "finfo", "iinfo",
]

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
uint64 = torch.uint64
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR_ALIASES = {
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float16": float16, "fp16": float16, "half": float16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64, "int": int64,
    "uint8": uint8, "uint16": uint16, "uint32": uint32, "uint64": uint64,
    "bool": bool_, "complex64": complex64, "complex128": complex128,
}
_PY_TYPES = {bool: bool_, int: int64, float: float32, complex: complex64}


def convert_dtype(dtype: Any) -> torch.dtype:
    """Any dtype spec (torch dtype, name, numpy dtype, Python type) as a
    ``torch.dtype``."""
    if dtype is None:
        raise TypeError("dtype must not be None")
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _STR_ALIASES:
            return _STR_ALIASES[key]
        return _STR_ALIASES[np.dtype(key).name]
    if dtype in _PY_TYPES:
        return _PY_TYPES[dtype]
    name = np.dtype(dtype).name
    if name not in _STR_ALIASES:
        raise TypeError(f"no torch dtype for {dtype!r}")
    return _STR_ALIASES[name]


def canonical_dtype(dtype: Any) -> torch.dtype:
    """The dtype a tensor of ``dtype`` gets: :func:`convert_dtype`, since
    the port keeps the 64-bit types the reference folds."""
    return convert_dtype(dtype)


def is_floating_point(dtype: Any) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype: Any) -> bool:
    dt = convert_dtype(dtype)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def default_float_dtype() -> torch.dtype:
    return torch.float32


def finfo(dtype: Any):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype: Any):
    return torch.iinfo(convert_dtype(dtype))
