"""Automatic mixed precision, level O2 (port of the reference's
``amp/__init__.py`` ``decorate``).

O2 is pure half precision: every floating-point parameter is cast to the
half dtype in place (the Parameter objects stay, so optimizer lists stay
valid), except those of LayerNorm (the port's and torch's), BatchNorm
and GroupNorm layers.  As in the reference, RMSNorm weights are cast too.  Buffers keep their dtype
(the f32 rope tables).  Floating-point inputs of the model's forward are
cast to the half dtype as they enter, or the first op's type promotion
would run the model in f32.  The optimizers get f32 master weights
(``multi_precision``)."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..nn.layers import LayerNorm

__all__ = ["decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_KEEP_F32 = (LayerNorm, nn.LayerNorm, nn.modules.batchnorm._BatchNorm, nn.GroupNorm)


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
             master_weight=None):
    """Cast ``models`` for ``level`` O2 and arm master weights on
    ``optimizers`` (unless ``master_weight`` is False).  Returns the
    models (and optimizers) in the shape they were given."""
    dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for model in model_list:
            for layer in model.modules():
                if isinstance(layer, _KEEP_F32):
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
