"""Normalization layers as ``torch.nn.Module``s (port of the reference's
``nn/layer/norm.py``: ``LayerNorm``, ``RMSNorm``).

Weights start at one and biases at zero.  ``weight_attr``/``bias_attr``
follow :func:`.common.check_attr`: ``False`` drops a LayerNorm parameter,
as in the reference; the RMSNorm weight cannot be dropped.  The port's
``device`` and ``dtype`` are keyword-only after the reference's arguments.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .common import check_attr

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes
    (``F.layer_norm``: f32 inside).  AMP O2 keeps its parameters in f32."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = tuple(int(s) for s in normalized_shape)
        self._epsilon = epsilon
        place = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones(self._normalized_shape, **place)) \
            if check_attr(weight_attr, "LayerNorm weight", droppable=True) else None
        self.bias = nn.Parameter(torch.zeros(self._normalized_shape, **place)) \
            if check_attr(bias_attr, "LayerNorm bias", droppable=True) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={list(self._normalized_shape)}, epsilon={self._epsilon}"


class RMSNorm(nn.Module):
    """RMSNorm with a weight initialised to ones."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        check_attr(weight_attr, "RMSNorm weight", droppable=False)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self._epsilon)
