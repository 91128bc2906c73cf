"""Normalization layers (port of the reference's ``nn/layer/norm.py``:
``LayerNorm``, ``RMSNorm``).

Each is a :class:`~.layers.Layer`.  Weights start at one and biases at
zero; ``weight_attr``/``bias_attr`` follow :func:`.common.check_attr`:
``False`` drops a LayerNorm parameter, as in the reference; the RMSNorm
weight cannot be dropped.  The port's ``device`` and ``dtype`` are
keyword-only after the reference's arguments.  The batch, group,
instance, local-response and spectral norms come with the convolutions
(ROADMAP A3b).
"""

from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .common import check_attr
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes
    (``F.layer_norm``: f32 inside).  AMP O2 keeps its parameters in f32."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = [int(s) for s in normalized_shape]
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr, default_initializer=I.Constant(1.0)) \
            if check_attr(weight_attr, "LayerNorm weight", droppable=True) else None
        self.bias = self.create_parameter(self._normalized_shape, attr=bias_attr,
                                          is_bias=True) \
            if check_attr(bias_attr, "LayerNorm bias", droppable=True) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(Layer):
    """RMSNorm with a weight initialised to ones (B1 and B1b through
    ``F.rms_norm`` on the card)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device)
        check_attr(weight_attr, "RMSNorm weight", droppable=False)
        self._epsilon = epsilon
        self.weight = self.create_parameter([hidden_size], attr=weight_attr,
                                            default_initializer=I.Constant(1.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self._epsilon)
