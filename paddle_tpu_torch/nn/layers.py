"""Layers of the serving and training paths as ``torch.nn.Module``s (port
of the reference's ``nn/layer/common.py`` ``Linear``/``Embedding``/
``Dropout`` and ``nn/layer/norm.py`` ``RMSNorm``/``LayerNorm``).

``Linear.weight`` keeps paddle's ``[in, out]`` layout and computes
``x @ W + b``, so weights cross between the two packages without
transposes.  Weights are drawn from N(0, ``std``) with the caller's
``torch.Generator`` (the initializer every Llama and GPT layer of the
reference uses); biases start at zero, norm weights at one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import functional as F

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm", "Dropout"]


def _normal(shape, std, generator, device, dtype) -> nn.Parameter:
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    """y = x @ W + b, W of shape [in_features, out_features] and b [out]
    (zeros).  ``bias_attr=False`` leaves the bias out, as paddle's does
    (the Llama projections have none)."""

    def __init__(self, in_features: int, out_features: int, bias_attr=None, *,
                 std: float = 0.02, generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = _normal((in_features, out_features), std, generator,
                              device, dtype)
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_features, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 std: float = 0.02, generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim), std, generator,
                              device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight)

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class RMSNorm(nn.Module):
    """RMSNorm with a weight initialised to ones."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self._epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis (``F.layer_norm``: f32 inside), weight
    ones and bias zeros.  AMP O2 keeps its parameters in f32."""

    def __init__(self, normalized_shape: int, epsilon: float = 1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._normalized_shape = (int(normalized_shape),)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(normalized_shape, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(normalized_shape, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={list(self._normalized_shape)}, epsilon={self._epsilon}"


class Dropout(nn.Module):
    """``F.dropout`` in the module's training mode: identity at p = 0 or in
    eval mode; p > 0 in training raises (no Philox generator yet)."""

    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train"):
        super().__init__()
        self.p, self.mode = p, mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, training=self.training, mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"
