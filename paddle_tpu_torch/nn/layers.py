"""Layers of the serving path as ``torch.nn.Module``s (port of the
reference's ``nn/layer/common.py`` ``Linear``/``Embedding`` and
``nn/layer/norm.py`` ``RMSNorm``).

``Linear.weight`` keeps paddle's ``[in, out]`` layout and computes
``x @ W``, so weights cross between the two packages without transposes.
Weights are drawn from N(0, ``std``) with the caller's ``torch.Generator``
(the initializer every Llama layer of the reference uses).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import functional as F

__all__ = ["Linear", "Embedding", "RMSNorm"]


def _normal(shape, std, generator, device, dtype) -> nn.Parameter:
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    """y = x @ W, W of shape [in_features, out_features] (no bias: the
    Llama projections have none)."""

    def __init__(self, in_features: int, out_features: int, *, std: float = 0.02,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = _normal((in_features, out_features), std, generator,
                              device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight)

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
