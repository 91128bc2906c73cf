"""Common layers as ``torch.nn.Module``s (port of the reference's
``nn/layer/common.py``: ``Linear``, ``Embedding``, ``Dropout``).

The constructors take the reference's arguments in its order.  Parameter
attributes (``ParamAttr``, an initializer or a name) are not ported yet
(ROADMAP A3): ``None`` gives the default parameter, and ``False`` means no
parameter, as in the reference, where a layer that cannot drop a parameter
refuses it.  The port's own arguments (``std``, ``generator``, ``device``,
``dtype``) are keyword-only after them.

``Linear.weight`` keeps paddle's ``[in, out]`` layout and computes
``x @ W + b``, so weights cross between the two packages without
transposes.  Weights are drawn from N(0, ``std``) with the caller's
``torch.Generator`` (the initializer every Llama and GPT layer of the
reference uses); biases start at zero.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout"]


def _normal(shape, std, generator, device, dtype) -> nn.Parameter:
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w)


def check_attr(attr, what: str, droppable: bool) -> bool:
    """Whether the parameter ``what`` exists under ``attr`` (None: yes;
    False: no, where the layer can drop it).  The reference's
    ``create_parameter`` refuses ``False`` for a parameter its layer always
    has; ``ParamAttr`` and initializers wait for ROADMAP A3."""
    if attr is None:
        return True
    if attr is False:
        if droppable:
            return False
        raise ValueError("attr=False is handled by the calling layer (means: no "
                         f"parameter), and {what} cannot be left out")
    raise NotImplementedError(
        f"{what}: parameter attributes (ParamAttr, initializers, names) are "
        "not ported yet (ROADMAP A3); pass None or False")


class Linear(nn.Module):
    """y = x @ W + b, W of shape [in_features, out_features] and b [out]
    (zeros).  ``bias_attr=False`` leaves the bias out (the Llama
    projections have none)."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None, *, std: float = 0.02,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_attr(weight_attr, "Linear weight", droppable=False)
        self.in_features, self.out_features = in_features, out_features
        self.weight = _normal((in_features, out_features), std, generator,
                              device, dtype)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device, dtype=dtype)) \
            if check_attr(bias_attr, "Linear bias", droppable=True) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    """Rows of a [num_embeddings, embedding_dim] table.  With
    ``padding_idx`` (negative counts from the end), that row of the weight
    starts at zero and the output rows at that id are zero, as in the
    reference.  ``sparse`` is accepted and has no effect: the gradient is
    dense, as the reference's is."""

    def __init__(self, num_embeddings: int, embedding_dim: int, padding_idx=None,
                 sparse: bool = False, weight_attr=None, name=None, *,
                 std: float = 0.02, generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        check_attr(weight_attr, "Embedding weight", droppable=False)
        self._padding_idx = (padding_idx if padding_idx is None or padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = _normal((num_embeddings, embedding_dim), std, generator,
                              device, dtype)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(nn.Module):
    """``F.dropout`` in the module's training mode: identity at p = 0 or in
    eval mode; p > 0 in training raises (no Philox generator yet)."""

    def __init__(self, p: float = 0.5, axis=None, mode: str = "upscale_in_train",
                 name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, self.axis, training=self.training, mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"
