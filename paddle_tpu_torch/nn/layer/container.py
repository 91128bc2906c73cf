"""Container layers (port of the reference's ``nn/layer/container.py``:
``Sequential``, ``LayerList``, ``LayerDict``, ``ParameterList``).

Each is a :class:`~.layers.Layer` holding its members as sublayers (or
parameters) named by position or key, so the structured names of a state
dict (``layers.0.weight``) are the reference's.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Optional

import torch
from torch import nn

from .layers import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(Layer):
    """Layers called in order.  ``Sequential(a, b)`` names them ``"0"``,
    ``"1"``; an ``OrderedDict`` or ``(name, layer)`` pairs name them."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, (list, tuple)) and len(layer) == 2:
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return self._modules[list(self._modules)[idx]]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    """A list of sublayers named by position."""

    def __init__(self, sublayers: Optional[Iterable[nn.Module]] = None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def append(self, sublayer: nn.Module) -> "LayerList":
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def insert(self, index: int, sublayer: nn.Module) -> None:
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for i, layer in enumerate(layers):
            self._modules[str(i)] = layer

    def extend(self, sublayers: Iterable[nn.Module]) -> "LayerList":
        for layer in sublayers:
            self.append(layer)
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[list(self._modules)[idx]]

    def __setitem__(self, idx, layer):
        self._modules[list(self._modules)[idx]] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerDict(Layer):
    """Sublayers by key, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def update(self, sublayers) -> None:
        items = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for name, layer in items:
            self.add_sublayer(name, layer)

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def pop(self, name):
        return self._modules.pop(name)

    def clear(self):
        self._modules.clear()

    def __getitem__(self, name):
        return self._modules[name]

    def __setitem__(self, name, layer):
        self.add_sublayer(name, layer)

    def __delitem__(self, name):
        del self._modules[name]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, name):
        return name in self._modules


class ParameterList(Layer):
    """Parameters named by position."""

    def __init__(self, parameters: Optional[Iterable[torch.Tensor]] = None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def append(self, parameter: torch.Tensor) -> "ParameterList":
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[list(self._parameters)[idx]]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())
