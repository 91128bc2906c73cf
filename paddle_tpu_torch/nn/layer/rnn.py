"""Single-step recurrent cells (port of the reference's ``nn/layer/rnn.py``
``RNNCellBase``, ``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``), the cells
``nn.decode``'s decoders drive.

Parameter names and layouts are the reference's (``weight_ih`` [gates *
hidden, input], ``weight_hh`` [gates * hidden, hidden], ``bias_ih`` and
``bias_hh`` [gates * hidden]), so a state dict crosses through
:func:`paddle_tpu_torch.convert.load_numpy_state_dict`.  The gate math is
the reference's, in its order of operations: LSTM gates i, f, g, o;
GRU's candidate resets after the matmul, ``h' = (h - c) * z + c``.  Weights
are drawn from U(-1/sqrt(hidden), 1/sqrt(hidden)) with the caller's
``torch.Generator``, unless a ``ParamAttr`` or an initializer names
another; an ``*_attr=False`` weight is frozen at 1 and such a bias at 0,
as in the reference.  The cells are :class:`~.layers.Layer`s.  The fused
multi-step layers (``RNN``, ``SimpleRNN``, ``LSTM``, ``GRU``, ``BiRNN``)
are not ported yet (ROADMAP A3b).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import initializer as I
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell"]


class RNNCellBase(Layer):
    """Base of the single-step cells."""

    def get_initial_states(self, batch_ref: torch.Tensor, shape=None):
        """Zero states for ``batch_ref``'s batch, f32, on its device: one
        tensor, or a tuple of them where ``shape`` holds several shapes
        (LSTM's h and c)."""
        shape = shape if shape is not None else self.state_shape
        batch = batch_ref.shape[0]
        if isinstance(shape[0], (tuple, list)):
            return tuple(torch.zeros((batch,) + tuple(s), device=batch_ref.device)
                         for s in shape)
        return torch.zeros((batch,) + tuple(shape), device=batch_ref.device)


def _param(cell: Layer, shape, attr, std: float, is_bias: bool):
    if attr is False:
        # the reference freezes a disabled weight at 1 and a disabled bias at 0
        p = cell.create_parameter(shape, None,
                                  default_initializer=I.Constant(0.0 if is_bias else 1.0))
        p.requires_grad_(False)
        return p
    return cell.create_parameter(shape, attr, default_initializer=I.Uniform(-std, std))


class _Cell(RNNCellBase):
    def __init__(self, gates: int, input_size: int, hidden_size: int, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr,
                 generator: Optional[torch.Generator], device, dtype):
        super().__init__(dtype=dtype)
        self._place(device, generator)
        if hidden_size <= 0:
            raise ValueError("hidden_size must be > 0")
        self.input_size, self.hidden_size = input_size, hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        g = gates * hidden_size
        self.weight_ih = _param(self, (g, input_size), weight_ih_attr, std, False)
        self.weight_hh = _param(self, (g, hidden_size), weight_hh_attr, std, False)
        self.bias_ih = _param(self, (g,), bias_ih_attr, std, True)
        self.bias_hh = _param(self, (g,), bias_hh_attr, std, True)


class SimpleRNNCell(_Cell):
    """h' = act(W_ih x + b_ih + W_hh h + b_hh), act tanh or relu."""

    def __init__(self, input_size: int, hidden_size: int, activation: str = "tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, generator=None, device=None,
                 dtype=torch.float32):
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        super().__init__(1, input_size, hidden_size, weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr, generator, device, dtype)
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = torch.tanh if self.activation == "tanh" else torch.relu
        h = act(inputs @ self.weight_ih.T + self.bias_ih
                + states @ self.weight_hh.T + self.bias_hh)
        return h, h


class LSTMCell(_Cell):
    """Gate order i, f, g, o; c' = f·c + i·tanh(g); h' = o·tanh(c').
    Returns ``(h', (h', c'))``."""

    def __init__(self, input_size: int, hidden_size: int, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, generator=None, device=None, dtype=torch.float32):
        super().__init__(4, input_size, hidden_size, weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr, generator, device, dtype)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        gates = (inputs @ self.weight_ih.T + self.bias_ih
                 + h @ self.weight_hh.T + self.bias_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class GRUCell(_Cell):
    """r, z gates and a candidate reset after the matmul:
    c = tanh(x_c + r·h_c); h' = (h − c)·z + c."""

    def __init__(self, input_size: int, hidden_size: int, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, generator=None, device=None, dtype=torch.float32):
        super().__init__(3, input_size, hidden_size, weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr, generator, device, dtype)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x_r, x_z, x_c = (inputs @ self.weight_ih.T + self.bias_ih).chunk(3, dim=-1)
        h_r, h_z, h_c = (states @ self.weight_hh.T + self.bias_hh).chunk(3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        c = torch.tanh(x_c + r * h_c)
        h = (states - c) * z + c
        return h, h
