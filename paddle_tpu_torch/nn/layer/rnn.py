"""Recurrent layers (port of the reference's ``nn/layer/rnn.py``): the
single-step cells ``RNNCellBase``, ``SimpleRNNCell``, ``LSTMCell`` and
``GRUCell`` (which ``nn.decode``'s decoders drive), the cell wrappers
``RNN`` and ``BiRNN``, and the multi-layer ``SimpleRNN``, ``LSTM`` and
``GRU``.

Parameter names and layouts are the reference's (``weight_ih`` [gates *
hidden, input], ``weight_hh`` [gates * hidden, hidden], ``bias_ih`` and
``bias_hh`` [gates * hidden]; the multi-layer classes hold their cells in
``cells``, layer by layer, forward before backward), so a state dict
crosses through :func:`paddle_tpu_torch.convert.load_numpy_state_dict`.
The gate math is the reference's, in its order of operations: LSTM gates
i, f, g, o; GRU's candidate resets after the matmul, ``h' = (h - c) * z +
c``.  Weights are drawn from U(-1/sqrt(hidden), 1/sqrt(hidden)) with the
caller's ``torch.Generator``, unless a ``ParamAttr`` or an initializer
names another; an ``*_attr=False`` weight is frozen at 1 and such a bias
at 0, as in the reference.  The cells are :class:`~.layers.Layer`s.

The reference runs each layer and direction of the multi-layer classes
as one ``lax.scan``; here it is a Python loop over time of the cells'
step math (``_Cell.step``), with each layer's input projection
``x @ W_ih^T + b_ih`` made for every step at once, then added in the
reference's order.  ``sequence_length`` holds a row's state past its
length and writes zeros there; the reverse direction walks the padded
sequence from its end.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import functional as F
from .. import initializer as I
from .container import LayerList
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "SimpleRNN", "LSTM",
           "GRU", "BiRNN"]


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

    def project(self, inputs: torch.Tensor) -> torch.Tensor:
        """The input's share of the gates, ``inputs @ W_ih^T + b_ih``."""
        return inputs @ self.weight_ih.T + self.bias_ih

    def forward(self, inputs, states=None):
        """One step: ``(output, new states)``."""
        if states is None:
            states = self.get_initial_states(inputs)
        new = self.step(self.project(inputs), states)
        return (new[0] if isinstance(new, tuple) else new), new


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

    def step(self, x_proj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        act = torch.tanh if self.activation == "tanh" else torch.relu
        return act(x_proj + h @ self.weight_hh.T + self.bias_hh)


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

    def step(self, x_proj: torch.Tensor, states):
        h, c = states
        gates = x_proj + h @ self.weight_hh.T + self.bias_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c


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

    def step(self, x_proj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        x_r, x_z, x_c = x_proj.chunk(3, dim=-1)
        h_r, h_z, h_c = (h @ self.weight_hh.T + self.bias_hh).chunk(3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        c = torch.tanh(x_c + r * h_c)
        return (h - c) * z + c


class RNN(Layer):
    """Runs ``cell`` over the time axis (axis 1, or 0 with ``time_major``),
    from the end with ``is_reverse``: ``(outputs, final states)``.  As in
    the reference, ``sequence_length`` raises here: the multi-layer classes
    take it."""

    def __init__(self, cell: RNNCellBase, is_reverse: bool = False, time_major: bool = False):
        super().__init__()
        self.cell, self.is_reverse, self.time_major = cell, is_reverse, time_major

    def forward(self, inputs, initial_states=None, sequence_length=None, **kwargs):
        if sequence_length is not None:
            raise NotImplementedError("RNN(cell) wrapper: use SimpleRNN/LSTM/GRU "
                                      "for sequence_length masking")
        t_axis = 0 if self.time_major else 1
        steps = inputs.shape[t_axis]
        states, outs = initial_states, [None] * steps
        for t in (range(steps - 1, -1, -1) if self.is_reverse else range(steps)):
            outs[t], states = self.cell(inputs.select(t_axis, t), states)
        return torch.stack(outs, t_axis), states


class BiRNN(Layer):
    """``cell_fw`` forward and ``cell_bw`` from the end, their outputs
    concatenated on the last axis; ``(outputs, (fw states, bw states))``."""

    def __init__(self, cell_fw: RNNCellBase, cell_bw: RNNCellBase, time_major: bool = False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = initial_states if initial_states is not None else (None, None)
        out_fw, fin_fw = self.rnn_fw(inputs, states_fw, sequence_length)
        out_bw, fin_bw = self.rnn_bw(inputs, states_bw, sequence_length)
        return torch.cat([out_fw, out_bw], -1), (fin_fw, fin_bw)


class _FusedRNNBase(Layer):
    """``num_layers`` layers of ``direction`` ("forward", or "bidirect" /
    "bidirectional") recurrences; layer l > 0 reads layer l − 1's outputs,
    both directions concatenated."""

    _mode = None   # "RNN_TANH", "LSTM" or "GRU"

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 direction: str = "forward", time_major: bool = False, dropout: float = 0.0,
                 activation: str = "tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype)
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError("direction must be forward|bidirect|bidirectional")
        self.input_size, self.hidden_size, self.num_layers = input_size, hidden_size, num_layers
        self.time_major, self.dropout, self.activation = time_major, dropout, activation
        self.bidirectional = direction != "forward"
        self.num_directions = 2 if self.bidirectional else 1
        cls = {"LSTM": LSTMCell, "GRU": GRUCell}.get(self._mode, SimpleRNNCell)
        kw = dict(weight_ih_attr=weight_ih_attr, weight_hh_attr=weight_hh_attr,
                  bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr,
                  generator=generator, device=device, dtype=dtype)
        if cls is SimpleRNNCell:
            kw["activation"] = activation
        self.cells = LayerList([
            cls(input_size if layer == 0 else hidden_size * self.num_directions,
                hidden_size, **kw)
            for layer in range(num_layers) for _ in range(self.num_directions)])

    @staticmethod
    def _scan(cell: _Cell, x: torch.Tensor, state, reverse: bool, lengths):
        """One direction of one layer over x [B, T, I]: outputs [B, T, H]
        and the final state."""
        steps = x.shape[1]
        x_proj = cell.project(x)
        outs = [None] * steps
        for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
            new = cell.step(x_proj[:, t], state)
            h = new[0] if isinstance(new, tuple) else new
            if lengths is not None:
                valid = (t < lengths)[:, None]
                if isinstance(new, tuple):
                    new = tuple(torch.where(valid, n, o) for n, o in zip(new, state))
                else:
                    new = torch.where(valid, new, state)
                h = torch.where(valid, h, torch.zeros_like(h))
            outs[t], state = h, new
        return torch.stack(outs, 1), state

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """inputs [B, T, I] ([T, B, I] with ``time_major``); returns
        (outputs [B, T, H · directions], final states), the states (h, and
        c for LSTM) [num_layers · directions, B, H]."""
        x = inputs.transpose(0, 1) if self.time_major else inputs
        is_lstm = self._mode == "LSTM"
        n_states = self.num_layers * self.num_directions
        if initial_states is None:
            zeros = torch.zeros((n_states, x.shape[0], self.hidden_size), dtype=x.dtype,
                                device=x.device)
            initial_states = (zeros, zeros) if is_lstm else zeros
        lengths = None if sequence_length is None else \
            torch.as_tensor(sequence_length, device=x.device)
        finals = []
        for layer in range(self.num_layers):
            per_dir = []
            for d in range(self.num_directions):
                idx = layer * self.num_directions + d
                state = tuple(s[idx] for s in initial_states) if is_lstm \
                    else initial_states[idx]
                out, fin = self._scan(self.cells[idx], x, state, d == 1, lengths)
                per_dir.append(out)
                finals.append(fin)
            x = per_dir[0] if len(per_dir) == 1 else torch.cat(per_dir, -1)
            if self.dropout > 0 and layer < self.num_layers - 1:
                x = F.dropout(x, p=self.dropout, training=self.training)
        out = x.transpose(0, 1) if self.time_major else x
        if is_lstm:
            return out, (torch.stack([f[0] for f in finals]), torch.stack([f[1] for f in finals]))
        return out, torch.stack(finals)


class SimpleRNN(_FusedRNNBase):
    """Multi-layer Elman RNN, ``activation`` tanh or relu."""

    _mode = "RNN_TANH"


class LSTM(_FusedRNNBase):
    """Multi-layer LSTM; the states are ``(h, c)``."""

    _mode = "LSTM"

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 direction: str = "forward", time_major: bool = False, dropout: float = 0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, generator=None, device=None,
                 dtype=torch.float32):
        # the reference's LSTM has no activation slot: positional calls keep it
        super().__init__(input_size, hidden_size, num_layers, direction, time_major, dropout,
                         weight_ih_attr=weight_ih_attr, weight_hh_attr=weight_hh_attr,
                         bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr, name=name,
                         generator=generator, device=device, dtype=dtype)


class GRU(_FusedRNNBase):
    """Multi-layer GRU."""

    _mode = "GRU"

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 direction: str = "forward", time_major: bool = False, dropout: float = 0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__(input_size, hidden_size, num_layers, direction, time_major, dropout,
                         weight_ih_attr=weight_ih_attr, weight_hh_attr=weight_hh_attr,
                         bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr, name=name,
                         generator=generator, device=device, dtype=dtype)
