"""Activation layers (port of the reference's ``nn/layer/activation.py``).

The ``_act`` family wraps a functional of :mod:`..functional` with the
reference's positional arguments (``Softmax(axis)``, ``LeakyReLU(
negative_slope)``, ``Hardtanh(min, max)``, ...); ``PReLU`` holds its slope
as a parameter.  ``RReLU`` draws random slopes in training (through the
port's dropout seam, ``framework.random._uniform``) and uses the mean
slope in eval, as in the reference.
"""

from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "SiLU", "Swish", "Mish", "Sigmoid", "Tanh", "Softmax",
           "LogSoftmax", "LeakyReLU", "PReLU", "ELU", "SELU", "CELU", "Hardswish",
           "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink", "Softplus", "Softsign",
           "Tanhshrink", "ThresholdedReLU", "Maxout", "GLU", "LogSigmoid", "Silu",
           "Softmax2D", "RReLU"]

# each layer's positional arguments, the functional's keywords
_SIGS = {
    "Softmax": ["axis"],
    "LogSoftmax": ["axis"],
    "LeakyReLU": ["negative_slope"],
    "ELU": ["alpha"],
    "CELU": ["alpha"],
    "Hardtanh": ["min", "max"],
    "Hardshrink": ["threshold"],
    "Softshrink": ["threshold"],
    "ThresholdedReLU": ["threshold", "value"],
    "Maxout": ["groups", "axis"],
    "GLU": ["axis"],
    "GELU": ["approximate"],
}


def _act(name: str, fname: str):
    def __init__(self, *args, **kw):
        Layer.__init__(self)
        self._kw = dict(zip(_SIGS.get(name, []), args))
        self._kw.update((k, v) for k, v in kw.items() if k != "name")

    def forward(self, x):
        return getattr(F, fname)(x, **self._kw)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kw.items())

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "extra_repr": extra_repr, "__module__": __name__,
                                 "__doc__": f"``F.{fname}`` as a layer."})


ReLU = _act("ReLU", "relu")
ReLU6 = _act("ReLU6", "relu6")
GELU = _act("GELU", "gelu")
SiLU = _act("SiLU", "silu")
Swish = _act("Swish", "swish")
Mish = _act("Mish", "mish")
Sigmoid = _act("Sigmoid", "sigmoid")
Tanh = _act("Tanh", "tanh")
Softmax = _act("Softmax", "softmax")
LogSoftmax = _act("LogSoftmax", "log_softmax")
LeakyReLU = _act("LeakyReLU", "leaky_relu")
ELU = _act("ELU", "elu")
SELU = _act("SELU", "selu")
CELU = _act("CELU", "celu")
Hardswish = _act("Hardswish", "hardswish")
Hardsigmoid = _act("Hardsigmoid", "hardsigmoid")
Hardtanh = _act("Hardtanh", "hardtanh")
Hardshrink = _act("Hardshrink", "hardshrink")
Softshrink = _act("Softshrink", "softshrink")
Softplus = _act("Softplus", "softplus")
Softsign = _act("Softsign", "softsign")
Tanhshrink = _act("Tanhshrink", "tanhshrink")
ThresholdedReLU = _act("ThresholdedReLU", "thresholded_relu")
Maxout = _act("Maxout", "maxout")
GLU = _act("GLU", "glu")


class PReLU(Layer):
    """``F.prelu`` with ``num_parameters`` slopes starting at ``init``."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25, weight_attr=None,
                 data_format: str = "NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device)
        self._data_format = data_format
        self.weight = self.create_parameter([num_parameters], attr=weight_attr,
                                            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)


class LogSigmoid(Layer):
    def forward(self, x):
        return F.log_sigmoid(x)


class Silu(Layer):
    def forward(self, x):
        return F.silu(x)


class Softmax2D(Layer):
    """Softmax over the channel axis of a [C, H, W] or [N, C, H, W] input."""

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError("Softmax2D expects 3-D or 4-D input")
        return F.softmax(x, axis=-3)


class RReLU(Layer):
    """``F.rrelu`` in the layer's mode: random slopes in training, the mean
    slope in eval."""

    def __init__(self, lower: float = 1.0 / 8.0, upper: float = 1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)
