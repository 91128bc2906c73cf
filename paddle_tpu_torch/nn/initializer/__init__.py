"""Weight initializers (port of the reference's ``nn/initializer/``).

An initializer is a callable ``init(shape, dtype, generator=None,
device=None) -> torch.Tensor``: where the reference takes a JAX PRNG key,
the port takes the ``torch.Generator`` to draw from, on the device the
value is made on (``Layer.create_parameter`` passes the layer's; without
one, the device's global generator, which
:func:`~paddle_tpu_torch.framework.random.seed` seeds).  The laws
are the reference's: ``fan_in``/``fan_out`` follow paddle's layouts
(Linear weights ``[in, out]``; conv weights ``[out, in/groups, *k]``), a
truncated normal is cut at ``a`` and ``b`` standard deviations, and
``Orthogonal`` signs its QR factor by R's diagonal.  JAX's and torch's
random bits differ, so the random initializers agree with the reference
in law, and the deterministic ones (``Constant``, ``Assign``, ``Dirac``)
bit for bit.  Normal and uniform draws are made in the target dtype,
as the port's layers always made them.
"""

from __future__ import annotations

import math as _math
from typing import Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
]


def _fans(shape: Sequence[int]):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # paddle Linear weight is [in, out]
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    # conv weight [out, in/groups, *k]
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
             "tanh": 5.0 / 3.0, "relu": _math.sqrt(2.0),
             "leaky_relu": _math.sqrt(2.0 / (1 + (param if param is not None else 0.01) ** 2)),
             "selu": 3.0 / 4.0}
    return gains.get(nonlinearity, 1.0)


def _where(generator, device) -> torch.device:
    """``device``; the generator's if None; the default device without
    either."""
    if device is not None:
        return resolve_device(device)
    return resolve_device(None if generator is None else generator.device)


def _empty(shape, dtype, generator, device):
    """An uninitialised tensor where :func:`_where` says and the generator
    to fill it from (None: the device's global generator)."""
    return (torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                        device=_where(generator, device)), generator)


class Initializer:
    def __call__(self, shape, dtype=torch.float32, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        return torch.full(tuple(int(s) for s in shape), self.value, dtype=dtype,
                          device=_where(generator, device))


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        w, g = _empty(shape, dtype, generator, device)
        return w.normal_(self.mean, self.std, generator=g)


class TruncatedNormal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0, a: float = -2.0, b: float = 2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        w, g = _empty(shape, torch.float32, generator, device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, self.a, self.b, generator=g)
        return (w * self.std + self.mean).to(dtype)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        w, g = _empty(shape, dtype, generator, device)
        return w.uniform_(self.low, self.high, generator=g)


def _given_fans(shape, fan_in, fan_out):
    fi, fo = _fans(shape)
    return (fan_in if fan_in is not None else fi), (fan_out if fan_out is not None else fo)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        fi, fo = _given_fans(shape, self._fan_in, self._fan_out)
        return Normal(0.0, self.gain * _math.sqrt(2.0 / (fi + fo)))(shape, dtype, generator,
                                                                   device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        fi, fo = _given_fans(shape, self._fan_in, self._fan_out)
        limit = self.gain * _math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, generator, device)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0, nonlinearity: str = "relu"):
        self._fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        fi, _ = _given_fans(shape, self._fan_in, None)
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / _math.sqrt(fi))(shape, dtype, generator, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0, nonlinearity: str = "relu"):
        self._fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        fi, _ = _given_fans(shape, self._fan_in, None)
        limit = calculate_gain(self.nonlinearity, self.negative_slope) * _math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, generator, device)


class Assign(Initializer):
    """The given value (a tensor, an array or nested lists) as it is, cast
    to ``dtype``; its shape must be the parameter's."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        v = self.value.detach() if isinstance(self.value, torch.Tensor) \
            else torch.as_tensor(np.asarray(self.value))
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"Assign initializer shape mismatch: {tuple(v.shape)} vs "
                             f"{tuple(shape)}")
        return v.to(device=_where(generator, device), dtype=dtype, copy=True)


class Orthogonal(Initializer):
    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        if len(shape) < 2:
            raise ValueError("Orthogonal initializer needs >= 2 dims")
        rows, cols = int(shape[0]), int(np.prod(shape[1:]))
        mat, g = _empty((max(rows, cols), min(rows, cols)), torch.float32, generator, device)
        q, r = torch.linalg.qr(mat.normal_(0.0, 1.0, generator=g))
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return (self.gain * q[:rows, :cols].reshape(tuple(shape))).to(dtype)


class Dirac(Initializer):
    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32, generator=None, device=None):
        out = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        centers = [k // 2 for k in shape[2:]]
        for i in range(min(oc, ic * self.groups)):
            idx = (i, i % ic) + tuple(centers)
            out[idx] = 1.0
        return torch.as_tensor(out).to(device=_where(generator, device), dtype=dtype)
