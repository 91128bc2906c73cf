"""Convolution layers (port of the reference's ``nn/layer/conv.py``):
``Conv1D``, ``Conv2D``, ``Conv3D`` and their transposes.

Each is a :class:`~.layers.Layer` over the convolution functionals
(``F.conv2d`` and the rest: torch's convolutions, cuDNN on the card).
Weights keep paddle's layouts in every ``data_format``: ``[out,
in/groups, *kernel]``, and ``[in, out/groups, *kernel]`` for the
transposes, so a state dict crosses between the packages as it is.  The
weight and the bias are drawn from U(−1/√fan_in, 1/√fan_in), fan_in =
in/groups · prod(kernel), as in the reference; ``bias_attr=False`` leaves
the bias out.  ``padding_mode`` is taken and not read (zeros), as in the
reference.  The port's ``generator``, ``device`` and ``dtype`` are
keyword-only after the reference's arguments.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import functional as F
from .. import initializer as I
from .common import check_attr
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose"]


class _ConvNd(Layer):
    def __init__(self, nd, in_channels, out_channels, kernel_size, stride, padding,
                 dilation, groups, weight_attr, bias_attr, data_format, transpose=False,
                 output_padding=0, generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device, generator)
        check_attr(weight_attr, "conv weight", droppable=False)
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = F._tuple_n(kernel_size, nd)
        self._stride, self._padding, self._dilation = stride, padding, dilation
        self._groups, self._data_format = groups, data_format
        self._output_padding = output_padding
        shape = ([in_channels, out_channels // groups] if transpose
                 else [out_channels, in_channels // groups]) + list(self._kernel_size)
        bound = 1.0 / math.sqrt((in_channels // groups) * math.prod(self._kernel_size))
        self.weight = self.create_parameter(shape, attr=weight_attr,
                                            default_initializer=I.Uniform(-bound, bound))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound)) \
            if check_attr(bias_attr, "conv bias", droppable=True) else None

    def extra_repr(self) -> str:
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL", *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__(1, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, weight_attr, bias_attr, data_format,
                         generator=generator, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    """2-D convolution; ``data_format`` "NCHW", "NHWC" (takes and gives
    [N, H, W, C]) or a boundary "NCHW:NHWC"."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW", *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__(2, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, weight_attr, bias_attr, data_format,
                         generator=generator, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW", *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__(3, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, weight_attr, bias_attr, data_format,
                         generator=generator, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCL", *, generator=None, device=None, dtype=torch.float32):
        super().__init__(1, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, weight_attr, bias_attr, data_format, True,
                         output_padding, generator=generator, device=device, dtype=dtype)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)


class Conv2DTranspose(_ConvNd):
    """Transposed 2-D convolution; ``output_size`` is taken and not read,
    as in the reference."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCHW", *, generator=None, device=None, dtype=torch.float32):
        super().__init__(2, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, weight_attr, bias_attr, data_format, True,
                         output_padding, generator=generator, device=device, dtype=dtype)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCDHW", *, generator=None, device=None, dtype=torch.float32):
        super().__init__(3, in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, weight_attr, bias_attr, data_format, True,
                         output_padding, generator=generator, device=device, dtype=dtype)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)
