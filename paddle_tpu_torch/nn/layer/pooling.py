"""Pooling layers (port of the reference's ``nn/layer/pooling.py``): the
max, average and adaptive pools in one, two and three dimensions, each a
:class:`~.layers.Layer` over its functional.  As in the reference, the
max and average pools take their layout as the keyword ``data_format``
(default the channels-first form), ``AdaptiveAvgPool1D``,
``AdaptiveMaxPool1D`` and ``AdaptiveMaxPool2D`` refuse any layout but
channels-first, and ``return_mask`` is refused where the functional
refuses it.
"""

from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D"]


class _Pool(Layer):
    def __init__(self, kernel_size, stride, padding, ceil_mode, data_format):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.ceil_mode, self.data_format = ceil_mode, data_format

    def extra_repr(self) -> str:
        return f"kernel_size={self.kernel_size}, stride={self.stride}, padding={self.padding}"


class _MaxPool(_Pool):
    _fn = staticmethod(F.max_pool2d)
    _format = "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, **kw):
        super().__init__(kernel_size, stride, padding, ceil_mode, kw.get("data_format"))
        self.return_mask = return_mask

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding,
                        return_mask=self.return_mask, ceil_mode=self.ceil_mode,
                        data_format=self.data_format or self._format)


class _AvgPool(_Pool):
    _fn = staticmethod(F.avg_pool2d)
    _format = "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, **kw):
        super().__init__(kernel_size, stride, padding, ceil_mode, kw.get("data_format"))
        self.exclusive = exclusive

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding,
                        exclusive=self.exclusive, ceil_mode=self.ceil_mode,
                        data_format=self.data_format or self._format)


class MaxPool1D(_MaxPool):
    _fn, _format = staticmethod(F.max_pool1d), "NCL"


class MaxPool2D(_MaxPool):
    """Max over windows (``F.max_pool2d``)."""


class MaxPool3D(_MaxPool):
    _fn, _format = staticmethod(F.max_pool3d), "NCDHW"


class AvgPool1D(_AvgPool):
    _fn, _format = staticmethod(F.avg_pool1d), "NCL"


class AvgPool2D(_AvgPool):
    """Mean over windows (``F.avg_pool2d``)."""


class AvgPool3D(_AvgPool):
    _fn, _format = staticmethod(F.avg_pool3d), "NCDHW"


class _AdaptivePool(Layer):
    def __init__(self, output_size, **kw):
        super().__init__()
        self.output_size = output_size
        self.data_format = kw.get("data_format")

    def _channels_first_only(self, what: str, fmt: str) -> None:
        if self.data_format not in (None, fmt):
            raise NotImplementedError(f"{what} supports {fmt} only")

    def extra_repr(self) -> str:
        return f"output_size={self.output_size}"


class AdaptiveAvgPool1D(_AdaptivePool):
    def forward(self, x):
        self._channels_first_only("adaptive_avg_pool1d", "NCL")
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    """Mean over adaptive bins; ``AdaptiveAvgPool2D((1, 1))`` is ResNet's
    global pool."""

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     data_format=self.data_format or "NCHW")


class AdaptiveAvgPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size,
                                     data_format=self.data_format or "NCDHW")


class AdaptiveMaxPool1D(_AdaptivePool):
    def forward(self, x):
        self._channels_first_only("adaptive_max_pool1d", "NCL")
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(_AdaptivePool):
    def forward(self, x):
        self._channels_first_only("adaptive_max_pool2d", "NCHW")
        return F.adaptive_max_pool2d(x, self.output_size)


class AdaptiveMaxPool3D(_AdaptivePool):
    def __init__(self, output_size, return_mask: bool = False, name=None):
        super().__init__(output_size)
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)
