"""MobileNet V1 and V2 (port of the reference's
``vision/models/mobilenet.py``): depthwise-separable blocks (V1) and
inverted residuals with linear bottlenecks (V2), at width ``scale``.
``data_format`` is the internal layout ("auto": NHWC on the card); the
forward takes NCHW."""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.layer.layers import placement
from ._common import no_pretrained, resolve_format, stem_format, to_public

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


def _mk(v: float) -> int:
    """Channels rounded the MobileNet way: to a multiple of 8, never down
    by more than 10%."""
    new = max(8, int(v + 4) // 8 * 8)
    if new < 0.9 * v:
        new += 8
    return new


class _ConvBNRelu(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, groups=1, df="NCHW",
                 stem=False, relu6=True):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=k // 2,
                              groups=groups, bias_attr=False,
                              data_format=stem_format(df) if stem else df)
        self.bn = nn.BatchNorm2D(out_c, data_format=df)
        self.act = nn.ReLU6() if relu6 else nn.ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class MobileNetV1(nn.Layer):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, data_format: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._place(device, generator)
        self.data_format = df = resolve_format(data_format, self._home())
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(v):
            return max(1, int(v * scale))    # V1 rounds with int(), unlike V2

        def dw_sep(in_c, out_c, stride):
            return nn.Sequential(
                _ConvBNRelu(in_c, in_c, 3, stride, groups=in_c, df=df, relu6=False),
                _ConvBNRelu(in_c, out_c, 1, 1, df=df, relu6=False))

        plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] \
            + [(512, 1)] * 5 + [(1024, 2), (1024, 1)]
        with placement(self._device, self._generator):
            blocks = [_ConvBNRelu(3, c(32), 3, 2, df=df, stem=True, relu6=False)]
            in_c = c(32)
            for out, s in plan:
                blocks.append(dw_sep(in_c, c(out), s))
                in_c = c(out)
            self.features = nn.Sequential(*blocks)
            self._out_c = in_c
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = nn.Linear(in_c, num_classes)

    def forward(self, x):
        x = to_public(self.features(x), self.data_format)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class _InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand, df):
        super().__init__()
        hidden = int(round(in_c * expand))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand != 1:
            layers.append(_ConvBNRelu(in_c, hidden, 1, df=df))
        layers.append(_ConvBNRelu(hidden, hidden, 3, stride, groups=hidden, df=df))
        layers.append(nn.Conv2D(hidden, out_c, 1, bias_attr=False, data_format=df))
        layers.append(nn.BatchNorm2D(out_c, data_format=df))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, data_format: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._place(device, generator)
        self.data_format = df = resolve_format(data_format, self._home())
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        plan = [  # t (expansion), c, n (repeats), s (first stride)
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        with placement(self._device, self._generator):
            in_c = _mk(32 * scale)
            blocks = [_ConvBNRelu(3, in_c, 3, 2, df=df, stem=True)]
            for t, c_, n, s in plan:
                out_c = _mk(c_ * scale)
                for i in range(n):
                    blocks.append(_InvertedResidual(in_c, out_c, s if i == 0 else 1, t, df))
                    in_c = out_c
            self._out_c = _mk(1280 * max(1.0, scale))
            blocks.append(_ConvBNRelu(in_c, self._out_c, 1, df=df))
            self.features = nn.Sequential(*blocks)
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.classifier = nn.Sequential(nn.Dropout(0.2),
                                                nn.Linear(self._out_c, num_classes))

    def forward(self, x):
        x = to_public(self.features(x), self.data_format)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs) -> MobileNetV1:
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs) -> MobileNetV2:
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
