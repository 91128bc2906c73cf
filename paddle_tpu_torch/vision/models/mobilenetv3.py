"""MobileNetV3 Small and Large (port of the reference's
``vision/models/mobilenetv3.py``): inverted residuals with optional
squeeze-excitation (a hard-sigmoid gate), hardswish tails, the
configuration tables and the make-divisible-by-8 width rule.
``data_format`` is the internal layout ("auto": NHWC on the card); the
forward takes NCHW."""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.layer.layers import placement
from ._common import no_pretrained, resolve_format, stem_format, to_public

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNAct(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, groups=1, act=None,
                 df="NCHW", stem=False):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=(k - 1) // 2,
                              groups=groups, bias_attr=False,
                              data_format=stem_format(df) if stem else df)
        # the reference pins the batch norm's epsilon 0.001, momentum 0.99
        self.bn = nn.BatchNorm2D(out_c, epsilon=0.001, momentum=0.99, data_format=df)
        self.act = act() if act is not None else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class _SqueezeExcitation(nn.Layer):
    """Global pool, fc1, relu, fc2, hard-sigmoid gate on ``x``."""

    def __init__(self, c, squeeze_c, df):
        super().__init__()
        self.avgpool = nn.AdaptiveAvgPool2D(1, data_format=df)
        self.fc1 = nn.Conv2D(c, squeeze_c, 1, data_format=df)
        self.fc2 = nn.Conv2D(squeeze_c, c, 1, data_format=df)
        self.activation = nn.ReLU()
        self.scale_activation = nn.Hardsigmoid()

    def forward(self, x):
        s = self.activation(self.fc1(self.avgpool(x)))
        return self.scale_activation(self.fc2(s)) * x


class _InvertedResidual(nn.Layer):
    def __init__(self, in_c, exp_c, out_c, k, stride, use_se, act, df):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        self.expand = _ConvBNAct(in_c, exp_c, 1, act=act, df=df) if in_c != exp_c else None
        self.bottleneck = _ConvBNAct(exp_c, exp_c, k, stride, groups=exp_c, act=act, df=df)
        self.se = _SqueezeExcitation(exp_c, _make_divisible(exp_c // 4), df) if use_se \
            else None
        self.linear = _ConvBNAct(exp_c, out_c, 1, act=None, df=df)

    def forward(self, x):
        y = x if self.expand is None else self.expand(x)
        y = self.bottleneck(y)
        if self.se is not None:
            y = self.se(y)
        y = self.linear(y)
        return x + y if self.use_res else y


# (in, kernel, expanded, out, use_se, activation, stride) at scale 1.0
_SMALL = [
    (16, 3, 16, 16, True, "relu", 2),
    (16, 3, 72, 24, False, "relu", 2),
    (24, 3, 88, 24, False, "relu", 1),
    (24, 5, 96, 40, True, "hardswish", 2),
    (40, 5, 240, 40, True, "hardswish", 1),
    (40, 5, 240, 40, True, "hardswish", 1),
    (40, 5, 120, 48, True, "hardswish", 1),
    (48, 5, 144, 48, True, "hardswish", 1),
    (48, 5, 288, 96, True, "hardswish", 2),
    (96, 5, 576, 96, True, "hardswish", 1),
    (96, 5, 576, 96, True, "hardswish", 1),
]
_LARGE = [
    (16, 3, 16, 16, False, "relu", 1),
    (16, 3, 64, 24, False, "relu", 2),
    (24, 3, 72, 24, False, "relu", 1),
    (24, 5, 72, 40, True, "relu", 2),
    (40, 5, 120, 40, True, "relu", 1),
    (40, 5, 120, 40, True, "relu", 1),
    (40, 3, 240, 80, False, "hardswish", 2),
    (80, 3, 200, 80, False, "hardswish", 1),
    (80, 3, 184, 80, False, "hardswish", 1),
    (80, 3, 184, 80, False, "hardswish", 1),
    (80, 3, 480, 112, True, "hardswish", 1),
    (112, 3, 672, 112, True, "hardswish", 1),
    (112, 5, 672, 160, True, "hardswish", 2),
    (160, 5, 960, 160, True, "hardswish", 1),
    (160, 5, 960, 160, True, "hardswish", 1),
]
_ACTS = {"relu": nn.ReLU, "hardswish": nn.Hardswish}


class _MobileNetV3(nn.Layer):
    def __init__(self, table, last_channel_base, scale, num_classes, with_pool,
                 data_format, generator=None, device=None):
        super().__init__()
        self._place(device, generator)
        self.data_format = df = resolve_format(data_format, self._home())
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def adj(c):
            return _make_divisible(c * scale)

        first_c, last_in = adj(table[0][0]), adj(table[-1][3])
        last_out = last_in * 6
        self.last_channel = _make_divisible(last_channel_base * scale)
        with placement(self._device, self._generator):
            self.conv = _ConvBNAct(3, first_c, 3, 2, act=nn.Hardswish, df=df, stem=True)
            self.blocks = nn.Sequential(*[
                _InvertedResidual(adj(i), adj(e), adj(o), k, s, se, _ACTS[a], df)
                for (i, k, e, o, se, a, s) in table])
            self.lastconv = _ConvBNAct(last_in, last_out, 1, act=nn.Hardswish, df=df)
            self._out_c = last_out
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D(1, data_format=df)
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Linear(last_out, self.last_channel), nn.Hardswish(),
                    nn.Dropout(p=0.2), nn.Linear(self.last_channel, num_classes))

    def forward(self, x):
        x = self.lastconv(self.blocks(self.conv(x)))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            return self.classifier(torch.flatten(x, 1))
        return to_public(x, self.data_format)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, data_format: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(_SMALL, 1024, scale, num_classes, with_pool, data_format,
                         generator, device)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, data_format: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(_LARGE, 1280, scale, num_classes, with_pool, data_format,
                         generator, device)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
