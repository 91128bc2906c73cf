"""DenseNet (port of the reference's ``vision/models/densenet.py``):
pre-activation dense layers (BN, ReLU, 1x1 conv, then BN, ReLU, 3x3
conv) whose outputs are concatenated, half-width transitions, the depth
table of 121/161/169/201/264.  ``data_format`` is the internal layout
("auto": NHWC on the card); the forward takes NCHW.  ``dropout`` > 0 puts
a dropout after each dense layer."""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.layer.layers import placement
from ._common import no_pretrained, resolve_format, stem_format, to_public

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_SPEC = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class _BNReluConv(nn.Layer):
    """Pre-activation unit: BN, ReLU, convolution."""

    def __init__(self, in_c, out_c, k, stride=1, pad=0, df="NCHW"):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_c, data_format=df)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=pad,
                              bias_attr=False, data_format=df)

    def forward(self, x):
        return self.conv(self.relu(self.bn(x)))


class _DenseLayer(nn.Layer):
    def __init__(self, in_c, growth, bn_size, dropout, df):
        super().__init__()
        self.f1 = _BNReluConv(in_c, bn_size * growth, 1, df=df)
        self.f2 = _BNReluConv(bn_size * growth, growth, 3, pad=1, df=df)
        self.dropout = nn.Dropout(dropout) if dropout else None
        self._axis = 3 if df == "NHWC" else 1

    def forward(self, x):
        y = self.f2(self.f1(x))
        if self.dropout is not None:
            y = self.dropout(y)
        return torch.cat([x, y], self._axis)


class _Transition(nn.Layer):
    def __init__(self, in_c, out_c, df):
        super().__init__()
        self.conv = _BNReluConv(in_c, out_c, 1, df=df)
        self.pool = nn.AvgPool2D(2, stride=2, data_format=df)

    def forward(self, x):
        return self.pool(self.conv(x))


class DenseNet(nn.Layer):
    def __init__(self, layers: int = 121, bn_size: int = 4, dropout: float = 0.0,
                 num_classes: int = 1000, with_pool: bool = True, data_format: str = "auto",
                 *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if layers not in _SPEC:
            raise ValueError(f"supported layers are {sorted(_SPEC)}, got {layers}")
        self._place(device, generator)
        self.data_format = df = resolve_format(data_format, self._home())
        self.num_classes = num_classes
        self.with_pool = with_pool
        init_c, growth, block_config = _SPEC[layers]
        with placement(self._device, self._generator):
            self.stem_conv = nn.Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False,
                                       data_format=stem_format(df))
            self.stem_bn = nn.BatchNorm2D(init_c, data_format=df)
            self.stem_relu = nn.ReLU()
            self.stem_pool = nn.MaxPool2D(3, stride=2, padding=1, data_format=df)
            blocks, c = [], init_c
            for i, n_layers in enumerate(block_config):
                for _ in range(n_layers):
                    blocks.append(_DenseLayer(c, growth, bn_size, dropout, df))
                    c += growth
                if i != len(block_config) - 1:
                    blocks.append(_Transition(c, c // 2, df))
                    c //= 2
            self.blocks = nn.Sequential(*blocks)
            self.final_bn = nn.BatchNorm2D(c, data_format=df)
            self.final_relu = nn.ReLU()
            self._out_c = c
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1, data_format=df)
            if num_classes > 0:
                self.out = nn.Linear(c, num_classes)

    def forward(self, x):
        x = self.stem_pool(self.stem_relu(self.stem_bn(self.stem_conv(x))))
        x = self.final_relu(self.final_bn(self.blocks(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            return self.out(torch.flatten(x, 1))
        return to_public(x, self.data_format)


def _densenet(layers, pretrained, **kwargs) -> DenseNet:
    no_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs) -> DenseNet:
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs) -> DenseNet:
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs) -> DenseNet:
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs) -> DenseNet:
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs) -> DenseNet:
    return _densenet(264, pretrained, **kwargs)
