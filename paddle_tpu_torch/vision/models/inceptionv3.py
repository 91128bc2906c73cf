"""Inception v3 (port of the reference's ``vision/models/inceptionv3.py``):
the stem, then the A, B, C, D and E blocks with factorized 1x7/7x1 and
1x3/3x1 convolutions, no auxiliary head.  ``data_format`` is the internal
layout ("auto": NHWC on the card); the forward takes NCHW (299 x 299 in
the published configuration)."""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.layer.layers import placement
from ._common import no_pretrained, resolve_format, stem_format, to_public

__all__ = ["InceptionV3", "inception_v3"]


class _ConvBN(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, pad=0, df="NCHW", stem=False):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=pad, bias_attr=False,
                              data_format=stem_format(df) if stem else df)
        self.bn = nn.BatchNorm2D(out_c, epsilon=0.001, data_format=df)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


def _cat(tensors, df):
    return torch.cat(tensors, 3 if df == "NHWC" else 1)


class _Stem(nn.Layer):
    def __init__(self, df):
        super().__init__()
        self.c1 = _ConvBN(3, 32, 3, 2, df=df, stem=True)
        self.c2 = _ConvBN(32, 32, 3, df=df)
        self.c3 = _ConvBN(32, 64, 3, pad=1, df=df)
        self.pool = nn.MaxPool2D(3, stride=2, data_format=df)
        self.c4 = _ConvBN(64, 80, 1, df=df)
        self.c5 = _ConvBN(80, 192, 3, df=df)

    def forward(self, x):
        x = self.pool(self.c3(self.c2(self.c1(x))))
        return self.pool(self.c5(self.c4(x)))


class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_features, df):
        super().__init__()
        self.b1 = _ConvBN(in_c, 64, 1, df=df)
        self.b5_1 = _ConvBN(in_c, 48, 1, df=df)
        self.b5_2 = _ConvBN(48, 64, 5, pad=2, df=df)
        self.b3_1 = _ConvBN(in_c, 64, 1, df=df)
        self.b3_2 = _ConvBN(64, 96, 3, pad=1, df=df)
        self.b3_3 = _ConvBN(96, 96, 3, pad=1, df=df)
        self.pool = nn.AvgPool2D(3, stride=1, padding=1, exclusive=False, data_format=df)
        self.bp = _ConvBN(in_c, pool_features, 1, df=df)
        self._df = df

    def forward(self, x):
        return _cat([self.b1(x), self.b5_2(self.b5_1(x)),
                     self.b3_3(self.b3_2(self.b3_1(x))), self.bp(self.pool(x))], self._df)


class _InceptionB(nn.Layer):
    def __init__(self, in_c, df):
        super().__init__()
        self.b3 = _ConvBN(in_c, 384, 3, 2, df=df)
        self.d1 = _ConvBN(in_c, 64, 1, df=df)
        self.d2 = _ConvBN(64, 96, 3, pad=1, df=df)
        self.d3 = _ConvBN(96, 96, 3, 2, df=df)
        self.pool = nn.MaxPool2D(3, stride=2, data_format=df)
        self._df = df

    def forward(self, x):
        return _cat([self.b3(x), self.d3(self.d2(self.d1(x))), self.pool(x)], self._df)


class _InceptionC(nn.Layer):
    def __init__(self, in_c, c7, df):
        super().__init__()
        self.b1 = _ConvBN(in_c, 192, 1, df=df)
        self.b7_1 = _ConvBN(in_c, c7, 1, df=df)
        self.b7_2 = _ConvBN(c7, c7, (1, 7), pad=(0, 3), df=df)
        self.b7_3 = _ConvBN(c7, 192, (7, 1), pad=(3, 0), df=df)
        self.d1 = _ConvBN(in_c, c7, 1, df=df)
        self.d2 = _ConvBN(c7, c7, (7, 1), pad=(3, 0), df=df)
        self.d3 = _ConvBN(c7, c7, (1, 7), pad=(0, 3), df=df)
        self.d4 = _ConvBN(c7, c7, (7, 1), pad=(3, 0), df=df)
        self.d5 = _ConvBN(c7, 192, (1, 7), pad=(0, 3), df=df)
        self.pool = nn.AvgPool2D(3, stride=1, padding=1, exclusive=False, data_format=df)
        self.bp = _ConvBN(in_c, 192, 1, df=df)
        self._df = df

    def forward(self, x):
        return _cat([self.b1(x), self.b7_3(self.b7_2(self.b7_1(x))),
                     self.d5(self.d4(self.d3(self.d2(self.d1(x))))),
                     self.bp(self.pool(x))], self._df)


class _InceptionD(nn.Layer):
    def __init__(self, in_c, df):
        super().__init__()
        self.b3_1 = _ConvBN(in_c, 192, 1, df=df)
        self.b3_2 = _ConvBN(192, 320, 3, 2, df=df)
        self.b7_1 = _ConvBN(in_c, 192, 1, df=df)
        self.b7_2 = _ConvBN(192, 192, (1, 7), pad=(0, 3), df=df)
        self.b7_3 = _ConvBN(192, 192, (7, 1), pad=(3, 0), df=df)
        self.b7_4 = _ConvBN(192, 192, 3, 2, df=df)
        self.pool = nn.MaxPool2D(3, stride=2, data_format=df)
        self._df = df

    def forward(self, x):
        return _cat([self.b3_2(self.b3_1(x)), self.b7_4(self.b7_3(self.b7_2(self.b7_1(x)))),
                     self.pool(x)], self._df)


class _InceptionE(nn.Layer):
    def __init__(self, in_c, df):
        super().__init__()
        self.b1 = _ConvBN(in_c, 320, 1, df=df)
        self.b3_1 = _ConvBN(in_c, 384, 1, df=df)
        self.b3_2a = _ConvBN(384, 384, (1, 3), pad=(0, 1), df=df)
        self.b3_2b = _ConvBN(384, 384, (3, 1), pad=(1, 0), df=df)
        self.d1 = _ConvBN(in_c, 448, 1, df=df)
        self.d2 = _ConvBN(448, 384, 3, pad=1, df=df)
        self.d3a = _ConvBN(384, 384, (1, 3), pad=(0, 1), df=df)
        self.d3b = _ConvBN(384, 384, (3, 1), pad=(1, 0), df=df)
        self.pool = nn.AvgPool2D(3, stride=1, padding=1, exclusive=False, data_format=df)
        self.bp = _ConvBN(in_c, 192, 1, df=df)
        self._df = df

    def forward(self, x):
        b3 = self.b3_1(x)
        d = self.d2(self.d1(x))
        return _cat([self.b1(x), _cat([self.b3_2a(b3), self.b3_2b(b3)], self._df),
                     _cat([self.d3a(d), self.d3b(d)], self._df), self.bp(self.pool(x))],
                    self._df)


class InceptionV3(nn.Layer):
    def __init__(self, num_classes: int = 1000, with_pool: bool = True,
                 data_format: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._place(device, generator)
        self.data_format = df = resolve_format(data_format, self._home())
        self.num_classes = num_classes
        self.with_pool = with_pool
        with placement(self._device, self._generator):
            self.stem = _Stem(df)
            blocks = [_InceptionA(in_c, pf, df) for in_c, pf in zip([192, 256, 288],
                                                                    [32, 64, 64])]
            blocks.append(_InceptionB(288, df))
            blocks += [_InceptionC(768, c7, df) for c7 in [128, 160, 160, 192]]
            blocks.append(_InceptionD(768, df))
            blocks += [_InceptionE(in_c, df) for in_c in [1280, 2048]]
            self.blocks = nn.Sequential(*blocks)
            self._out_c = 2048
            if with_pool:
                self.avg_pool = nn.AdaptiveAvgPool2D(1, data_format=df)
            if num_classes > 0:
                self.dropout = nn.Dropout(0.2)
                self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avg_pool(x)
        if self.num_classes > 0:
            return self.fc(self.dropout(torch.flatten(x, 1)))
        return to_public(x, self.data_format)


def inception_v3(pretrained: bool = False, **kwargs) -> InceptionV3:
    no_pretrained(pretrained)
    return InceptionV3(**kwargs)
