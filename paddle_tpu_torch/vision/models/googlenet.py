"""GoogLeNet, Inception v1 (port of the reference's
``vision/models/googlenet.py``): bias-free convolutions without batch
norm, ReLU after each inception block's concatenation, and two auxiliary
heads off ``ince4a`` and ``ince4d`` (their classifiers fit 224 x 224
input only); the forward returns ``[out, aux1, aux2]``.  ``data_format``
is the internal layout ("auto": NHWC on the card); the forward takes NCHW."""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.layer.layers import placement
from ._common import no_pretrained, resolve_format, stem_format, to_public

__all__ = ["GoogLeNet", "googlenet"]


class _Conv(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, df="NCHW", stem=False):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=(k - 1) // 2,
                              bias_attr=False, data_format=stem_format(df) if stem else df)

    def forward(self, x):
        return self.conv(x)


class _Inception(nn.Layer):
    def __init__(self, in_c, f1, f3r, f3, f5r, f5, proj, df):
        super().__init__()
        self.b1 = _Conv(in_c, f1, 1, df=df)
        self.b3r = _Conv(in_c, f3r, 1, df=df)
        self.b3 = _Conv(f3r, f3, 3, df=df)
        self.b5r = _Conv(in_c, f5r, 1, df=df)
        self.b5 = _Conv(f5r, f5, 5, df=df)
        self.pool = nn.MaxPool2D(3, stride=1, padding=1, data_format=df)
        self.bproj = _Conv(in_c, proj, 1, df=df)
        self.relu = nn.ReLU()
        self._axis = 3 if df == "NHWC" else 1

    def forward(self, x):
        cat = torch.cat([self.b1(x), self.b3(self.b3r(x)), self.b5(self.b5r(x)),
                         self.bproj(self.pool(x))], self._axis)
        return self.relu(cat)


class _AuxHead(nn.Layer):
    """5x5/3 average pool, 1x1 conv (128), fc 1152 -> 1024, ReLU, dropout, fc."""

    def __init__(self, in_c, num_classes, drop, df):
        super().__init__()
        self.pool = nn.AvgPool2D(5, stride=3, data_format=df)
        self.conv = _Conv(in_c, 128, 1, df=df)
        self.fc1 = nn.Linear(1152, 1024)
        self.relu = nn.ReLU()
        self.drop = nn.Dropout(drop)
        self.fc2 = nn.Linear(1024, num_classes)
        self._df = df

    def forward(self, x):
        x = to_public(self.conv(self.pool(x)), self._df)   # the fc reads NCHW order
        return self.fc2(self.drop(self.relu(self.fc1(torch.flatten(x, 1)))))


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes: int = 1000, with_pool: bool = True,
                 data_format: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._place(device, generator)
        self.data_format = df = resolve_format(data_format, self._home())
        self.num_classes = num_classes
        self.with_pool = with_pool
        with placement(self._device, self._generator):
            self.stem = _Conv(3, 64, 7, 2, df=df, stem=True)
            self.pool = nn.MaxPool2D(3, stride=2, data_format=df)
            self.conv1 = _Conv(64, 64, 1, df=df)
            self.conv2 = _Conv(64, 192, 3, df=df)
            self.ince3a = _Inception(192, 64, 96, 128, 16, 32, 32, df)
            self.ince3b = _Inception(256, 128, 128, 192, 32, 96, 64, df)
            self.ince4a = _Inception(480, 192, 96, 208, 16, 48, 64, df)
            self.ince4b = _Inception(512, 160, 112, 224, 24, 64, 64, df)
            self.ince4c = _Inception(512, 128, 128, 256, 24, 64, 64, df)
            self.ince4d = _Inception(512, 112, 144, 288, 32, 64, 64, df)
            self.ince4e = _Inception(528, 256, 160, 320, 32, 128, 128, df)
            self.ince5a = _Inception(832, 256, 160, 320, 32, 128, 128, df)
            self.ince5b = _Inception(832, 384, 192, 384, 48, 128, 128, df)
            if with_pool:
                self.pool5 = nn.AdaptiveAvgPool2D(1, data_format=df)
            if num_classes > 0:
                self.drop = nn.Dropout(0.4)
                self.fc_out = nn.Linear(1024, num_classes)
                self.aux1 = _AuxHead(512, num_classes, 0.7, df)
                self.aux2 = _AuxHead(528, num_classes, 0.7, df)

    def forward(self, x):
        x = self.pool(self.stem(x))
        x = self.pool(self.conv2(self.conv1(x)))
        x = self.pool(self.ince3b(self.ince3a(x)))
        ince4a = self.ince4a(x)
        x = self.ince4c(self.ince4b(ince4a))
        ince4d = self.ince4d(x)
        x = self.pool(self.ince4e(ince4d))
        out = self.ince5b(self.ince5a(x))
        if self.with_pool:
            out = self.pool5(out)
        if self.num_classes > 0:
            out = self.fc_out(self.drop(torch.flatten(out, 1)))
            return [out, self.aux1(ince4a), self.aux2(ince4d)]
        return [to_public(out, self.data_format), None, None]


def googlenet(pretrained: bool = False, **kwargs) -> GoogLeNet:
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
