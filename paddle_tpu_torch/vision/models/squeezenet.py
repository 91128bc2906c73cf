"""SqueezeNet 1.0 and 1.1 (port of the reference's
``vision/models/squeezenet.py``): fire modules (a 1x1 squeeze into 1x1 and
3x3 expands, concatenated) and a convolutional classifier.  ``data_format``
is the internal layout ("auto": NHWC on the card); the forward takes NCHW."""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.layer.layers import placement
from ._common import no_pretrained, resolve_format, stem_format, to_public

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(nn.Layer):
    def __init__(self, in_c, squeeze, e1, e3, df):
        super().__init__()
        self.squeeze = nn.Conv2D(in_c, squeeze, 1, data_format=df)
        self.e1 = nn.Conv2D(squeeze, e1, 1, data_format=df)
        self.e3 = nn.Conv2D(squeeze, e3, 3, padding=1, data_format=df)
        self.relu = nn.ReLU()
        self._axis = 3 if df == "NHWC" else 1

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.e1(s)), self.relu(self.e3(s))], self._axis)


class SqueezeNet(nn.Layer):
    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 with_pool: bool = True, data_format: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise ValueError(f"version must be '1.0' or '1.1', got {version!r}")
        self._place(device, generator)
        self.data_format = df = resolve_format(data_format, self._home())
        self.num_classes = num_classes
        self.with_pool = with_pool
        relu = nn.ReLU

        def pool():
            return nn.MaxPool2D(3, stride=2, data_format=df)

        with placement(self._device, self._generator):
            if version == "1.0":
                self.features = nn.Sequential(
                    nn.Conv2D(3, 96, 7, stride=2, data_format=stem_format(df)), relu(),
                    pool(),
                    _Fire(96, 16, 64, 64, df), _Fire(128, 16, 64, 64, df),
                    _Fire(128, 32, 128, 128, df), pool(),
                    _Fire(256, 32, 128, 128, df), _Fire(256, 48, 192, 192, df),
                    _Fire(384, 48, 192, 192, df), _Fire(384, 64, 256, 256, df),
                    pool(),
                    _Fire(512, 64, 256, 256, df))
            else:
                self.features = nn.Sequential(
                    nn.Conv2D(3, 64, 3, stride=2, data_format=stem_format(df)), relu(),
                    pool(),
                    _Fire(64, 16, 64, 64, df), _Fire(128, 16, 64, 64, df),
                    pool(),
                    _Fire(128, 32, 128, 128, df), _Fire(256, 32, 128, 128, df),
                    pool(),
                    _Fire(256, 48, 192, 192, df), _Fire(384, 48, 192, 192, df),
                    _Fire(384, 64, 256, 256, df), _Fire(512, 64, 256, 256, df))
            if num_classes > 0:
                self.classifier_conv = nn.Conv2D(512, num_classes, 1, data_format=df)
                self.dropout = nn.Dropout(0.5)
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(
                    (1, 1), data_format=df if num_classes > 0 else "NCHW")

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            # the classifier convolution runs in the internal layout
            x = self.classifier_conv(self.dropout(x))
            if self.with_pool:
                x = self.pool(x)
            return torch.flatten(to_public(x, self.data_format), 1)
        x = to_public(x, self.data_format)
        if self.with_pool:
            x = self.pool(x)
        return x


def squeezenet1_0(pretrained=False, **kwargs) -> SqueezeNet:
    no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs) -> SqueezeNet:
    no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
