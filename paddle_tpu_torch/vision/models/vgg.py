"""The VGG family (port of the reference's ``vision/models/vgg.py``):
configurations A/B/D/E (VGG-11/13/16/19), optional batch norms, a 7 x 7
adaptive pool and a 4096-4096 classifier with dropout.  ``data_format`` is
the internal layout ("auto": NHWC on the card); the forward takes NCHW."""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.layer.layers import placement
from ._common import home_of, no_pretrained, resolve_format, stem_format, to_public

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm: bool, df: str):
    layers, in_c, first = [], 3, True
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, stride=2, data_format=df))
            continue
        layers.append(nn.Conv2D(in_c, v, 3, padding=1,
                                data_format=stem_format(df) if first else df))
        if batch_norm:
            layers.append(nn.BatchNorm2D(v, data_format=df))
        layers.append(nn.ReLU())
        in_c, first = v, False
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    """The classifier over ``features`` (a layer stack in the internal
    layout ``data_format``)."""

    def __init__(self, features: nn.Layer, num_classes: int = 1000,
                 with_pool: bool = True, data_format: str = "NCHW", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._place(device, generator)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format
        with placement(self._device, self._generator):
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                    nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                    nn.Linear(4096, num_classes))

    def forward(self, x):
        x = to_public(self.features(x), self.data_format)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg: str, batch_norm: bool, pretrained: bool, **kwargs) -> VGG:
    no_pretrained(pretrained)
    device, generator = kwargs.pop("device", None), kwargs.pop("generator", None)
    df = resolve_format(kwargs.pop("data_format", "auto"), home_of(device, generator))
    with placement(device, generator):
        features = _make_layers(_CFGS[cfg], batch_norm, df)
    return VGG(features, data_format=df, generator=generator, device=device, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs) -> VGG:
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs) -> VGG:
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs) -> VGG:
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs) -> VGG:
    return _vgg("E", batch_norm, pretrained, **kwargs)
