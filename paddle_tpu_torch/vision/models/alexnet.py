"""AlexNet (port of the reference's ``vision/models/alexnet.py``): five
convolutions with three max pools, and a 4096-4096 classifier with
dropout.  ``data_format`` is the internal layout ("auto": NHWC on the card,
see ``_common``); the forward takes NCHW and the classifier reads the
features in NCHW order in every layout."""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.layer.layers import placement
from ._common import no_pretrained, resolve_format, stem_format, to_public

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Layer):
    def __init__(self, num_classes: int = 1000, data_format: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._place(device, generator)
        self.data_format = df = resolve_format(data_format, self._home())
        self.num_classes = num_classes
        with placement(self._device, self._generator):
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 11, stride=4, padding=2, data_format=stem_format(df)),
                nn.ReLU(),
                nn.MaxPool2D(3, stride=2, data_format=df),
                nn.Conv2D(64, 192, 5, padding=2, data_format=df),
                nn.ReLU(),
                nn.MaxPool2D(3, stride=2, data_format=df),
                nn.Conv2D(192, 384, 3, padding=1, data_format=df),
                nn.ReLU(),
                nn.Conv2D(384, 256, 3, padding=1, data_format=df),
                nn.ReLU(),
                nn.Conv2D(256, 256, 3, padding=1, data_format=df),
                nn.ReLU(),
                nn.MaxPool2D(3, stride=2, data_format=df))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(0.5), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                    nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
                    nn.Linear(4096, num_classes))

    def forward(self, x):
        x = to_public(self.features(x), self.data_format)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def alexnet(pretrained: bool = False, **kwargs) -> AlexNet:
    no_pretrained(pretrained)
    return AlexNet(**kwargs)
