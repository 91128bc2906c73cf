"""LeNet (port of the reference's ``vision/models/lenet.py``): two
convolution and pool stages into a three-layer classifier, for 28 x 28
single-channel images (MNIST).  The layer tree and names are the
reference's, so a state dict crosses between the packages as it is."""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.layer.layers import placement

__all__ = ["LeNet"]


class LeNet(nn.Layer):
    """``num_classes`` <= 0 returns the convolution features."""

    def __init__(self, num_classes: int = 10, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self._place(device, generator)
        self.num_classes = num_classes
        with placement(self._device, self._generator):
            self.features = nn.Sequential(
                nn.Conv2D(1, 6, 3, stride=1, padding=1),
                nn.ReLU(),
                nn.MaxPool2D(2, stride=2),
                nn.Conv2D(6, 16, 5, stride=1, padding=0),
                nn.ReLU(),
                nn.MaxPool2D(2, stride=2))
            if num_classes > 0:
                self.fc = nn.Sequential(
                    nn.Linear(400, 120), nn.Linear(120, 84),
                    nn.Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
