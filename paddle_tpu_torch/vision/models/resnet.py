"""The ResNet family (port of the reference's ``vision/models/resnet.py``):
``BasicBlock``, ``BottleneckBlock``, ``ResNet`` and its ten constructors,
with the reference's layer tree and names, so a state dict crosses between
the packages as it is (``resnet50()`` has 267 entries, the batch norms'
running statistics ``_mean``/``_variance`` among them).

``data_format`` is the internal activation layout: "NCHW", "NHWC", or
"auto" (default), which :func:`~paddle_tpu_torch.incubate.autotune.
resolve_conv_data_format` resolves for the device the model is built on.
The public contract is the reference's in every layout: the forward takes
an NCHW image batch, and features and logits leave in NCHW; the weights
keep paddle's layouts.  Under NHWC the stem convolution takes the NCHW
batch and gives NHWC ("NCHW:NHWC"), so the body runs on channels_last
memory (cuDNN's NHWC kernels on the card), and the [N, 7, 7, C] map is
viewed back as NCHW before the pool.

The model is built on ``device`` (the default device, the card unless the
caller asked for the CPU) with weights drawn from ``generator`` (the
device's global generator if None); both are the port's keyword-only
arguments, taken by the constructors through ``**kwargs``.  There are no
pretrained weights: ``pretrained=True`` raises, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...incubate.autotune import resolve_conv_data_format
from ...nn.layer.layers import placement

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d", "resnext101_64x4d"]


class BasicBlock(nn.Layer):
    """Two 3x3 convolutions with batch norms and a residual (ResNet-18/34)."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, data_format="NCHW"):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1 and base_width=64 "
                             "(use BottleneckBlock depths for ResNeXt/wide variants)")
        df = data_format
        norm_layer = norm_layer or (lambda c: nn.BatchNorm2D(c, data_format=df))
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, data_format=df)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False, data_format=df)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    """1x1, 3x3 (grouped for ResNeXt), 1x1 convolutions with batch norms
    and a residual; the output has 4x ``planes`` channels."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, data_format="NCHW"):
        super().__init__()
        df = data_format
        norm_layer = norm_layer or (lambda c: nn.BatchNorm2D(c, data_format=df))
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, data_format=df)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation, stride=stride,
                               groups=groups, dilation=dilation, bias_attr=False,
                               data_format=df)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1, bias_attr=False,
                               data_format=df)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """ResNet of ``depth`` (18, 34, 50, 101, 152) with ``block``;
    ``width`` is the bottleneck's base width (64; 128 wide, 4 ResNeXt),
    ``groups`` its 3x3 groups; ``with_pool`` the global average pool,
    ``num_classes`` > 0 the classifier.  ``data_format`` is the internal
    layout (see the module's docstring)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True,
                 groups=1, data_format="auto", *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self._place(device, generator)
        if data_format == "auto":
            data_format = resolve_conv_data_format(device=self._home())
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW/NHWC/auto, got {data_format!r}")
        self.data_format = df = data_format
        self.groups, self.base_width = groups, width
        self.num_classes, self.with_pool = num_classes, with_pool
        self.inplanes, self.dilation = 64, 1
        with placement(self._device, self._generator):
            self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3, bias_attr=False,
                                   data_format="NCHW:NHWC" if df == "NHWC" else df)
            self.bn1 = nn.BatchNorm2D(self.inplanes, data_format=df)
            self.relu = nn.ReLU()
            self.maxpool = nn.MaxPool2D(3, stride=2, padding=1, data_format=df)
            self.layer1 = self._make_layer(block, 64, layers[0])
            self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
            self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
            self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        df = self.data_format

        def norm_layer(c):
            return nn.BatchNorm2D(c, data_format=df)

        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride,
                          bias_attr=False, data_format=df),
                norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, norm_layer=norm_layer, data_format=df)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, norm_layer=norm_layer,
                                data_format=df))
        return nn.Sequential(*layers)

    def forward(self, x):
        """x [N, 3, H, W] (NCHW in every layout) to logits [N, num_classes],
        or to the NCHW features without the classifier."""
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.data_format == "NHWC":
            x = x.permute(0, 3, 1, 2)   # back to the public NCHW, as a view
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights: the port reads no network")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    """ResNet-50 (He et al. 2016, Table 1): bottleneck blocks [3, 4, 6, 3],
    25.56 M parameters at 1000 classes."""
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=32, width=4, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=64, width=4, **kwargs)
