"""ShuffleNetV2 (port of the reference's ``vision/models/shufflenetv2.py``):
channel-split units with a channel shuffle, the stage table by width
``scale``, and the swish variant.  ``data_format`` is the internal layout
("auto": NHWC on the card; ``F.channel_shuffle`` runs in either); the
forward takes NCHW."""

from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn import functional as F
from ...nn.layer.layers import placement
from ._common import no_pretrained, resolve_format, stem_format, to_public

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: [-1, 24, 24, 48, 96, 512],
    0.33: [-1, 24, 32, 64, 128, 512],
    0.5: [-1, 24, 48, 96, 192, 1024],
    1.0: [-1, 24, 116, 232, 464, 1024],
    1.5: [-1, 24, 176, 352, 704, 1024],
    2.0: [-1, 24, 224, 488, 976, 2048],
}
_STAGE_REPEATS = [4, 8, 4]


def _act_layer(act):
    if act == "swish":
        return nn.Silu
    if act == "relu":
        return nn.ReLU
    if act is None:
        return None
    raise ValueError(f"unsupported activation: {act!r}")


class _ConvBN(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, pad=0, groups=1, act=nn.ReLU,
                 df="NCHW", stem=False):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=pad, groups=groups,
                              bias_attr=False, data_format=stem_format(df) if stem else df)
        self.bn = nn.BatchNorm2D(out_c, data_format=df)
        self.act = act() if act is not None else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class _InvertedResidual(nn.Layer):
    """Stride-1 unit: split the channels, transform one half, shuffle."""

    def __init__(self, in_c, out_c, act, df):
        super().__init__()
        h = out_c // 2
        self.pw = _ConvBN(in_c // 2, h, 1, act=act, df=df)
        self.dw = _ConvBN(h, h, 3, 1, 1, groups=h, act=None, df=df)
        self.linear = _ConvBN(h, h, 1, act=act, df=df)
        self._df = df

    def forward(self, x):
        axis = 3 if self._df == "NHWC" else 1
        x1, x2 = x.chunk(2, axis)
        x2 = self.linear(self.dw(self.pw(x2)))
        return F.channel_shuffle(torch.cat([x1, x2], axis), 2, data_format=self._df)


class _InvertedResidualDS(nn.Layer):
    """Stride-2 unit: both branches transform, then shuffle."""

    def __init__(self, in_c, out_c, act, df):
        super().__init__()
        h = out_c // 2
        self.dw1 = _ConvBN(in_c, in_c, 3, 2, 1, groups=in_c, act=None, df=df)
        self.linear1 = _ConvBN(in_c, h, 1, act=act, df=df)
        self.pw2 = _ConvBN(in_c, h, 1, act=act, df=df)
        self.dw2 = _ConvBN(h, h, 3, 2, 1, groups=h, act=None, df=df)
        self.linear2 = _ConvBN(h, h, 1, act=act, df=df)
        self._df = df

    def forward(self, x):
        axis = 3 if self._df == "NHWC" else 1
        x1 = self.linear1(self.dw1(x))
        x2 = self.linear2(self.dw2(self.pw2(x)))
        return F.channel_shuffle(torch.cat([x1, x2], axis), 2, data_format=self._df)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale: float = 1.0, act: str = "relu", num_classes: int = 1000,
                 with_pool: bool = True, data_format: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(f"scale {scale} not implemented; choose from {sorted(_STAGE_OUT)}")
        self._place(device, generator)
        self.data_format = df = resolve_format(data_format, self._home())
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        out_c = _STAGE_OUT[scale]
        a = _act_layer(act)
        with placement(self._device, self._generator):
            self.conv1 = _ConvBN(3, out_c[1], 3, 2, 1, act=a, df=df, stem=True)
            self.max_pool = nn.MaxPool2D(3, stride=2, padding=1, data_format=df)
            blocks = []
            for stage, reps in enumerate(_STAGE_REPEATS):
                blocks.append(_InvertedResidualDS(out_c[stage + 1], out_c[stage + 2], a, df))
                for _ in range(reps - 1):
                    blocks.append(_InvertedResidual(out_c[stage + 2], out_c[stage + 2], a, df))
            self.blocks = nn.Sequential(*blocks)
            self.last_conv = _ConvBN(out_c[-2], out_c[-1], 1, act=a, df=df)
            self._out_c = out_c[-1]
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D(1, data_format=df)
            if num_classes > 0:
                self.fc = nn.Linear(out_c[-1], num_classes)

    def forward(self, x):
        x = self.last_conv(self.blocks(self.max_pool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            return self.fc(torch.flatten(x, 1))
        return to_public(x, self.data_format)


def _shufflenet(pretrained, **kwargs) -> ShuffleNetV2:
    no_pretrained(pretrained)
    return ShuffleNetV2(**kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(pretrained, scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(pretrained, scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(pretrained, scale=0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(pretrained, scale=1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(pretrained, scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(pretrained, scale=2.0, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(pretrained, scale=1.0, act="swish", **kwargs)
