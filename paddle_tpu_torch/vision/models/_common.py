"""What the zoo's models share: the keyword-only ``device``/``generator``
of their constructors, and ``data_format="auto"`` resolved for the device
the model is built on (NHWC on the card, ``incubate.autotune.CARD_LAYOUT``;
NCHW on the CPU), as ResNet's."""

from __future__ import annotations

from typing import Optional

import torch

from ...incubate.autotune import resolve_conv_data_format


def home_of(device=None, generator: Optional[torch.Generator] = None):
    """The device a model is built on: ``device``, else its generator's,
    else None (the default device)."""
    if device is not None:
        return device
    return None if generator is None else generator.device


def resolve_format(data_format: str, device=None) -> str:
    if data_format == "auto":
        data_format = resolve_conv_data_format(device=device)
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW/NHWC/auto, got {data_format!r}")
    return data_format


def stem_format(df: str) -> str:
    """The first convolution's format: it takes the public NCHW batch and,
    under NHWC, gives NHWC."""
    return "NCHW:NHWC" if df == "NHWC" else df


def to_public(x: torch.Tensor, df: str) -> torch.Tensor:
    """An internal NHWC map viewed back as the public NCHW."""
    return x.permute(0, 3, 1, 2) if df == "NHWC" else x


def no_pretrained(pretrained: bool) -> None:
    if pretrained:
        raise NotImplementedError("no pretrained weight hub (zero egress): the port "
                                  "reads no network")
