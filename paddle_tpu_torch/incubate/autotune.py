"""Auto-tuning configuration (port of the reference's
``incubate/autotune.py``).

Of the reference's three sections only ``layout`` is read:
:func:`resolve_conv_data_format` gives the activation layout that
conv-stack models built with ``data_format="auto"`` (the vision ResNets)
use.  An explicit ``layout.data_format`` wins on any device; with layout
tuning disabled it is NCHW; otherwise it is the layout measured faster
on the device the model is built on.  On the CPU that is NCHW (the
reference's "elsewhere").  On the card it is :data:`CARD_LAYOUT`, the
layout in which ResNet-50's bf16 forward at batch 128 ran faster on an
H100 (``chip_smoke.py`` ``phase_resnet`` times both; PERF.md gives the
times with the card's power limit).  The reference's TPU choice (NHWC,
from a v5e measurement) does not carry over.  ``kernel`` (the kernel
choice is the flags') and ``dataloader`` are recorded only, as in the
reference.
"""

from __future__ import annotations

import json
from typing import Optional

import torch

from ..device import resolve_device

__all__ = ["set_config", "get_config", "resolve_conv_data_format"]

CARD_LAYOUT = "NHWC"

_config = {
    "kernel": {"enable": False, "tuning_range": [1, 10]},
    "layout": {"enable": True, "data_format": None},
    "dataloader": {"enable": False},
}


def set_config(config: Optional[dict] = None) -> None:
    """Take the reference's dict or a JSON file's path; None enables every
    section.  An unknown section or key raises."""
    if config is None:
        for section in _config.values():
            section["enable"] = True
        return
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise TypeError("config must be None, a dict, or a JSON file path")
    for key, val in config.items():
        if key not in _config:
            raise ValueError(f"unknown autotune section {key!r}; known: {sorted(_config)}")
        if not isinstance(val, dict):
            raise ValueError(f"autotune section {key!r} must map to a dict of options, got "
                             f"{type(val).__name__}")
        unknown = set(val) - set(_config[key])
        if unknown:
            raise ValueError(f"unknown key(s) {sorted(unknown)} in autotune section {key!r}; "
                             f"known: {sorted(_config[key])}")
        _config[key].update(val)


def get_config() -> dict:
    return {k: dict(v) for k, v in _config.items()}


def resolve_conv_data_format(*, device=None) -> str:
    """The activation layout for ``data_format="auto"`` on ``device`` (the
    default device if None): the ``layout.data_format`` override if set,
    else NCHW when layout tuning is off, else :data:`CARD_LAYOUT` on the
    card and NCHW on the CPU."""
    layout = _config["layout"]
    if layout.get("data_format"):
        df = str(layout["data_format"]).upper()
        if df not in ("NCHW", "NHWC"):
            raise ValueError(f"autotune layout.data_format must be NCHW/NHWC, got {df!r}")
        return df
    if not layout.get("enable", False):
        return "NCHW"
    on_card = resolve_device(device).type == "cuda"
    return CARD_LAYOUT if on_card else "NCHW"
