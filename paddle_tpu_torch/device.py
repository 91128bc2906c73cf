"""Where the port's tensors live.

The port serves on the CUDA card: with no device named, every entry point
resolves to ``cuda``.  The CPU is used only when the caller asks for it,
with :func:`set_device` or a ``device="cpu"`` argument.  Without a CUDA
device and without that request an entry point raises; it never runs on the
CPU quietly, so a missing card cannot pass for a slow one.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

__all__ = ["set_device", "get_device", "resolve_device", "devices"]

DeviceLike = Union[str, torch.device, None]

_default: Optional[torch.device] = None   # set_device's choice; None = cuda


def set_device(device: DeviceLike) -> Optional[torch.device]:
    """Set the process default (``"cuda"``, ``"cuda:1"``, ``"cpu"``);
    raises for a CUDA device when there is none.  ``None`` restores the
    card default."""
    global _default
    _default = None if device is None else resolve_device(device)
    return _default


def get_device() -> torch.device:
    """The default device; raises when it is the card and there is none."""
    return resolve_device()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` if given, else the default; a CUDA device must exist."""
    if device is not None:
        dev = torch.device(device)
    else:
        dev = _default if _default is not None else torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on the CUDA card by default, and no CUDA "
            "device is available. To run on the CPU, ask for it: "
            "paddle_tpu_torch.set_device('cpu'), or pass device='cpu'.")
    return dev


def devices(kind: Optional[str] = None) -> List[torch.device]:
    """The devices of ``kind`` (``"cuda"`` or ``"cpu"``) this process sees,
    the counterpart of ``jax.devices()``: every visible card, each with its
    index, or the one CPU.  Without ``kind``, the default device's type;
    asking for cards where there are none raises."""
    kind = kind or resolve_device().type
    if kind == "cpu":
        return [torch.device("cpu")]
    resolve_device(kind)
    return [torch.device(kind, i) for i in range(torch.cuda.device_count())]
