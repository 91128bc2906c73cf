"""Where the port's tensors live.

The port serves on the CUDA card: with no device named, every entry point
resolves to ``cuda``.  The CPU is used only when the caller asks for it,
with :func:`set_device` or a ``device="cpu"`` argument.  Without a CUDA
device and without that request an entry point raises; it never runs on the
CPU quietly, so a missing card cannot pass for a slow one.

The reference's device names are here too: :class:`Place` (a device
handle over ``torch.device``; paddle's ``gpu`` names the card),
:func:`CPUPlace`, :func:`CUDAPlace`, :class:`DeviceGuard`,
:func:`device_count`, :func:`synchronize`, :func:`current_device` and
:func:`get_all_devices`.  The reference's ``TPUPlace`` and ``XPUPlace`` name
its accelerator, so here they give the card's place.  Streams, events and
memory statistics wait for ROADMAP A10 and raise on use.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence, Union

import torch

__all__ = ["set_device", "get_device", "resolve_device", "devices", "HostArena", "Place",
           "CPUPlace", "CUDAPlace", "TPUPlace", "XPUPlace", "DeviceGuard", "device_count",
           "synchronize", "current_device", "get_all_devices", "is_compiled_with_tpu"]


class Place:
    """A device handle (the reference's ``Place``) over a ``torch.device``:
    ``platform`` is ``"gpu"`` for the card, ``"cpu"`` for the CPU."""

    def __init__(self, device):
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def platform(self) -> str:
        return "gpu" if self._device.type == "cuda" else self._device.type

    @property
    def index(self) -> int:
        return self._device.index or 0

    def __repr__(self) -> str:
        return f"Place({self.platform}:{self.index})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Place) and (self.platform, self.index) == \
            (other.platform, other.index)

    def __hash__(self) -> int:
        return hash((self.platform, self.index))


def CPUPlace(idx: int = 0) -> Place:
    return Place("cpu")


def CUDAPlace(idx: int = 0) -> Place:
    return Place(torch.device("cuda", idx))


TPUPlace = XPUPlace = CUDAPlace     # the reference's accelerator: the card here


DeviceLike = Union[str, torch.device, Place, None]

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
    """``device`` if given, else the default; a CUDA device must exist.
    A :class:`Place` or paddle's ``"gpu"``/``"gpu:N"`` names are taken too."""
    if isinstance(device, Place):
        device = device.device
    if isinstance(device, str) and device.startswith("gpu"):
        device = "cuda" + device[3:]
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


def current_device() -> Place:
    """The default device's :class:`Place`."""
    return Place(get_device())


def get_all_devices() -> List[str]:
    """``gpu:N`` for every visible card, then ``cpu:0``."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [f"gpu:{i}" for i in range(cards)] + ["cpu:0"]


def device_count(platform: Optional[str] = None) -> int:
    """The visible cards (``platform`` ``"gpu"``/``"cuda"``, or None when
    there are cards), or 1 for the CPU."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if platform in ("gpu", "cuda") or (platform is None and cards):
        return cards
    return 1


def is_compiled_with_tpu() -> bool:
    return False


class DeviceGuard:
    """Switch the default device inside a ``with`` block."""

    def __init__(self, device: DeviceLike):
        self._device = device
        self._saved: Optional[torch.device] = None

    def __enter__(self):
        self._saved = _default
        set_device(self._device)
        return self

    def __exit__(self, *exc):
        global _default
        _default = self._saved


def synchronize(device: DeviceLike = None) -> None:
    """Wait for the work queued on ``device`` (default: the default
    device); nothing to wait for on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


_UNPORTED = frozenset({"Stream", "Event", "memory_stats", "memory_allocated",
                       "max_memory_allocated", "memory_reserved", "max_memory_reserved",
                       "empty_cache", "cuda"})


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"device.{name} is not ported yet (ROADMAP A10: streams, events and "
            "memory statistics)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class HostArena:
    """One block of host memory, page-locked when ``pin`` is true, carved
    into tensors by :meth:`take` (each at a 256-byte boundary).

    Pinning registers the block with the CUDA driver (``cudaHostRegister``):
    a card then reaches it directly under unified addressing, which is how
    B5 updates ZeRO-offloaded optimizer states.  One registration of the
    exact size, because torch's pinned allocator rounds every block up to
    a power of two (nearly twice the bytes for a 75 GiB state).  ``pin_s``
    is the seconds the pinning took (the pages zeroed, then registered).
    :meth:`release` (run too when the arena is collected) unregisters the
    block; tensors taken from it then lie in pageable memory, where B5
    refuses them."""

    ALIGN = 256

    def __init__(self, nbytes: int, pin: bool):
        self.nbytes = int(nbytes)
        self._buf = torch.empty(max(self.nbytes, 1), dtype=torch.uint8)
        self._at = 0
        self._pinned = False
        self.pin_s = 0.0
        if pin:
            t = time.perf_counter()
            # fault the pages in first, on torch's CPU threads: the driver's
            # registration of resident pages is several times faster than
            # its own faulting in one thread
            self._buf.zero_()
            rc = torch.cuda.cudart().cudaHostRegister(self._buf.data_ptr(), self._buf.numel(), 0)
            if int(rc) != 0:
                raise RuntimeError(f"cudaHostRegister of {self.nbytes} bytes failed: CUDA "
                                   f"error {int(rc)}")
            self._pinned = True
            self.pin_s = time.perf_counter() - t

    @classmethod
    def span(cls, shapes: Sequence, dtype: torch.dtype) -> int:
        """The bytes :meth:`take` needs for a tensor of each of ``shapes``."""
        size = torch.empty((), dtype=dtype).element_size()
        return sum(-(-math.prod(s) * size // cls.ALIGN) * cls.ALIGN for s in shapes)

    @property
    def pinned(self) -> bool:
        return self._pinned

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """An uninitialised tensor of ``shape`` and ``dtype`` in the arena."""
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        at = self._at
        if at + n > self.nbytes:
            raise RuntimeError(f"HostArena: {n} bytes at {at} overrun {self.nbytes}")
        self._at = at + -(-n // self.ALIGN) * self.ALIGN
        return self._buf[at:at + n].view(dtype).view(tuple(shape))

    def release(self) -> None:
        """Unregister the block (after the card's pending work)."""
        if self._pinned:
            torch.cuda.synchronize()
            torch.cuda.cudart().cudaHostUnregister(self._buf.data_ptr())
            self._pinned = False

    def __del__(self):
        self.release()
