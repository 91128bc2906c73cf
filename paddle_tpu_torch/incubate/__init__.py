"""Fused operators outside the core API (port of the reference's
``incubate/``)."""

from . import autotune, nn  # noqa: F401

_UNPORTED = frozenset({"distributed", "asp"})


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"incubate.{name} is not ported yet (ROADMAP A9: MoE and the rest of incubate)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
