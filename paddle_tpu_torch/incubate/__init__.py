"""Fused operators outside the core API (port of the reference's
``incubate/``)."""

from . import autotune, nn  # noqa: F401
