"""Fused operators outside the core API (port of the reference's
``incubate/``)."""

from . import nn  # noqa: F401
