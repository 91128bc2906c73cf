"""Fused functional operators (port of the reference's ``incubate/nn``)."""

from . import functional  # noqa: F401
