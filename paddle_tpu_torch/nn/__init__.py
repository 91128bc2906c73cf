"""Layers and functional operators of the port."""

from . import functional  # noqa: F401
from .layers import Embedding, Linear, RMSNorm  # noqa: F401
