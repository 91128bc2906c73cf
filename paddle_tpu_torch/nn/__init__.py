"""Layers, functional operators and gradient clipping of the port."""

from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm  # noqa: F401
