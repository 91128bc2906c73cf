"""Former home of the port's layers, kept importable: they live at the
reference's paths, :mod:`.layer.common` and :mod:`.layer.norm`."""

from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.norm import LayerNorm, RMSNorm  # noqa: F401

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm", "Dropout"]
