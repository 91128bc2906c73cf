"""Layers, recurrent cells, the decoding API, functional operators and
gradient clipping of the port."""

from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .layer import (Dropout, Embedding, GRUCell, LayerNorm, Linear,  # noqa: F401
                    LSTMCell, RMSNorm, RNNCellBase, SimpleRNNCell)
