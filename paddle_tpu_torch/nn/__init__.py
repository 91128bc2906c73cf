"""Layers, recurrent cells, the decoding API, functional operators and
gradient clipping of the port."""

from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm  # noqa: F401
from .rnn import GRUCell, LSTMCell, RNNCellBase, SimpleRNNCell  # noqa: F401
