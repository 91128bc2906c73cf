"""The port's layers, at the reference's module paths (``nn/layer/common.py``,
``nn/layer/norm.py``, ``nn/layer/rnn.py``)."""

from .common import Dropout, Embedding, Linear  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401
from .rnn import GRUCell, LSTMCell, RNNCellBase, SimpleRNNCell  # noqa: F401
