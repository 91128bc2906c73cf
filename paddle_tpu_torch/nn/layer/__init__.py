"""The port's layers, at the reference's module paths (``nn/layer/layers.py``,
``common.py``, ``norm.py``, ``container.py``, ``activation.py``,
``loss.py``, ``transformer.py``, ``rnn.py``)."""

from .layers import Layer  # noqa: F401
from .common import (CosineSimilarity, Dropout, Embedding, Flatten,  # noqa: F401
                     Identity, Linear, PairwiseDistance, Unflatten)
from .norm import LayerNorm, RMSNorm  # noqa: F401
from .container import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from .activation import (CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid,  # noqa: F401
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid, LogSoftmax, Maxout,
                         Mish, PReLU, ReLU, ReLU6, RReLU, SELU, Sigmoid, SiLU, Silu,
                         Softmax, Softmax2D, Softplus, Softshrink, Softsign, Swish,
                         Tanh, Tanhshrink, ThresholdedReLU)
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,  # noqa: F401
                   CrossEntropyLoss, CTCLoss, GaussianNLLLoss, HingeEmbeddingLoss,
                   KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, MultiLabelSoftMarginLoss,
                   MultiMarginLoss, NLLLoss, PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss,
                   TripletMarginLoss, TripletMarginWithDistanceLoss)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from .rnn import GRUCell, LSTMCell, RNNCellBase, SimpleRNNCell  # noqa: F401
