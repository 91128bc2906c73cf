"""The port's ``nn``: the ``Layer`` tree (containers, activations, losses,
transformer layers, recurrent cells), ``ParamAttr`` and the initializers,
the decoding API, the functional operators and gradient clipping."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from ..framework.param_attr import ParamAttr  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .layer import (CELU, ELU, GELU, GLU, BCELoss, BCEWithLogitsLoss,  # noqa: F401
                    CosineEmbeddingLoss, CosineSimilarity, CrossEntropyLoss, CTCLoss,
                    Dropout, Embedding, Flatten, GaussianNLLLoss, GRUCell, Hardshrink,
                    Hardsigmoid, Hardswish, Hardtanh, HingeEmbeddingLoss, Identity,
                    KLDivLoss, L1Loss, Layer, LayerDict, LayerList, LayerNorm, LeakyReLU,
                    Linear, LogSigmoid, LogSoftmax, LSTMCell, MarginRankingLoss, Maxout,
                    Mish, MSELoss, MultiHeadAttention, MultiLabelSoftMarginLoss,
                    MultiMarginLoss, NLLLoss, PairwiseDistance, ParameterList,
                    PoissonNLLLoss, PReLU, ReLU, ReLU6, RMSNorm, RNNCellBase, RReLU, SELU,
                    Sequential, Sigmoid, SiLU, Silu, SimpleRNNCell, SmoothL1Loss, Softmax,
                    Softmax2D, SoftMarginLoss, Softplus, Softshrink, Softsign, Swish, Tanh,
                    Tanhshrink, ThresholdedReLU, Transformer, TransformerDecoder,
                    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
                    TripletMarginLoss, TripletMarginWithDistanceLoss, Unflatten)
