"""The port's layers, at the reference's module paths (``nn/layer/layers.py``,
``common.py``, ``conv.py``, ``pooling.py``, ``norm.py``, ``container.py``,
``activation.py``, ``loss.py``, ``transformer.py``, ``rnn.py``)."""

from .layers import Layer  # noqa: F401
from .common import (AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity,  # noqa: F401
                     Dropout, Dropout2D, Dropout3D, Embedding, Flatten, Identity, Linear,
                     Pad1D, Pad2D, Pad3D, PairwiseDistance, PixelShuffle, PixelUnshuffle,
                     Unflatten, Unfold, Upsample, UpsamplingBilinear2D, UpsamplingNearest2D,
                     ZeroPad2D)
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,  # noqa: F401
                   Conv3DTranspose)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,  # noqa: F401
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,  # noqa: F401
                   InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
                   LocalResponseNorm, RMSNorm, SpectralNorm, SyncBatchNorm)
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
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase,  # noqa: F401
                  SimpleRNN, SimpleRNNCell)
