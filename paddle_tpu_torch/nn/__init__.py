"""The port's ``nn``: the ``Layer`` tree (containers, activations, losses,
transformer layers, convolutions, pools, norms, the image layers,
recurrent cells and layers), ``ParamAttr`` and the initializers,
the decoding API, the functional operators and gradient clipping."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from ..framework.param_attr import ParamAttr  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .layer import (CELU, ELU, GELU, GLU, GRU, LSTM, RNN,  # noqa: F401
                    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AlphaDropout,
                    AvgPool1D, AvgPool2D, AvgPool3D, BatchNorm, BatchNorm1D, BatchNorm2D,
                    BatchNorm3D, BCELoss, BCEWithLogitsLoss, Bilinear, BiRNN, ChannelShuffle,
                    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose,
                    CosineEmbeddingLoss, CosineSimilarity, CrossEntropyLoss, CTCLoss, Dropout,
                    Dropout2D, Dropout3D, Embedding, Flatten, GaussianNLLLoss, GroupNorm,
                    GRUCell, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
                    HingeEmbeddingLoss, Identity, InstanceNorm1D, InstanceNorm2D,
                    InstanceNorm3D, KLDivLoss, L1Loss, Layer, LayerDict, LayerList, LayerNorm,
                    LeakyReLU, Linear, LocalResponseNorm, LogSigmoid, LogSoftmax, LSTMCell,
                    MarginRankingLoss, Maxout, MaxPool1D, MaxPool2D, MaxPool3D, Mish, MSELoss,
                    MultiHeadAttention, MultiLabelSoftMarginLoss, MultiMarginLoss, NLLLoss,
                    Pad1D, Pad2D, Pad3D, PairwiseDistance, ParameterList, PixelShuffle,
                    PixelUnshuffle, PoissonNLLLoss, PReLU, ReLU, ReLU6, RMSNorm, RNNCellBase,
                    RReLU, SELU, Sequential, Sigmoid, SiLU, Silu, SimpleRNN, SimpleRNNCell,
                    SmoothL1Loss, Softmax, Softmax2D, SoftMarginLoss, Softplus, Softshrink,
                    Softsign, SpectralNorm, Swish, SyncBatchNorm, Tanh, Tanhshrink,
                    ThresholdedReLU, Transformer, TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer, TripletMarginLoss,
                    TripletMarginWithDistanceLoss, Unflatten, Unfold, Upsample,
                    UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D)
