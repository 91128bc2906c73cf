"""Common layers (port of the reference's ``nn/layer/common.py``:
``Linear``, ``Embedding``, ``Dropout``, ``Flatten``, ``Identity``,
``Unflatten``, ``CosineSimilarity``, ``PairwiseDistance``).

Each is a :class:`~.layers.Layer`.  The constructors take the reference's
arguments in its order; ``weight_attr``/``bias_attr`` are a ``ParamAttr``,
an initializer, a name, ``None`` (the default parameter) or ``False`` (no
parameter, where the layer can drop it; a weight cannot, as in the
reference).  The port's own arguments (``std``, ``generator``, ``device``,
``dtype``) are keyword-only after them: ``std`` replaces the default
initializer by N(0, ``std``) (the initializer every Llama and GPT layer of
the reference passes as ``weight_attr``); without it the defaults are the
reference's (``Linear`` XavierNormal, ``Embedding`` N(0, 1), biases zero).

``Linear.weight`` keeps paddle's ``[in, out]`` layout and computes
``x @ W + b``, so weights cross between the two packages without
transposes.  The image layers (``Dropout2D``, ``Dropout3D``,
``AlphaDropout``, ``Upsample`` and its two fixed-mode forms, ``Pad1D``/
``2D``/``3D``, ``Bilinear``, ``PixelShuffle``, ``PixelUnshuffle``,
``Unfold``, ``ZeroPad2D``, ``ChannelShuffle``) wrap their functionals
with the reference's arguments; the dropouts draw their masks through
the port's one seam (``framework.random._keep_mask``), as ``Dropout``
does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Flatten", "Identity", "Unflatten",
           "CosineSimilarity", "PairwiseDistance", "Dropout2D", "Dropout3D", "AlphaDropout",
           "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D", "Pad1D", "Pad2D",
           "Pad3D", "Bilinear", "PixelShuffle", "Unfold", "ZeroPad2D", "PixelUnshuffle",
           "ChannelShuffle"]


def check_attr(attr, what: str, droppable: bool) -> bool:
    """Whether the parameter ``what`` exists under ``attr`` (False: no,
    where the layer can drop it; anything else: yes).  The reference's
    ``create_parameter`` refuses ``False`` for a parameter its layer always
    has."""
    if attr is not False:
        return True
    if droppable:
        return False
    raise ValueError("attr=False is handled by the calling layer (means: no "
                     f"parameter), and {what} cannot be left out")


def _std_or(std: Optional[float], default):
    return default if std is None else I.Normal(0.0, std)


class Linear(Layer):
    """y = x @ W + b, W of shape [in_features, out_features] and b [out].
    ``bias_attr=False`` leaves the bias out (the Llama projections have
    none)."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None, *, std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device, generator)
        check_attr(weight_attr, "Linear weight", droppable=False)
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=_std_or(std, I.XavierNormal()))
        self.bias = self.create_parameter([out_features], attr=bias_attr, is_bias=True) \
            if check_attr(bias_attr, "Linear bias", droppable=True) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    """Rows of a [num_embeddings, embedding_dim] table.  With
    ``padding_idx`` (negative counts from the end), that row of the weight
    starts at zero and the output rows at that id are zero, as in the
    reference.  ``sparse`` is accepted and has no effect: the gradient is
    dense, as the reference's is."""

    def __init__(self, num_embeddings: int, embedding_dim: int, padding_idx=None,
                 sparse: bool = False, weight_attr=None, name=None, *,
                 std: Optional[float] = None, generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device, generator)
        check_attr(weight_attr, "Embedding weight", droppable=False)
        self._num_embeddings, self._embedding_dim = num_embeddings, embedding_dim
        self._padding_idx = (padding_idx if padding_idx is None or padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=_std_or(std, I.Normal(0.0, 1.0)))
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self) -> str:
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """``F.dropout`` in the layer's training mode: identity at p = 0 or in
    eval mode (times 1 − p for ``downscale_in_infer``)."""

    def __init__(self, p: float = 0.5, axis=None, mode: str = "upscale_in_train",
                 name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, self.axis, training=self.training, mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class Flatten(Layer):
    """Axes ``start_axis`` to ``stop_axis`` merged into one."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Unflatten(Layer):
    """Axis ``axis`` split into ``shape`` (the inverse of Flatten)."""

    def __init__(self, axis: int, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, list(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        full = list(x.shape)
        ax = self.axis if self.axis >= 0 else len(full) + self.axis
        return x.reshape(full[:ax] + self.shape + full[ax + 1:])


class CosineSimilarity(Layer):
    def __init__(self, axis: int = 1, eps: float = 1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    """The p-norm distance between row pairs."""

    def __init__(self, p: float = 2.0, epsilon: float = 1e-6, keepdim: bool = False,
                 name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Dropout2D(Layer):
    """``F.dropout2d``: whole channels dropped in training."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training, data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training, data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Upsample(Layer):
    """``F.interpolate`` with the layer's size or scale and mode; as in the
    reference, ``align_mode`` is kept and not passed on (the functional's
    default, 0, applies)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest", align_corners=False,
                 align_mode=0, data_format="NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale_factor,
                             mode=self.mode, align_corners=self.align_corners,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear, corners aligned."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "bilinear", True, data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "nearest", False, data_format=data_format)


class _PadND(Layer):
    """``F.pad`` by the layer's ``padding`` (an int pads the last axis on
    both sides, as in the reference)."""

    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW", name=None):
        super().__init__()
        self.padding = list(padding) if isinstance(padding, (list, tuple)) else [padding] * 2
        self.mode, self.value, self.data_format = mode, value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadND):
    pass


class Pad3D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Bilinear(Layer):
    """out = x1 @ W[o] @ x2 + b, W [out, in1, in2] (XavierNormal) and b
    [1, out] (zeros, ``bias_attr=False`` leaves it out)."""

    def __init__(self, in1_features, in2_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device, generator)
        check_attr(weight_attr, "Bilinear weight", droppable=False)
        self.weight = self.create_parameter([out_features, in1_features, in2_features],
                                            attr=weight_attr)
        self.bias = self.create_parameter([1, out_features], attr=bias_attr, is_bias=True) \
            if check_attr(bias_attr, "Bilinear bias", droppable=True) else None

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class ZeroPad2D(Layer):
    """Zeros around H and W; ``padding`` an int or [left, right, top,
    bottom]."""

    def __init__(self, padding, data_format: str = "NCHW", name=None):
        super().__init__()
        self.padding = [padding] * 4 if isinstance(padding, int) else list(padding)
        self.data_format = data_format

    def forward(self, x):
        return F.zeropad2d(x, self.padding, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor: int, data_format: str = "NCHW", name=None):
        super().__init__()
        self.downscale_factor, self.data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups: int, data_format: str = "NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
