"""Normalization layers (port of the reference's ``nn/layer/norm.py``):
``LayerNorm``, ``RMSNorm``, the batch norms (``BatchNorm``,
``BatchNorm1D``/``2D``/``3D``, ``SyncBatchNorm``), ``GroupNorm``,
``InstanceNorm1D``/``2D``/``3D``, ``LocalResponseNorm`` and
``SpectralNorm`` (which raises, as the reference's does).

Each is a :class:`~.layers.Layer`.  Weights start at one and biases at
zero; ``weight_attr``/``bias_attr`` follow :func:`.common.check_attr`:
``False`` drops a parameter, as in the reference; the RMSNorm weight
cannot be dropped.  A batch norm keeps its running statistics in the
persistable f32 buffers ``_mean`` (zeros) and ``_variance`` (ones), the
reference's names, so a state dict crosses with them; ``F.batch_norm``
updates them in training by paddle's momentum rule.  AMP O2 keeps the
batch and group norms' parameters in f32.  The port's ``device`` and
``dtype`` are keyword-only after the reference's arguments.
"""

from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .common import check_attr
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm"]


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes
    (``F.layer_norm``: f32 inside).  AMP O2 keeps its parameters in f32."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = [int(s) for s in normalized_shape]
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr, default_initializer=I.Constant(1.0)) \
            if check_attr(weight_attr, "LayerNorm weight", droppable=True) else None
        self.bias = self.create_parameter(self._normalized_shape, attr=bias_attr,
                                          is_bias=True) \
            if check_attr(bias_attr, "LayerNorm bias", droppable=True) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(Layer):
    """RMSNorm with a weight initialised to ones (B1 and B1b through
    ``F.rms_norm`` on the card)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device)
        check_attr(weight_attr, "RMSNorm weight", droppable=False)
        self._epsilon = epsilon
        self.weight = self.create_parameter([hidden_size], attr=weight_attr,
                                            default_initializer=I.Constant(1.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self._epsilon)


def _scale_shift(layer: Layer, n: int, weight_attr, bias_attr, what: str) -> None:
    """``layer.weight`` (ones) and ``layer.bias`` (zeros) of ``n`` channels,
    each None where its attribute is False."""
    layer.weight = layer.create_parameter([n], attr=weight_attr,
                                          default_initializer=I.Constant(1.0)) \
        if check_attr(weight_attr, f"{what} weight", droppable=True) else None
    layer.bias = layer.create_parameter([n], attr=bias_attr, is_bias=True) \
        if check_attr(bias_attr, f"{what} bias", droppable=True) else None


class _BatchNormBase(Layer):
    """Batch norm over every axis but the channel's (``F.batch_norm``):
    the batch's statistics in training (``use_global_stats`` aside), the
    running ones in eval."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device)
        self._num_features, self._momentum, self._epsilon = num_features, momentum, epsilon
        self._data_format, self._use_global_stats = data_format, use_global_stats
        _scale_shift(self, num_features, weight_attr, bias_attr, "BatchNorm")
        home = self._home()
        self.register_buffer("_mean", torch.zeros(num_features, device=home))
        self.register_buffer("_variance", torch.ones(num_features, device=home))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self._momentum,
                            epsilon=self._epsilon, data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    """Over [N, C] or [N, C, L]; the layout is "NCL" whatever
    ``data_format`` says, as in the reference."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCL", use_global_stats=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr, "NCL",
                         use_global_stats, name, device=device, dtype=dtype)


class BatchNorm2D(_BatchNormBase):
    """Over [N, C, H, W], or [N, H, W, C] with ``data_format="NHWC"``."""


class BatchNorm3D(_BatchNormBase):
    """Over [N, C, D, H, W]; the layout is "NCDHW" whatever ``data_format``
    says, as in the reference."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr, "NCDHW",
                         use_global_stats, name, device=device, dtype=dtype)


def _live_world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics span the whole batch.  In one process
    that is :class:`BatchNorm`: a single-controller mesh holds the whole
    batch, as the reference's GSPMD program does.  Under a live process
    group of more than one rank the statistics would need an all-reduce
    across processes (ROADMAP A6d), and the forward raises."""

    def forward(self, x):
        if _live_world_size() > 1:
            raise NotImplementedError(
                "SyncBatchNorm across processes (an all-reduce of the batch statistics) "
                "is not ported yet (ROADMAP A6d); one process holds the whole batch")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer: Layer) -> Layer:
        """``layer`` with every batch norm in its tree replaced by a
        ``SyncBatchNorm`` carrying the same parameters and statistics."""
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum, layer._epsilon,
                                data_format=layer._data_format, device=layer._home())
            with torch.no_grad():
                for name in ("weight", "bias", "_mean", "_variance"):
                    if getattr(layer, name) is not None:
                        getattr(new, name).copy_(getattr(layer, name))
            return new
        return layer


class GroupNorm(Layer):
    """Norm over channel groups (``F.group_norm``; "NHWC" raises, as in the
    reference)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device)
        self._num_groups, self._epsilon, self._data_format = num_groups, epsilon, data_format
        _scale_shift(self, num_channels, weight_attr, bias_attr, "GroupNorm")

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight, self.bias,
                            self._data_format)


class _InstanceNormBase(Layer):
    """Norm over each sample's channel (``F.instance_norm``); ``momentum``
    and ``data_format`` are taken and not read, as in the reference."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype)
        self._place(device)
        self._epsilon = epsilon
        _scale_shift(self, num_features, weight_attr, bias_attr, "InstanceNorm")

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """Not implemented in the reference either: building one raises."""

    def __init__(self, layer=None, weight_shape=None, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        raise NotImplementedError("SpectralNorm: planned; not required by baseline configs "
                                  "(as in the reference)")
