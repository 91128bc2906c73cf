"""The fused layers (port of the reference's ``incubate/nn/__init__.py``,
after paddle's ``fused_transformer.py``): ``FusedLinear``,
``FusedMultiHeadAttention`` and ``FusedFeedForward`` over the fused
functionals, with the reference's parameter names and layouts
(``qkv_weight`` [3, heads, head_dim, embed], Linear weights [in, out]), so
a JAX layer's ``state_dict`` loads through
:func:`paddle_tpu_torch.convert.load_numpy_state_dict`.  They are built
on the enclosing placement's device, else the default device."""

from typing import Optional

from ...nn import initializer as I
from ...nn.layer.layers import Layer
from . import functional  # noqa: F401
from . import functional as F_inc

__all__ = ["FusedLinear", "FusedFeedForward", "FusedMultiHeadAttention", "functional"]


class FusedLinear(Layer):
    """``fused_linear``: weight [in, out] (``transpose_weight``: [out, in])."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, transpose_weight: bool = False, name=None):
        super().__init__()
        self.transpose_weight = transpose_weight
        shape = [out_features, in_features] if transpose_weight else [in_features, out_features]
        self.weight = self.create_parameter(shape, attr=weight_attr,
                                            default_initializer=I.XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F_inc.fused_linear(x, self.weight, self.bias,
                                  transpose_weight=self.transpose_weight)


class FusedMultiHeadAttention(Layer):
    """``fused_multi_head_attention`` with its own weights: [pre-]LN, qkv,
    attention, projection, dropout, residual, [post-]LN.  ``need_weights``
    raises, as in the reference; ``key``, ``value`` and ``cache`` are taken
    and not read, as there."""

    def __init__(self, embed_dim: int, num_heads: int, dropout_rate: float = 0.5,
                 attn_dropout_rate: float = 0.5, kdim=None, vdim=None,
                 normalize_before: bool = False, need_weights: bool = False,
                 qkv_weight_attr=None, qkv_bias_attr=None, linear_weight_attr=None,
                 linear_bias_attr=None, pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon: float = 1e-5,
                 nranks: int = 1, ring_id: int = -1, name=None):
        super().__init__()
        if need_weights:
            raise NotImplementedError("need_weights is unsupported (as in the reference)")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate, self.attn_dropout_rate = dropout_rate, attn_dropout_rate
        self.epsilon = epsilon
        mk = self.create_parameter
        self.qkv_weight = mk([3, num_heads, self.head_dim, embed_dim], attr=qkv_weight_attr,
                             default_initializer=I.XavierNormal())
        self.qkv_bias = mk([3, num_heads, self.head_dim], attr=qkv_bias_attr, is_bias=True)
        self.linear_weight = mk([embed_dim, embed_dim], attr=linear_weight_attr,
                                default_initializer=I.XavierNormal())
        self.linear_bias = mk([embed_dim], attr=linear_bias_attr, is_bias=True)
        self.pre_ln_scale = mk([embed_dim], attr=pre_ln_scale_attr,
                               default_initializer=I.Constant(1.0))
        self.pre_ln_bias = mk([embed_dim], attr=pre_ln_bias_attr, is_bias=True)
        self.ln_scale = mk([embed_dim], attr=ln_scale_attr, default_initializer=I.Constant(1.0))
        self.ln_bias = mk([embed_dim], attr=ln_bias_attr, is_bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        return F_inc.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            qkv_bias=self.qkv_bias, linear_bias=self.linear_bias,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate, ln_epsilon=self.epsilon,
            pre_ln_epsilon=self.epsilon, training=self.training)


class FusedFeedForward(Layer):
    """``fused_feedforward`` with its own weights; ``act_dropout_rate``
    defaults to ``dropout_rate``."""

    def __init__(self, d_model: int, dim_feedforward: int, dropout_rate: float = 0.1,
                 epsilon: float = 1e-05, activation: str = "relu",
                 act_dropout_rate: Optional[float] = None, normalize_before: bool = False,
                 linear1_weight_attr=None, linear1_bias_attr=None,
                 linear2_weight_attr=None, linear2_bias_attr=None,
                 ln1_scale_attr=None, ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks: int = 1, ring_id: int = -1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None else act_dropout_rate
        self.epsilon = epsilon
        mk = self.create_parameter
        self.linear1_weight = mk([d_model, dim_feedforward], attr=linear1_weight_attr,
                                 default_initializer=I.XavierNormal())
        self.linear1_bias = mk([dim_feedforward], attr=linear1_bias_attr, is_bias=True)
        self.linear2_weight = mk([dim_feedforward, d_model], attr=linear2_weight_attr,
                                 default_initializer=I.XavierNormal())
        self.linear2_bias = mk([d_model], attr=linear2_bias_attr, is_bias=True)
        self.ln1_scale = mk([d_model], attr=ln1_scale_attr, default_initializer=I.Constant(1.0))
        self.ln1_bias = mk([d_model], attr=ln1_bias_attr, is_bias=True)
        self.ln2_scale = mk([d_model], attr=ln2_scale_attr, default_initializer=I.Constant(1.0))
        self.ln2_bias = mk([d_model], attr=ln2_bias_attr, is_bias=True)

    def forward(self, src, cache=None):
        return F_inc.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self.act_dropout_rate, dropout2_rate=self.dropout_rate,
            activation=self.activation, ln1_epsilon=self.epsilon,
            ln2_epsilon=self.epsilon, pre_layer_norm=self.normalize_before,
            training=self.training)
