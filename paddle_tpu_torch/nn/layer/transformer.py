"""Transformer layers (port of the reference's ``nn/layer/transformer.py``:
``MultiHeadAttention``, ``TransformerEncoderLayer``,
``TransformerEncoder``, ``TransformerDecoderLayer``,
``TransformerDecoder``, ``Transformer``).

Attention keeps paddle's [batch, seq, heads, head_dim] layout and goes
through ``F.scaled_dot_product_attention``, as the reference's does: with
no mask it is the flash function (B3 forward, B3b/B3c backward on the
card), with an additive mask or attention dropout in training the
composite ``sdpa_reference``, as the reference's flash gate refuses both.
The dropouts come in the reference's order (``dropout1`` after attention,
``act_dropout`` inside the feed-forward block, ``dropout2`` after it) and
draw their masks in that order; in eval they are the identity.  The
layers are built on the enclosing placement's device, else the default
device (:func:`~paddle_tpu_torch.nn.layer.layers.placement`).  The
encoder and decoder stack deep copies of the layer they are given, so
every layer starts from the same weights, as in the reference.
"""

from __future__ import annotations

import collections
import copy

import torch

from ...device import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    """Attention of ``query`` over ``key``/``value`` (self-attention when
    they are not given) with ``num_heads`` heads.  ``need_weights`` is kept
    and, as in the reference, returns no weights.  With a ``Cache`` the new
    keys and values are appended to it and ``(out, cache)`` returned; a
    ``StaticCache`` (``gen_cache(key, value, StaticCache)``) holds the
    projected keys and values of a fixed memory."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        empty = key.new_zeros((key.shape[0], 0, self.num_heads, self.head_dim))
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout, training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1], self.embed_dim))
        if isinstance(cache, self.Cache):
            return out, cache
        return out


def _get_activation(name):
    return {"relu": F.relu, "gelu": F.gelu, "silu": F.silu}[name]


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each with a residual and a
    LayerNorm after it (``normalize_before``: before it)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = _get_activation(activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is not None:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        else:
            src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` in turn, then ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] +
                                [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
            else:
                output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, attention over ``memory`` and a feed-forward block,
    each with a residual and a LayerNorm."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.norm3 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = _get_activation(activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer`` in turn, then ``norm``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] +
                                [copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        output = tgt
        for layer in self.layers:
            output = layer(output, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output


class Transformer(Layer):
    """An encoder over ``src`` and a decoder over ``tgt`` and its output."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, activation="relu", attn_dropout=None,
                 act_dropout=None, normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                                activation, attn_dropout, act_dropout,
                                                normalize_before, weight_attr, bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers, norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout,
                                                activation, attn_dropout, act_dropout,
                                                normalize_before, weight_attr, bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers, norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, *, device=None):
        """The additive causal mask [length, length]: 0 on and below the
        diagonal, the f32 minimum above, on ``device`` (the default
        device if None)."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.zeros(keep.shape, device=keep.device).masked_fill(
            ~keep, torch.finfo(torch.float32).min)
