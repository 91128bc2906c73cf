"""The fused functionals (port of the reference's
``incubate/nn/functional/__init__.py``).

- ``fused_layer_norm`` with a residual, a bias and ``use_fused_layernorm``
  on is the fused residual-add + LayerNorm (B11 forward, B11b backward:
  the hand kernels on CUDA tensors, their plain twins on CPU ones, through
  :class:`~paddle_tpu_torch.ops.fused_ln_swiglu.AddLayerNormFunction` when
  a gradient is wanted).  The reference's ``rows % 8`` / ``h % 128`` gate
  is a Mosaic tiling limit, not semantics, so the port has none.
  Otherwise it is the plain add followed by ``layer_norm``.
- ``fused_rms_norm`` adds the bias and residual in the working dtype and
  normalises through ``nn.functional.rms_norm`` (B1, B1b on the card).
- ``fused_dot_product_attention`` and the attention of
  ``fused_multi_head_attention`` are ``scaled_dot_product_attention``: the
  flash kernels (B3, B3b/B3c) without a mask or dropout, the composite
  otherwise, as the reference's Pallas gate decides.
- ``fused_rotary_position_embedding``, ``fused_matmul_bias``,
  ``fused_linear``, ``fused_linear_activation``, ``fused_bias_act``,
  ``fused_dropout_add`` and ``fused_feedforward`` are plain PyTorch in the
  reference's formulas (the reference leaves them to XLA, and its rotation
  does not call the RoPE kernel); their dropouts draw through the port's
  seam.  The reference's ``"gelu"`` activation here is ``jax.nn.gelu``,
  the tanh form.
- ``swiglu`` is ``nn.functional.swiglu`` (B4 for two inputs of one shape).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...framework.flags import get_flags
from ...nn import functional as F
from ...ops import export_route, exported_op, use_function
from ...ops.fused_ln_swiglu import AddLayerNormFunction, fused_add_layer_norm

__all__ = [
    "fused_rms_norm", "fused_layer_norm", "fused_rotary_position_embedding",
    "fused_matmul_bias", "fused_linear", "fused_linear_activation",
    "fused_bias_act", "fused_dropout_add", "fused_dot_product_attention",
    "swiglu", "fused_multi_head_attention", "fused_feedforward",
]

# re-export: the core functional dispatches swiglu to B4
swiglu = F.swiglu


def fused_layer_norm(x: torch.Tensor, norm_weight: torch.Tensor,
                     norm_bias: Optional[torch.Tensor], epsilon: float = 1e-5,
                     begin_norm_axis: int = -1, bias: Optional[torch.Tensor] = None,
                     residual: Optional[torch.Tensor] = None, quant_scale: float = -1,
                     quant_round_type: int = 0, quant_max_bound: float = 0,
                     quant_min_bound: float = 0):
    """LayerNorm(x [+ bias] [+ residual]) over the last axis.  With
    ``residual``, returns ``(out, pre)``, ``pre`` being the sum that went
    in; without it, ``out``.  A quantized output (``quant_scale > 0``)
    raises, as in the reference."""
    if quant_scale > 0:
        raise NotImplementedError("fused_layer_norm: a quantized output is not "
                                  "supported, as in the reference")
    if begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            f"fused_layer_norm normalizes the last axis only, got "
            f"begin_norm_axis={begin_norm_axis} for a {x.dim()}-d input")
    pre = x if bias is None else x + bias
    if residual is None:
        return F.layer_norm(pre, pre.shape[-1], norm_weight, norm_bias, epsilon)
    if norm_bias is not None and residual.shape == pre.shape and \
            get_flags("use_fused_layernorm")["use_fused_layernorm"]:
        if export_route("use_fused_layernorm"):
            out, pre, _, _ = exported_op("add_layer_norm")(pre, residual, norm_weight,
                                                           norm_bias, epsilon)
            return out, pre
        if use_function("use_fused_layernorm", pre, residual, norm_weight, norm_bias):
            return AddLayerNormFunction.apply(pre, residual, norm_weight, norm_bias,
                                              epsilon)
        out, pre, _, _ = fused_add_layer_norm(pre, residual, norm_weight, norm_bias,
                                              epsilon)
        return out, pre
    pre = pre + residual
    return F.layer_norm(pre, pre.shape[-1], norm_weight, norm_bias, epsilon), pre


def fused_rms_norm(x: torch.Tensor, norm_weight: torch.Tensor,
                   norm_bias: Optional[torch.Tensor] = None, epsilon: float = 1e-6,
                   begin_norm_axis: int = -1, bias: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None, quant_scale: float = -1,
                   quant_round_type: int = 0, quant_max_bound: float = 0,
                   quant_min_bound: float = 0):
    """RMSNorm(x [+ bias] [+ residual]) [+ norm_bias] over the last axis
    (``F.rms_norm``: B1, B1b on the card).  With ``residual``, returns
    ``(out, pre)``, ``pre`` being the sum that went in; without it, ``out``.
    A quantized output raises, as in the reference."""
    if quant_scale > 0:
        raise NotImplementedError("fused_rms_norm: a quantized output is not "
                                  "supported, as in the reference")
    pre = x if bias is None else x + bias
    if residual is not None:
        pre = pre + residual
    out = F.rms_norm(pre, norm_weight, epsilon)
    if norm_bias is not None:
        out = out + norm_bias
    return (out, pre) if residual is not None else out


def _rope_tables(seq_len: int, head_dim: int, position_ids, device):
    inv = 1.0 / (10000.0 ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) if position_ids is None \
        else torch.as_tensor(position_ids, device=device).float().reshape(-1)
    freqs = torch.outer(pos, inv)                      # [s, d/2]
    emb = torch.cat([freqs, freqs], dim=-1)            # [s, d]
    return emb.cos(), emb.sin()


def fused_rotary_position_embedding(q: torch.Tensor, k: Optional[torch.Tensor] = None,
                                    v: Optional[torch.Tensor] = None, sin=None, cos=None,
                                    position_ids=None, use_neox_rotary_style: bool = True,
                                    time_major: bool = False,
                                    rotary_emb_base: float = 10000.0):
    """RoPE on q (and k, v where given) in the [b, s, h, d] layout, in f32,
    each out in its input's dtype; ``(q, k, v)`` with None where a tensor
    was not given.  ``sin``/``cos`` default to the 10000-base tables (the
    reference ignores ``rotary_emb_base``).  Only the neox (half-rotation)
    style and batch-major layout, as in the reference."""
    if not use_neox_rotary_style:
        raise NotImplementedError("only neox-style (half-rotation) RoPE is supported, "
                                  "as in the reference")
    if time_major:
        raise NotImplementedError("a time-major RoPE layout is not supported, as in "
                                  "the reference")
    s, d = q.shape[1], q.shape[-1]
    if cos is None or sin is None:
        cos_t, sin_t = _rope_tables(s, d, position_ids, q.device)
    else:
        cos_t = torch.as_tensor(cos, device=q.device).reshape(s, d)
        sin_t = torch.as_tensor(sin, device=q.device).reshape(s, d)

    def rot(t):
        tf = t.float()
        half = tf.shape[-1] // 2
        rotated = torch.cat([-tf[..., half:], tf[..., :half]], dim=-1)
        return (tf * cos_t[None, :, None, :] + rotated * sin_t[None, :, None, :]).to(t.dtype)

    return tuple(None if t is None else rot(t) for t in (q, k, v))


def fused_matmul_bias(x: torch.Tensor, y: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      transpose_x: bool = False, transpose_y: bool = False,
                      name=None) -> torch.Tensor:
    """``x @ y`` (each transposed on its last two axes where asked) + bias."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    return out if bias is None else out + bias


def fused_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 transpose_weight: bool = False, name=None) -> torch.Tensor:
    """``x @ weight + bias``, weight [in, out] (``transpose_weight``: [out, in])."""
    return fused_matmul_bias(x, weight, bias, False, transpose_weight)


def _gelu_tanh(v):
    return torch.nn.functional.gelu(v, approximate="tanh")


_ACTS = {"gelu": _gelu_tanh, "relu": torch.relu, "silu": torch.nn.functional.silu,
         "swish": torch.nn.functional.silu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "none": lambda v: v, "identity": lambda v: v}


def fused_linear_activation(x: torch.Tensor, y: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, trans_x: bool = False,
                            trans_y: bool = False, activation: str = "gelu") -> torch.Tensor:
    """``act(x @ y + bias)``; ``activation`` one of ``gelu`` (tanh form),
    ``relu``, ``silu``/``swish``, ``sigmoid``, ``tanh``, ``none``/``identity``."""
    return _ACTS[activation or "none"](fused_matmul_bias(x, y, bias, trans_x, trans_y))


def fused_bias_act(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   dequant_scales=None, shift=None, smooth=None, act_method: str = "gelu",
                   compute_dtype: str = "default", quant_scale: float = -1,
                   quant_round_type: int = 0, quant_max_bound: float = 0,
                   quant_min_bound: float = 0) -> torch.Tensor:
    """``act(x + bias)``; ``swiglu``/``silu_glu`` and ``geglu``/``gelu_glu``
    gate the first half of the last axis by the second.  Quantized forms
    raise, as in the reference."""
    if quant_scale > 0 or dequant_scales is not None:
        raise NotImplementedError("fused_bias_act: quantized forms are not supported, "
                                  "as in the reference")
    v = x if bias is None else x + bias
    if act_method in ("swiglu", "silu_glu", "geglu", "gelu_glu"):
        half = v.shape[-1] // 2
        gate = torch.nn.functional.silu if act_method in ("swiglu", "silu_glu") \
            else _gelu_tanh
        return gate(v[..., :half]) * v[..., half:]
    return _ACTS[act_method](v)


def fused_dropout_add(x: torch.Tensor, y: torch.Tensor, p: float = 0.5,
                      training: bool = True, mode: str = "upscale_in_train",
                      name=None) -> torch.Tensor:
    """``dropout(x) + y``."""
    return F.dropout(x, p=p, training=training, mode=mode) + y


def fused_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                attn_mask: Optional[torch.Tensor] = None,
                                dropout_p: float = 0.0, is_causal: bool = False,
                                training: bool = True,
                                scaling_factor: Optional[float] = None,
                                name=None) -> torch.Tensor:
    """``F.scaled_dot_product_attention`` in [b, s, h, d] (its default
    scale: the reference does not read ``scaling_factor``)."""
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=dropout_p if training else 0.0,
        is_causal=is_causal, training=training)


def fused_multi_head_attention(x, qkv_weight, linear_weight, pre_layer_norm=False,
                               pre_ln_scale=None, pre_ln_bias=None, ln_scale=None,
                               ln_bias=None, pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None, attn_mask=None,
                               dropout_rate=0.0, attn_dropout_rate=0.0,
                               ln_epsilon=1e-5, training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=None,
                               transpose_qkv_wb=False, name=None) -> torch.Tensor:
    """The attention block: [pre-]LayerNorm, the qkv projection, attention
    (``attn_dropout_rate`` on its probabilities), the output projection,
    dropout, the residual and [post-]LayerNorm.  ``qkv_weight`` is
    [3, heads, head_dim, embed] (paddle's layout), or [embed, 3 * embed]
    with ``transpose_qkv_wb`` and ``num_heads``."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, [x.shape[-1]], weight=pre_ln_scale, bias=pre_ln_bias,
                         epsilon=pre_ln_epsilon)
    e = x.shape[-1]
    b, s = x.shape[0], x.shape[1]
    if transpose_qkv_wb:
        if num_heads is None:
            raise ValueError("num_heads required with transpose_qkv_wb")
        h, hd = num_heads, e // num_heads
        qkv = F.linear(x, qkv_weight.reshape(e, 3 * e))
        if qkv_bias is not None:
            qkv = qkv + qkv_bias.reshape(3 * e)
    else:
        _, h, hd, _ = qkv_weight.shape
        qkv = F.linear(x, qkv_weight.permute(3, 0, 1, 2).reshape(e, 3 * h * hd))
        if qkv_bias is not None:
            qkv = qkv + qkv_bias.reshape(3 * h * hd)
    # q, k, v contiguous: the flash kernels take contiguous tensors
    q, k, v = qkv.reshape(b, s, 3, h, hd).permute(2, 0, 1, 3, 4).contiguous().unbind(0)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                         dropout_p=attn_dropout_rate if training else 0.0,
                                         training=training)
    ctx = ctx.reshape(b, s, h * hd)
    lw = linear_weight
    if not transpose_qkv_wb and lw.shape[0] != h * hd:
        lw = lw.reshape(h * hd, e)
    out = F.linear(ctx, lw, linear_bias)
    out = F.dropout(out, p=dropout_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, [out.shape[-1]], weight=ln_scale, bias=ln_bias,
                           epsilon=ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, add_residual=True,
                      name=None) -> torch.Tensor:
    """The feed-forward block: [pre-]LayerNorm, linear + activation,
    dropout, linear, dropout, the residual and [post-]LayerNorm."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, [x.shape[-1]], weight=ln1_scale, bias=ln1_bias,
                         epsilon=ln1_epsilon)
    h = fused_linear_activation(x, linear1_weight, linear1_bias, activation=activation)
    h = F.dropout(h, p=dropout1_rate, training=training, mode=mode)
    out = F.linear(h, linear2_weight, linear2_bias)
    out = F.dropout(out, p=dropout2_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, [out.shape[-1]], weight=ln2_scale, bias=ln2_bias,
                           epsilon=ln2_epsilon)
    return out
