"""``fused_layer_norm`` (port of the reference's
``incubate/nn/functional/__init__.py:56-92``), and ``swiglu``, which is
``nn.functional.swiglu`` (reference ``:29``, ``:33``).

``fused_layer_norm`` with a residual, a bias and ``use_fused_layernorm`` on
is the fused residual-add + LayerNorm (B11 forward, B11b backward: the hand
kernels on CUDA tensors, their plain twins on CPU ones, through
:class:`~paddle_tpu_torch.ops.fused_ln_swiglu.AddLayerNormFunction` when a
gradient is wanted).  The reference's ``rows % 8`` / ``h % 128`` gate is a
Mosaic tiling limit, not semantics, so the port has none.  Otherwise it is
the plain add followed by ``layer_norm`` in the working dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...framework.flags import get_flags
from ...nn import functional as F
from ...ops import use_function
from ...ops.fused_ln_swiglu import AddLayerNormFunction, fused_add_layer_norm

__all__ = ["fused_layer_norm", "swiglu"]

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
        if use_function("use_fused_layernorm", pre, residual, norm_weight, norm_bias):
            return AddLayerNormFunction.apply(pre, residual, norm_weight, norm_bias,
                                              epsilon)
        out, pre, _, _ = fused_add_layer_norm(pre, residual, norm_weight, norm_bias,
                                              epsilon)
        return out, pre
    pre = pre + residual
    return F.layer_norm(pre, pre.shape[-1], norm_weight, norm_bias, epsilon), pre


# the reference's fused functionals that wait for ROADMAP A9
_UNPORTED = frozenset({
    "fused_rms_norm", "fused_rotary_position_embedding", "fused_matmul_bias", "fused_linear",
    "fused_linear_activation", "fused_bias_act", "fused_dropout_add",
    "fused_dot_product_attention", "fused_multi_head_attention", "fused_feedforward"})


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"incubate.nn.functional.{name} is not ported yet (ROADMAP A9: the rest of "
            "incubate)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
