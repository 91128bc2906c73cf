"""The functional operators of the serving path (port of the reference's
``nn/functional/__init__.py``: ``linear``, ``embedding``, ``rms_norm``,
``swiglu``, ``scaled_dot_product_attention``).

``rms_norm`` and ``scaled_dot_product_attention`` reach the hand kernels
through the dispatch seam (:func:`paddle_tpu_torch.ops.use_kernel`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..framework.flags import get_flags
from ..ops import use_kernel
from ..ops.attention import sdpa_reference
from ..ops.flash_attention import flash_attention_fwd
from ..ops.fused_norm import fused_rms_norm, rms_norm_plain

__all__ = ["linear", "embedding", "rms_norm", "swiglu",
           "scaled_dot_product_attention"]


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ weight [in, out]: paddle's layout."""
    return torch.matmul(x, weight)


def embedding(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows of ``weight`` [vocab, dim] at the ids ``x``."""
    return weight[x.long()]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis in f32, times ``weight``, cast to x's
    dtype."""
    if use_kernel("use_fused_rms_norm", x):
        return fused_rms_norm(x, weight, epsilon)[0]
    return rms_norm_plain(x, weight, epsilon)[0]


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """silu(x) * y."""
    if get_flags("use_fused_swiglu")["use_fused_swiglu"]:
        raise NotImplementedError(
            "use_fused_swiglu: the fused SwiGLU kernel (ROADMAP B4) is not "
            "ported yet; leave the flag off to run silu(x) * y")
    return torch.nn.functional.silu(x) * y


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 is_causal: bool = False) -> torch.Tensor:
    """Attention in the [batch, seq, heads, head_dim] layout.  Without an
    additive mask this is the flash function (hand kernel on the card);
    with one it is the composite ``sdpa_reference``, whose masked form has
    no kernel yet."""
    if attn_mask is None and use_kernel("use_flash_attention", query):
        return flash_attention_fwd(query, key, value, causal=is_causal)[0]
    return sdpa_reference(query, key, value, mask=attn_mask, is_causal=is_causal)
