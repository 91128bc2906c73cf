"""The functional operators of the serving and training paths (port of the
reference's ``nn/functional/__init__.py``: ``linear``, ``embedding``,
``rms_norm``, ``swiglu``, ``scaled_dot_product_attention``,
``cross_entropy``).

``rms_norm`` and ``scaled_dot_product_attention`` reach the hand kernels
through the dispatch seam: without grad, :func:`~paddle_tpu_torch.ops.use_kernel`
picks the forward kernel; with grad, :func:`~paddle_tpu_torch.ops.use_function`
picks the op's autograd Function (forward and backward kernels on the
card, the plain pair on the CPU).  A flag turned off gives the plain
PyTorch ops, differentiated by autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..framework.flags import get_flags
from ..ops import use_function, use_kernel
from ..ops.attention import sdpa_reference
from ..ops.flash_attention import FlashAttentionFunction, flash_attention_fwd
from ..ops.fused_norm import RMSNormFunction, fused_rms_norm, rms_norm_plain

__all__ = ["linear", "embedding", "rms_norm", "swiglu",
           "scaled_dot_product_attention", "cross_entropy"]


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
    if use_function("use_fused_rms_norm", x, weight):
        return RMSNormFunction.apply(x, weight, epsilon)
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
    additive mask this is the flash function (hand kernels on the card);
    with one it is the composite ``sdpa_reference``, whose masked form has
    no kernel yet."""
    if attn_mask is None:
        if use_function("use_flash_attention", query, key, value):
            return FlashAttentionFunction.apply(query, key, value, is_causal)
        if use_kernel("use_flash_attention", query):
            return flash_attention_fwd(query, key, value, causal=is_causal)[0]
    return sdpa_reference(query, key, value, mask=attn_mask, is_causal=is_causal)


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, label_smoothing: float = 0.0
                  ) -> torch.Tensor:
    """Softmax cross entropy over the last axis against hard labels
    (``label`` of ``input``'s shape without its last axis, or with it of
    size 1), log-softmax in f32.
    Labels equal to ``ignore_index`` add nothing; ``"mean"`` divides by
    the number of the others (at least 1).  ``label_smoothing`` mixes the
    one-hot target with the uniform one."""
    if soft_label or weight is not None:
        raise NotImplementedError(
            "cross_entropy: soft labels and class weights are not ported "
            "yet (ROADMAP queue A)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got {reduction!r}")
    logp = torch.log_softmax(input.float(), dim=-1)
    hard = label.squeeze(-1) if label.dim() == input.dim() else label
    valid = hard != ignore_index
    picked = logp.gather(-1, torch.where(valid, hard, 0).long()[..., None])[..., 0]
    loss = -picked
    if label_smoothing > 0.0:
        n_class = logp.shape[-1]
        loss = (1 - label_smoothing) * loss - label_smoothing / n_class * logp.sum(-1)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1)
    return loss.sum() if reduction == "sum" else loss
