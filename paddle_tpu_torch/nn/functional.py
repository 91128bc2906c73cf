"""The functional operators of the serving and training paths (port of the
reference's ``nn/functional/__init__.py``: ``linear``, ``embedding``,
``rms_norm``, ``layer_norm``, ``gelu``, ``swiglu``, ``dropout``,
``scaled_dot_product_attention``, ``cross_entropy``, ``gather_tree``).

``rms_norm``, ``swiglu`` and ``scaled_dot_product_attention`` reach the hand kernels
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
from ..ops.fused_ln_swiglu import SwiGLUFunction, fused_swiglu
from ..ops.fused_norm import RMSNormFunction, fused_rms_norm, rms_norm_plain
from ..ops.sharded import (mesh_flash_attention, mesh_flash_supported, mesh_rms_norm,
                           mesh_rms_norm_supported, mesh_route)

__all__ = ["linear", "embedding", "rms_norm", "layer_norm", "gelu", "swiglu",
           "dropout", "scaled_dot_product_attention", "cross_entropy",
           "gather_tree"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, name=None) -> torch.Tensor:
    """x [..., in] @ weight [in, out] (paddle's layout), + bias [out]."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x: torch.Tensor, weight: torch.Tensor, padding_idx=None,
              sparse: bool = False, name=None) -> torch.Tensor:
    """Rows of ``weight`` [vocab, dim] at the ids ``x``; the rows at the id
    ``padding_idx`` are zero.  ``sparse`` has no effect (dense gradient, as
    in the reference)."""
    out = weight[x.long()]
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6, name=None) -> torch.Tensor:
    """RMSNorm over the last axis in f32, times ``weight`` (if given), cast
    to x's dtype.  Without a weight it is the plain normalisation: the
    kernel (B1) always takes one, as the reference's does.  Under a live
    single-controller mesh the rows go through ``mesh_rms_norm`` where its
    gate takes them, as the reference's do."""
    if weight is None:
        xf = x.float()
        return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + epsilon)).to(x.dtype)
    mesh = mesh_route("use_fused_rms_norm")
    if mesh is not None and x.dim() >= 2 and x.shape[-1] == weight.shape[-1] \
            and mesh_rms_norm_supported(mesh, x.shape):
        return mesh_rms_norm(x, weight, mesh, epsilon)
    return _rms_norm(x, weight, epsilon)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    """RMSNorm on one device: the autograd Function (B1 and B1b on the
    card) with grad, B1 without, the plain version on the CPU or with the
    flag off."""
    if use_function("use_fused_rms_norm", x, weight):
        return RMSNormFunction.apply(x, weight, epsilon)
    if use_kernel("use_fused_rms_norm", x):
        return fused_rms_norm(x, weight, epsilon)[0]
    return rms_norm_plain(x, weight, epsilon)[0]


def layer_norm(x: torch.Tensor, normalized_shape, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, epsilon: float = 1e-5,
               name=None) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` axes in f32 (the
    variance as mean((x − mean)²)), times ``weight`` and plus ``bias`` in
    f32, cast to x's dtype; ``weight`` and ``bias`` may be f32 while x is
    bf16 (AMP O2 keeps LayerNorm parameters in f32)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(-len(tuple(normalized_shape)), 0))
    xf = x.float()
    mean = xf.mean(dims, keepdim=True)
    var = (xf - mean).square().mean(dims, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def gelu(x: torch.Tensor, approximate: bool = False, name=None) -> torch.Tensor:
    """GELU: exact (erf) by default, the tanh form with ``approximate``."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None, name=None) -> torch.Tensor:
    """silu(x) * y; with one argument, x's last axis is split in halves
    (gate, up).  With ``use_fused_swiglu`` on and two arguments of one
    shape, the fused SwiGLU (B4: f32 inside, out in x's dtype); otherwise
    silu(x) * y in the working dtype."""
    if y is None:
        half = x.shape[-1] // 2
        return torch.nn.functional.silu(x[..., :half]) * x[..., half:]
    if x.shape == y.shape and get_flags("use_fused_swiglu")["use_fused_swiglu"]:
        if use_function("use_fused_swiglu", x, y):
            return SwiGLUFunction.apply(x, y)
        return fused_swiglu(x, y)
    return torch.nn.functional.silu(x) * y


def _no_dropout(p: float, training: bool, what: str) -> None:
    if training and p > 0.0:
        raise NotImplementedError(
            f"{what} with p = {p} in training: dropout needs a counter-based "
            f"generator (Philox) the port does not have yet (ROADMAP queue "
            f"A); use p = 0 or eval mode")


def dropout(x: torch.Tensor, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None) -> torch.Tensor:
    """Identity at p = 0 or outside training (times 1 − p for
    ``downscale_in_infer`` in eval); p > 0 in training raises.  ``axis``
    (the axes a mask would vary along) matters only where it raises."""
    _no_dropout(p, training, "dropout")
    if not training and mode == "downscale_in_infer":
        return x * (1.0 - p)
    return x


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0, is_causal: bool = False,
                                 training: bool = True, name=None) -> torch.Tensor:
    """Attention in the [batch, seq, heads, head_dim] layout.  Without an
    additive mask this is the flash function (hand kernels on the card),
    through ``mesh_flash_attention`` under a live single-controller mesh
    whose gate takes the shapes, as in the reference; with a mask it is the
    composite ``sdpa_reference``, whose masked form has no kernel yet.  A
    non-zero ``dropout_p`` in training raises."""
    _no_dropout(dropout_p, training, "attention dropout")
    if attn_mask is None:
        mesh = mesh_route("use_flash_attention")
        if mesh is not None and mesh_flash_supported(mesh, query.shape, key.shape,
                                                     has_mask=False, dropout_p=0.0,
                                                     causal=is_causal):
            return mesh_flash_attention(query, key, value, mesh, causal=is_causal)
        return _attention(query, key, value, is_causal)
    return sdpa_reference(query, key, value, mask=attn_mask, is_causal=is_causal)


def _attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
               is_causal: bool) -> torch.Tensor:
    """Unmasked attention on one device: the flash Function (B3, B3b/B3c)
    with grad, B3 without, ``sdpa_reference`` on the CPU or with the flag
    off."""
    if use_function("use_flash_attention", query, key, value):
        return FlashAttentionFunction.apply(query, key, value, is_causal)
    if use_kernel("use_flash_attention", query):
        return flash_attention_fwd(query, key, value, causal=is_causal)[0]
    return sdpa_reference(query, key, value, is_causal=is_causal)


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None) -> torch.Tensor:
    """Softmax cross entropy over the class axis ``axis`` against hard
    labels (``label`` of ``input``'s shape without that axis, or with it of
    size 1), log-softmax in f32; with ``use_softmax=False``, ``input``
    holds probabilities and their log is taken (floored at 1e-30).
    Labels equal to ``ignore_index`` add nothing; ``"mean"`` divides by
    the number of the others (at least 1).  ``label_smoothing`` mixes the
    one-hot target with the uniform one."""
    if soft_label or weight is not None:
        raise NotImplementedError(
            "cross_entropy: soft labels and class weights are not ported "
            "yet (ROADMAP A3)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got {reduction!r}")
    axis = axis % input.dim()
    hard = label.squeeze(axis) if label.dim() == input.dim() else label
    x = input.float().movedim(axis, -1)
    logp = torch.log_softmax(x, dim=-1) if use_softmax else x.clamp(min=1e-30).log()
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


def gather_tree(ids: torch.Tensor, parents: torch.Tensor, name=None) -> torch.Tensor:
    """Back-trace beam-search parent pointers into whole sequences:
    ``ids``/``parents`` [T, batch, beam] (step t's token and the beam it
    continued) to the sequences [T, batch, beam], read root to leaf."""
    T, batch, K = ids.shape
    parents = parents.long()
    out = torch.empty_like(ids)
    ptr = torch.arange(K, device=ids.device).expand(batch, K)
    for t in range(T - 1, -1, -1):
        out[t] = ids[t].gather(1, ptr)
        ptr = parents[t].gather(1, ptr)
    return out


def top_k_stable(x: torch.Tensor, k: int):
    """The ``k`` largest values of ``x`` along its last axis and their
    indices, the lower index first among equal values, as
    ``jax.lax.top_k`` orders them (``torch.topk`` leaves ties unordered on
    the card): a stable descending sort."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]
