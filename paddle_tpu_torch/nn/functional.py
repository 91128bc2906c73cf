"""The functional operators (port of the reference's
``nn/functional/__init__.py``): ``linear``, ``embedding``, ``rms_norm``,
``layer_norm``, ``dropout``, ``scaled_dot_product_attention``,
``gather_tree``, the activations, the losses with
``fused_linear_cross_entropy``, the distances, and the image
functionals: convolutions and their transposes, pools, the batch, group,
instance and local-response norms, ``normalize``, ``interpolate``,
``pad``, the pixel and channel shuffles, ``unfold``, ``bilinear`` and the
image dropouts.

``rms_norm``, ``swiglu`` and ``scaled_dot_product_attention`` reach the hand kernels
through the dispatch seam: without grad, :func:`~paddle_tpu_torch.ops.use_kernel`
picks the forward kernel; with grad, :func:`~paddle_tpu_torch.ops.use_function`
picks the op's autograd Function (forward and backward kernels on the
card, the plain pair on the CPU).  A flag turned off gives the plain
PyTorch ops, differentiated by autograd.  The activations and losses are
plain PyTorch in the reference's formulas, as the reference leaves them
to XLA; each computes in its input's dtype where the reference does, and
in f32 where the reference casts.  The image functionals have no
kernel (the reference leaves them to XLA): they are torch's convolutions,
pools and batch norm (cuDNN on the card) under the reference's rules for
padding, windows, layouts, resampling weights and running statistics,
which differ from torch's where each function says.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..amp import maybe_autocast_tensors
from ..framework.dtype import convert_dtype
from ..framework.flags import get_flags
from ..framework import random as _random
from ..framework.random import bulk_key, next_key  # noqa: F401 (the reference's names here)
from ..ops import export_route, exported_op, use_function, use_kernel
from ..ops.attention import sdpa_reference
from ..ops.flash_attention import FlashAttentionFunction, flash_attention_fwd
from ..ops.fused_ln_swiglu import SwiGLUFunction, fused_swiglu
from ..ops.fused_norm import RMSNormFunction, fused_rms_norm, rms_norm_plain
from ..tensor import Parameter, apply_op, ensure_tensor  # noqa: F401 (the reference's names here)
from ..tensor.creation import one_hot
from ..ops.sharded import (mesh_flash_attention, mesh_flash_supported, mesh_rms_norm,
                           mesh_rms_norm_supported, mesh_route)

__all__ = ["linear", "embedding", "rms_norm", "layer_norm", "gelu", "swiglu",
           "dropout", "scaled_dot_product_attention", "cross_entropy",
           "gather_tree", "fused_linear_cross_entropy",
           # activations
           "relu", "relu6", "sigmoid", "tanh", "softplus", "softsign", "silu",
           "log_sigmoid", "swish", "mish", "hardswish", "hardsigmoid", "hardtanh",
           "elu", "selu", "celu", "tanhshrink", "leaky_relu", "prelu", "hardshrink",
           "softshrink", "thresholded_relu", "softmax", "log_softmax", "glu",
           "maxout", "rrelu",
           # losses and distances
           "nll_loss", "mse_loss", "l1_loss", "smooth_l1_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits", "kl_div",
           "cosine_similarity", "cosine_embedding_loss", "margin_ranking_loss",
           "ctc_loss", "gaussian_nll_loss", "poisson_nll_loss",
           "hinge_embedding_loss", "soft_margin_loss", "multi_label_soft_margin_loss",
           "multi_margin_loss", "triplet_margin_loss",
           "triplet_margin_with_distance_loss", "pairwise_distance",
           # convolutions, pooling, the image norms and functionals
           "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
           "conv3d_transpose", "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "batch_norm", "group_norm", "instance_norm", "normalize",
           "local_response_norm", "interpolate", "upsample", "pixel_shuffle",
           "pixel_unshuffle", "channel_shuffle", "unfold", "zeropad2d", "bilinear", "pad",
           "dropout2d", "dropout3d", "alpha_dropout"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, name=None) -> torch.Tensor:
    """x [..., in] @ weight [in, out] (paddle's layout), + bias [out];
    under ``amp.auto_cast`` the three in the amp dtype ("linear")."""
    x, weight = maybe_autocast_tensors("linear", x, weight)
    if bias is not None:
        (bias,) = maybe_autocast_tensors("linear", bias)
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
    flag off.  While a program is exported, the flag-on call is traced as
    the ``paddle_tpu_torch::rms_norm`` operator."""
    if export_route("use_fused_rms_norm"):
        return exported_op("rms_norm")(x, weight, epsilon)[0]
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
        if export_route("use_fused_swiglu"):
            return exported_op("swiglu")(x, y)
        if use_function("use_fused_swiglu", x, y):
            return SwiGLUFunction.apply(x, y)
        return fused_swiglu(x, y)
    return torch.nn.functional.silu(x) * y


def dropout(x: torch.Tensor, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None) -> torch.Tensor:
    """Each element (or each slice along ``axis``) zeroed with probability
    ``p`` in training, the mask drawn through the seam
    (``framework.random._keep_mask``).  ``upscale_in_train`` divides the
    kept values by 1 − p in the form the reference's compiled step takes
    on XLA: an f32 tensor times the reciprocal (XLA folds the division by
    a constant), a half tensor divided by 1 − p rounded to its dtype (the
    weak-typed scalar).  ``downscale_in_infer`` keeps them and multiplies
    by 1 − p in eval.  Identity at p = 0 or in eval (``upscale_in_train``);
    zeros at p = 1."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = tuple(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(shape))
    keep = _random._keep_mask(shape, 1.0 - p, x.device)
    if mode == "upscale_in_train":
        if x.dtype in (torch.float16, torch.bfloat16):
            # 1 - p rounded on the host: a card tensor made from a Python
            # number is a host-to-device copy, which syncs
            x = x / float(torch.tensor(1.0 - p, dtype=x.dtype))
        else:
            x = x * (1.0 / (1.0 - p))
    return torch.where(keep, x, 0.0)


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
    non-zero ``dropout_p`` in training also takes the composite, which
    drops the f32 probabilities with a mask drawn through the seam, as the
    reference's flash gate refuses dropout.  Under ``amp.auto_cast`` q, k
    and v are cast to the amp dtype first ("sdpa")."""
    query, key, value = maybe_autocast_tensors("sdpa", query, key, value)
    p = dropout_p if training else 0.0
    if p > 0.0:
        return sdpa_reference(query, key, value, mask=attn_mask, is_causal=is_causal,
                              dropout_p=p,
                              dropout_key=_random._scoped() or _random.default_generator)
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
    off.  While a program is exported, the flag-on call is traced as the
    ``paddle_tpu_torch::flash_attention`` operator."""
    if export_route("use_flash_attention"):
        return exported_op("flash_attention")(query, key, value, is_causal)[0]
    if use_function("use_flash_attention", query, key, value):
        return FlashAttentionFunction.apply(query, key, value, is_causal)
    if use_kernel("use_flash_attention", query):
        return flash_attention_fwd(query, key, value, causal=is_causal)[0]
    return sdpa_reference(query, key, value, is_causal=is_causal)


def _reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None) -> torch.Tensor:
    """Softmax cross entropy over the class axis ``axis``, log-softmax in
    f32; with ``use_softmax=False``, ``input`` holds probabilities and
    their log is taken (floored at 1e-30).  Hard labels (``input``'s shape
    without that axis, or with it of size 1): labels equal to
    ``ignore_index`` add nothing, class ``weight``s scale each term, and
    ``"mean"`` divides by the number of the others (at least 1), or with
    weights by their summed weight.  ``soft_label``: ``label`` holds a
    distribution over the classes; ``weight`` and ``ignore_index`` do not
    apply and ``"mean"`` averages every term, as in the reference.
    ``label_smoothing`` mixes the target with the uniform one."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got {reduction!r}")
    axis = axis % input.dim()
    x = input.float().movedim(axis, -1)
    logp = torch.log_softmax(x, dim=-1) if use_softmax else x.clamp(min=1e-30).log()
    n_class = logp.shape[-1]
    if soft_label:
        soft = label.float().movedim(axis, -1)
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_class
        return _reduce_loss(-(soft * logp).sum(-1), reduction)
    hard = label.squeeze(axis) if label.dim() == input.dim() else label
    valid = hard != ignore_index
    picked = logp.gather(-1, torch.where(valid, hard, 0).long()[..., None])[..., 0]
    loss = -picked
    if label_smoothing > 0.0:
        loss = (1 - label_smoothing) * loss - label_smoothing / n_class * logp.sum(-1)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is None:
        count = valid.sum().clamp(min=1)
    else:
        w = torch.as_tensor(weight, device=loss.device).float()[hard.long().clamp(0, n_class - 1)]
        loss = loss * w
        count = torch.where(valid, w, torch.zeros_like(w)).sum().clamp(min=1e-12)
    return loss.sum() / count if reduction == "mean" else _reduce_loss(loss, reduction)


class _FusedLinearCE(torch.autograd.Function):
    """Mean cross entropy of ``hidden @ weight`` over token chunks, with
    only ``hidden``, ``weight`` and ``labels`` kept for the backward."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, chunk, ignore_index):
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        count = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for lo in range(0, hidden.shape[0], chunk):
            lc = labels[lo:lo + chunk]
            valid = lc != ignore_index
            logits = (hidden[lo:lo + chunk] @ weight).float()
            gold = logits.gather(-1, torch.where(valid, lc, 0)[:, None])[:, 0]
            per_tok = torch.where(valid, torch.logsumexp(logits, -1) - gold, 0.0)
            total = total + per_tok.sum()
            count = count + valid.sum(dtype=torch.float32)
        ctx.save_for_backward(hidden, weight, labels)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        return total / count.clamp(min=1.0)

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels = ctx.saved_tensors
        want_h, want_w = ctx.needs_input_grad[:2]
        scale = g.float() / (labels != ctx.ignore_index).sum(dtype=torch.float32).clamp(min=1.0)
        dh = torch.empty_like(hidden) if want_h else None
        dw = torch.zeros(weight.shape, dtype=torch.float32, device=weight.device) \
            if want_w else None
        for lo in range(0, hidden.shape[0], ctx.chunk):
            hc, lc = hidden[lo:lo + ctx.chunk], labels[lo:lo + ctx.chunk]
            valid = lc != ctx.ignore_index
            d_logits = torch.softmax((hc @ weight).float(), -1)
            d_logits.scatter_add_(-1, torch.where(valid, lc, 0)[:, None],
                                  torch.full_like(d_logits[:, :1], -1.0))
            # the VJP of the reference's .astype(f32): the cotangent rounds to
            # the products' dtype before both products
            d_logits = (d_logits * (valid.float() * scale)[:, None]).to(hidden.dtype)
            if want_h:
                dh[lo:lo + ctx.chunk] = d_logits @ weight.T
            if want_w:
                dw += hc.T @ d_logits
        return dh, None if dw is None else dw.to(weight.dtype), None, None, None


def fused_linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                               labels: torch.Tensor, chunk_size: int = 1024,
                               ignore_index: int = -100, name=None) -> torch.Tensor:
    """Mean softmax cross entropy of ``hidden`` [tokens, d] @ ``weight``
    [d, vocab] against ``labels`` [tokens] without the full [tokens, vocab]
    logits: the tokens run in chunks of ``min(chunk_size, tokens)`` (the
    divisible chunks, then one remainder chunk), each chunk's logits made
    in the inputs' dtype and cast to f32 after the product, as the
    reference's ``(hc @ w).astype(f32)``, then dropped.  ``ignore_index``
    tokens count in neither the sum nor the count; the loss is the f32
    total over ``max(count, 1)``, the chunks' sums added in order.

    The backward saves no logits: it recomputes each chunk's, takes
    ``(softmax - onehot) * valid * g / count`` in f32, rounds it to the
    inputs' dtype and forms ``dh`` for the chunk and its ``hᵀ @ d_logits``
    term of ``dW``.  The terms are added in chunk order into an f32
    accumulator, which rounds once to the weight's dtype at the end
    (the reference's scan adds them in the weight's dtype).  The products
    are plain matmuls, as the reference leaves them to XLA."""
    labels = torch.as_tensor(labels, device=hidden.device).reshape(-1).long()
    chunk = min(int(chunk_size), hidden.shape[0])
    return _FusedLinearCE.apply(hidden, weight, labels, chunk, ignore_index)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def _unary(name: str, fn: Callable):
    def op(x, name_=None, **kw):
        return fn(x, **kw)

    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"``{name}`` elementwise, in x's dtype."
    return op


relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", torch.nn.functional.relu6)
sigmoid = _unary("sigmoid", torch.sigmoid)
tanh = _unary("tanh", torch.tanh)
softplus = _unary("softplus", lambda v: torch.logaddexp(v, torch.zeros_like(v)))
softsign = _unary("softsign", lambda v: v / (1 + v.abs()))
silu = _unary("silu", torch.nn.functional.silu)
log_sigmoid = _unary("log_sigmoid", torch.nn.functional.logsigmoid)
swish = silu
mish = _unary("mish", lambda v: v * torch.tanh(softplus(v)))
hardswish = _unary("hardswish", lambda v: v * torch.nn.functional.relu6(v + 3.0) / 6.0)
hardsigmoid = _unary("hardsigmoid", lambda v: (v / 6.0 + 0.5).clamp(0.0, 1.0))
hardtanh = _unary("hardtanh", lambda v, min=-1.0, max=1.0: v.clamp(min, max))
elu = _unary("elu", lambda v, alpha=1.0: torch.where(v > 0, v, alpha * torch.expm1(v)))
_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805
selu = _unary("selu", lambda v: _SELU_SCALE * torch.where(
    v > 0, v, _SELU_ALPHA * torch.expm1(v)))
celu = _unary("celu", lambda v, alpha=1.0: v.clamp(min=0)
              + alpha * torch.expm1(v.clamp(max=0) / alpha))
tanhshrink = _unary("tanhshrink", lambda v: v - torch.tanh(v))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01, name=None) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x: torch.Tensor, weight: torch.Tensor, data_format: str = "NCHW",
          name=None) -> torch.Tensor:
    """x where x >= 0, else weight * x; a weight of several values lies
    along the channel axis (1, or the last for channels-last)."""
    if weight.numel() > 1 and x.dim() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x >= 0, x, weight * x)


def hardshrink(x: torch.Tensor, threshold: float = 0.5, name=None) -> torch.Tensor:
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x: torch.Tensor, threshold: float = 0.5, name=None) -> torch.Tensor:
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, torch.zeros_like(x)))


def thresholded_relu(x: torch.Tensor, threshold: float = 1.0, value: float = 0.0,
                     name=None) -> torch.Tensor:
    return torch.where(x > threshold, x, torch.full_like(x, value))


def softmax(x: torch.Tensor, axis: int = -1, dtype=None, name=None) -> torch.Tensor:
    """Softmax along ``axis`` in x's dtype (``dtype`` is accepted and, as in
    the reference, not read)."""
    return torch.softmax(x, dim=axis)


def log_softmax(x: torch.Tensor, axis: int = -1, dtype=None, name=None) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


def glu(x: torch.Tensor, axis: int = -1, name=None) -> torch.Tensor:
    """First half of ``axis`` times the sigmoid of the second."""
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x: torch.Tensor, groups: int, axis: int = 1, name=None) -> torch.Tensor:
    """The largest of each run of ``groups`` channels along ``axis``."""
    ax = axis % x.dim()
    c = x.shape[ax]
    return x.reshape(x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]).amax(ax + 1)


def rrelu(x: torch.Tensor, lower: float = 1.0 / 8.0, upper: float = 1.0 / 3.0,
          training: bool = True, name=None) -> torch.Tensor:
    """Leaky ReLU whose slope is the mean of [lower, upper] outside
    training; in training each element's slope is drawn uniform in
    [lower, upper) in f32 through the seam (``framework.random._uniform``)
    and cast to x's dtype."""
    if not 0 <= lower <= upper <= 1:
        raise ValueError(f"rrelu requires 0 <= lower <= upper <= 1, got [{lower}, {upper}]")
    if not training:
        return torch.where(x >= 0, x, (lower + upper) / 2 * x)
    slope = _random._uniform(x.shape, lower, upper, x.device).to(x.dtype)
    return torch.where(x >= 0, x, slope * x)


# ---------------------------------------------------------------------------
# losses and distances
# ---------------------------------------------------------------------------
def nll_loss(input: torch.Tensor, label: torch.Tensor, weight=None,
             ignore_index: int = -100, reduction: str = "mean", name=None) -> torch.Tensor:
    """Negative log-likelihood of log-probabilities ``input`` [N, C, ...]
    at ``label`` [N, ...]; ignored labels add nothing and the mean divides
    by the others' count, or their summed class weight."""
    n_class = input.shape[1]
    lbl = label.long()
    picked = input.gather(1, lbl.clamp(0, n_class - 1).unsqueeze(1)).squeeze(1)
    valid = lbl != ignore_index
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if weight is not None:
        wt = torch.as_tensor(weight, device=input.device)[lbl.clamp(0, n_class - 1)]
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / torch.where(valid, wt, torch.zeros_like(wt)).sum().clamp(
                min=1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1)
    return _reduce_loss(loss, reduction)


def mse_loss(input: torch.Tensor, label: torch.Tensor, reduction: str = "mean",
             name=None) -> torch.Tensor:
    return _reduce_loss((input - label).square(), reduction)


def l1_loss(input: torch.Tensor, label: torch.Tensor, reduction: str = "mean",
            name=None) -> torch.Tensor:
    return _reduce_loss((input - label).abs(), reduction)


def smooth_l1_loss(input: torch.Tensor, label: torch.Tensor, reduction: str = "mean",
                   delta: float = 1.0, name=None) -> torch.Tensor:
    d = input - label
    loss = torch.where(d.abs() < delta, 0.5 * d * d / delta, d.abs() - 0.5 * delta)
    return _reduce_loss(loss, reduction)


def binary_cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                         reduction: str = "mean", name=None) -> torch.Tensor:
    """BCE of probabilities ``input`` (clipped to [1e-12, 1 - 1e-12], f32)."""
    p = input.float().clamp(1e-12, 1 - 1e-12)
    loss = -(label * p.log() + (1 - label) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit: torch.Tensor, label: torch.Tensor, weight=None,
                                     reduction: str = "mean", pos_weight=None,
                                     name=None) -> torch.Tensor:
    """BCE of the logits' sigmoid in the stable form, f32; ``pos_weight``
    scales the positive term."""
    z = logit.float()
    loss = z.clamp(min=0) - z * label + torch.log1p(torch.exp(-z.abs()))
    if pos_weight is not None:
        loss = loss * ((torch.as_tensor(pos_weight, device=z.device) - 1) * label + 1)
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def kl_div(input: torch.Tensor, label: torch.Tensor, reduction: str = "mean",
           log_target: bool = False, name=None) -> torch.Tensor:
    """KL divergence of ``label`` from the log-probabilities ``input``;
    ``"batchmean"`` divides the sum by the batch size."""
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (label.clamp(min=1e-30).log() - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce_loss(loss, reduction)


def cosine_similarity(x1: torch.Tensor, x2: torch.Tensor, axis: int = 1,
                      eps: float = 1e-8) -> torch.Tensor:
    num = (x1 * x2).sum(axis)
    den = torch.linalg.vector_norm(x1, dim=axis) * torch.linalg.vector_norm(x2, dim=axis)
    return num / den.clamp(min=eps)


def cosine_embedding_loss(input1: torch.Tensor, input2: torch.Tensor, label: torch.Tensor,
                          margin: float = 0.0, reduction: str = "mean",
                          name=None) -> torch.Tensor:
    sim = cosine_similarity(input1, input2, axis=1)
    loss = torch.where(label > 0, 1 - sim, (sim - margin).clamp(min=0.0))
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input: torch.Tensor, other: torch.Tensor, label: torch.Tensor,
                        margin: float = 0.0, reduction: str = "mean",
                        name=None) -> torch.Tensor:
    return _reduce_loss((-label * (input - other) + margin).clamp(min=0.0), reduction)


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor, input_lengths,
             label_lengths, blank: int = 0, reduction: str = "mean",
             norm_by_times: bool = False) -> torch.Tensor:
    """CTC of raw logits ``log_probs`` [T, B, C] (log-softmax taken inside,
    f32) against ``labels`` [B, L] with per-sample lengths.  The alignment
    sum is torch's ``ctc_loss``, which the reference computes in a
    ``lax.scan`` with no kernel of its own; the reductions are the
    reference's: ``norm_by_times`` divides each loss by its input length,
    and ``"mean"`` averages the losses each divided by its label length
    (at least 1)."""
    logp = torch.log_softmax(log_probs.float(), dim=-1)
    dev = logp.device
    in_len = torch.as_tensor(input_lengths, device=dev).long()
    lab_len = torch.as_tensor(label_lengths, device=dev).long()
    loss = torch.nn.functional.ctc_loss(logp, torch.as_tensor(labels, device=dev).long(),
                                        in_len, lab_len, blank=blank, reduction="none")
    if norm_by_times:
        loss = loss / in_len.float().clamp(min=1.0)
    if reduction == "mean":
        return (loss / lab_len.float().clamp(min=1.0)).mean()
    return loss.sum() if reduction == "sum" else loss


def gaussian_nll_loss(input: torch.Tensor, label: torch.Tensor, variance: torch.Tensor,
                      full: bool = False, epsilon: float = 1e-6, reduction: str = "mean",
                      name=None) -> torch.Tensor:
    var = variance.clamp(min=epsilon)
    out = 0.5 * (var.log() + (label - input).square() / var)
    if full:
        out = out + 0.5 * math.log(2 * math.pi)
    return _reduce_loss(out, reduction)


def poisson_nll_loss(input: torch.Tensor, label: torch.Tensor, log_input: bool = True,
                     full: bool = False, epsilon: float = 1e-8, reduction: str = "mean",
                     name=None) -> torch.Tensor:
    """Poisson NLL; ``full`` adds Stirling's term where the label exceeds 1."""
    out = torch.exp(input) - label * input if log_input \
        else input - label * torch.log(input + epsilon)
    if full:
        stirling = label * torch.log(label + epsilon) - label \
            + 0.5 * torch.log(2 * math.pi * (label + epsilon))
        out = out + torch.where(label > 1, stirling, torch.zeros_like(stirling))
    return _reduce_loss(out, reduction)


def hinge_embedding_loss(input: torch.Tensor, label: torch.Tensor, margin: float = 1.0,
                         reduction: str = "mean", name=None) -> torch.Tensor:
    out = torch.where(label == 1.0, input, (margin - input).clamp(min=0.0))
    return _reduce_loss(out, reduction)


def soft_margin_loss(input: torch.Tensor, label: torch.Tensor, reduction: str = "mean",
                     name=None) -> torch.Tensor:
    return _reduce_loss(softplus(-label * input), reduction)


def multi_label_soft_margin_loss(input: torch.Tensor, label: torch.Tensor, weight=None,
                                 reduction: str = "mean", name=None) -> torch.Tensor:
    logsig = torch.nn.functional.logsigmoid
    out = -(label * logsig(input) + (1 - label) * logsig(-input))
    if weight is not None:
        out = out * weight
    return _reduce_loss(out.mean(-1), reduction)


def multi_margin_loss(input: torch.Tensor, label: torch.Tensor, p: int = 1,
                      margin: float = 1.0, weight=None, reduction: str = "mean",
                      name=None) -> torch.Tensor:
    """Multi-class hinge: the mean over the other classes of
    ``max(0, margin - x[label] + x[c]) ** p``, each sample scaled by
    ``weight[label]``."""
    n, c = input.shape
    lbl = label.long()
    gold = input.gather(1, lbl[:, None])
    m = (margin - gold + input).clamp(min=0.0) ** p
    m = m * (1 - torch.nn.functional.one_hot(lbl, c).to(input.dtype))
    per_sample = m.sum(1) / c
    if weight is not None:
        per_sample = per_sample * weight[lbl]
    return _reduce_loss(per_sample, reduction)


def pairwise_distance(x: torch.Tensor, y: torch.Tensor, p: float = 2.0,
                      epsilon: float = 1e-6, keepdim: bool = False,
                      name=None) -> torch.Tensor:
    """``(sum |x - y + epsilon| ** p) ** (1 / p)`` over the last axis."""
    return ((x - y + epsilon).abs() ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)


def triplet_margin_loss(input: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 1.0, p: float = 2.0,
                        epsilon: float = 1e-6, swap: bool = False,
                        reduction: str = "mean", name=None) -> torch.Tensor:
    return triplet_margin_with_distance_loss(
        input, positive, negative, distance_function=None, margin=margin, swap=swap,
        reduction=reduction, _p=p, _eps=epsilon)


def triplet_margin_with_distance_loss(input: torch.Tensor, positive: torch.Tensor,
                                      negative: torch.Tensor, distance_function=None,
                                      margin: float = 1.0, swap: bool = False,
                                      reduction: str = "mean", name=None,
                                      _p: float = 2.0, _eps: float = 1e-6) -> torch.Tensor:
    """``max(0, d(a, pos) - d(a, neg) + margin)``, ``d`` the caller's
    distance or the p-norm of ``pairwise_distance``; ``swap`` takes the
    smaller of d(a, neg) and d(pos, neg)."""
    dist = distance_function or (lambda u, v: pairwise_distance(u, v, _p, _eps))
    d_ap, d_an = dist(input, positive), dist(input, negative)
    if swap:
        d_an = torch.minimum(d_an, dist(positive, negative))
    return _reduce_loss((d_ap - d_an + margin).clamp(min=0.0), reduction)


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


# ---------------------------------------------------------------------------
# dropout on image axes
# ---------------------------------------------------------------------------
def dropout2d(x: torch.Tensor, p: float = 0.5, training: bool = True,
              data_format: str = "NCHW", name=None) -> torch.Tensor:
    """Whole channels dropped: :func:`dropout` with a mask over the batch
    and channel axes of [N, C, H, W] (``NHWC``: [N, H, W, C])."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x: torch.Tensor, p: float = 0.5, training: bool = True,
              data_format: str = "NCDHW", name=None) -> torch.Tensor:
    """As :func:`dropout2d`, on [N, C, D, H, W] (``NDHWC``)."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
                  name=None) -> torch.Tensor:
    """SELU-preserving dropout: dropped elements take SELU's negative
    saturation, then an affine map keeps the mean and variance (the
    reference's constants; the map in f32, out in x's dtype).  Identity at
    p = 0 or outside training."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = _random._keep_mask(x.shape, 1.0 - p, x.device)
    a = 1.0 / math.sqrt((1 - p) * (1 + p * alpha_p ** 2))
    b = -a * alpha_p * p
    kept = torch.where(keep, x, alpha_p)
    return (a * kept.to(torch.promote_types(x.dtype, torch.float32)) + b).to(x.dtype)


# ---------------------------------------------------------------------------
# convolutions
#
# The reference computes each with one ``lax.conv_general_dilated`` (XLA,
# no Pallas kernel); here it is one torch convolution (cuDNN on the card).
# Layouts: ``data_format`` "NC..." takes and gives channels-first tensors,
# "N...C" channels-last ones, and the boundary form "IN:OUT" (say
# "NCHW:NHWC") takes one and gives the other.  A channels-last tensor seen
# through ``movedim(-1, 1)`` is a channels_last-strided NCHW tensor with no
# copy, and cuDNN picks its NHWC kernels for it; at the boundary into NHWC
# the weight is made channels_last so that the output comes out in that
# memory order.  Padding pairs torch's convolution cannot take (unequal
# sides, XLA's "SAME" at stride > 1) are applied by ``F.pad`` first.
# ---------------------------------------------------------------------------
_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}
_CONV_T = {1: torch.nn.functional.conv_transpose1d, 2: torch.nn.functional.conv_transpose2d,
           3: torch.nn.functional.conv_transpose3d}
_LAST = {2: torch.channels_last, 3: torch.channels_last_3d}


def _tuple_n(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def _conv_padding(padding, nd):
    """``padding`` as the reference reads it: a string (upper-cased), or
    ``nd`` (low, high) pairs from an int, ``nd`` ints, ``2 nd`` ints or
    pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    return [tuple(p) for p in padding]


def _padtype_pairs(kind: str, sizes, windows, strides):
    """XLA's pairs for string padding (``lax.padtype_to_pads``): "SAME"
    gives ceil(n / s) outputs with the odd pad on the high side,
    "SAME_LOWER" on the low side, "VALID" none.  ``windows`` are the
    dilated window extents."""
    if kind == "VALID":
        return [(0, 0)] * len(sizes)
    if kind not in ("SAME", "SAME_LOWER"):
        raise ValueError(f"unknown padding {kind!r}: SAME, SAME_LOWER or VALID")
    pairs = []
    for n, k, s in zip(sizes, windows, strides):
        total = max(0, (-(-n // s) - 1) * s + k - n)
        lo = total // 2 if kind == "SAME" else total - total // 2
        pairs.append((lo, total - lo))
    return pairs


def _flat_pad(pairs):
    """(low, high) pairs of the leading spatial axis first, as F.pad's flat
    list (last axis first)."""
    return [int(v) for lo, hi in reversed(pairs) for v in (lo, hi)]


def _channels_first(x: torch.Tensor, fmt: str) -> torch.Tensor:
    return x if fmt.startswith("NC") else x.movedim(-1, 1)


def _to_format(y: torch.Tensor, fmt: str) -> torch.Tensor:
    return y if fmt.startswith("NC") else y.movedim(1, -1)


def _convnd(x, weight, bias, stride, padding, dilation, groups, nd, data_format, name):
    # under amp.auto_cast the pair in the amp dtype ("conv"); the weight and
    # bias then follow the input's dtype, as the reference's w.astype(v.dtype)
    x, weight = maybe_autocast_tensors("conv", x, weight)
    strides, dil = _tuple_n(stride, nd), _tuple_n(dilation, nd)
    in_fmt, _, out_fmt = data_format.partition(":")
    out_fmt = out_fmt or in_fmt
    v = _channels_first(x, in_fmt)
    w = weight.to(v.dtype)
    if not out_fmt.startswith("NC") and in_fmt.startswith("NC") and nd in _LAST:
        w = w.contiguous(memory_format=_LAST[nd])
    pad = _conv_padding(padding, nd)
    if isinstance(pad, str):
        ks = w.shape[2:]
        pad = _padtype_pairs(pad, v.shape[2:], [d * (k - 1) + 1 for k, d in zip(ks, dil)],
                             strides)
    if all(lo == hi >= 0 for lo, hi in pad):
        torch_pad = [lo for lo, _ in pad]
    else:
        v = torch.nn.functional.pad(v, _flat_pad(pad))
        torch_pad = 0
    b = None if bias is None else bias.to(v.dtype)
    return _to_format(_CONV[nd](v, w, b, strides, torch_pad, dil, groups), out_fmt)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None) -> torch.Tensor:
    """1-D convolution, weight [out, in/groups, k]; see :func:`conv2d`."""
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 1, data_format,
                   "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None) -> torch.Tensor:
    """2-D convolution, weight [out, in/groups, kh, kw] in every layout.
    ``padding``: an int, ints a side, (low, high) pairs, or "SAME"/"VALID"
    as XLA pads them; ``data_format``: "NCHW", "NHWC" or "NCHW:NHWC"-style
    boundaries."""
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 2, data_format,
                   "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None) -> torch.Tensor:
    """3-D convolution, weight [out, in/groups, kd, kh, kw]; see :func:`conv2d`."""
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 3, data_format,
                   "conv3d")


def _convnd_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups, nd,
                      data_format, name):
    """The reference's transpose: a convolution over the input dilated by
    ``stride``, with the kernel flipped and padded by d·(k−1) − p and
    ``output_padding`` more on the high side.  That is torch's transpose
    without padding, cropped by p on each side and grown (zeros) by
    ``output_padding`` on the high side, then the bias."""
    strides, dil = _tuple_n(stride, nd), _tuple_n(dilation, nd)
    opad = _tuple_n(output_padding, nd)
    v = _channels_first(x, data_format)
    w = weight.to(v.dtype)
    ks = w.shape[2:]
    pad = _conv_padding(padding, nd)
    if isinstance(pad, str):
        if any(s != 1 for s in strides):
            raise ValueError("string padding is not implemented for a transposed "
                             "convolution with stride > 1: give the padding pairs")
        conv_pairs = _padtype_pairs(pad, v.shape[2:], [d * (k - 1) + 1 for k, d in
                                                       zip(ks, dil)], strides)
        crop = [(d * (k - 1) - lo, d * (k - 1) - hi) for (lo, hi), k, d in
                zip(conv_pairs, ks, dil)]
    else:
        crop = [(lo, hi - o) for (lo, hi), o in zip(pad, opad)]
    out = _CONV_T[nd](v, w, None, strides, 0, 0, groups, dil)
    if any(c != (0, 0) for c in crop):
        out = torch.nn.functional.pad(out, [-c for c in _flat_pad(crop)])
    if bias is not None:
        out = out + bias.to(v.dtype).reshape((-1,) + (1,) * nd)
    return _to_format(out, data_format)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, output_size=None, data_format="NCL", name=None):
    """Transposed 1-D convolution, weight [in, out/groups, k]; ``output_size``
    is taken and not read, as in the reference."""
    return _convnd_transpose(x, weight, bias, stride, padding, output_padding, dilation,
                             groups, 1, data_format, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, output_size=None, data_format="NCHW", name=None):
    """Transposed 2-D convolution, weight [in, out/groups, kh, kw];
    ``output_size`` is taken and not read, as in the reference."""
    return _convnd_transpose(x, weight, bias, stride, padding, output_padding, dilation,
                             groups, 2, data_format, "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, output_size=None, data_format="NCDHW", name=None):
    """Transposed 3-D convolution, weight [in, out/groups, kd, kh, kw];
    ``output_size`` is taken and not read, as in the reference."""
    return _convnd_transpose(x, weight, bias, stride, padding, output_padding, dilation,
                             groups, 3, data_format, "conv3d_transpose")


# ---------------------------------------------------------------------------
# pooling (the reference's ``reduce_window``; torch's pools here)
# ---------------------------------------------------------------------------
_MAX_POOL = {1: torch.nn.functional.max_pool1d, 2: torch.nn.functional.max_pool2d,
             3: torch.nn.functional.max_pool3d}
_AVG_POOL = {1: torch.nn.functional.avg_pool1d, 2: torch.nn.functional.avg_pool2d,
             3: torch.nn.functional.avg_pool3d}


def _ceil_extra(n: int, k: int, s: int, lo: int, hi: int) -> int:
    """Extra high-side padding for ``ceil_mode``'s output size; the last
    window must start inside the input or its low padding."""
    out_ceil = math.ceil((n + lo + hi - k) / s) + 1
    if (out_ceil - 1) * s >= n + lo:
        out_ceil -= 1
    return max(0, (out_ceil - 1) * s + k - (n + lo + hi))


def _torch_pad_ok(pairs, ks) -> bool:
    """Whether torch's pool takes ``pairs`` as its own padding (equal
    sides, at most half the window)."""
    return all(lo == hi and 0 <= lo <= k // 2 for (lo, hi), k in zip(pairs, ks))


def _window_sum(v: torch.Tensor, ks, st) -> torch.Tensor:
    """Sums over the windows of an unpadded channels-first tensor."""
    if len(ks) == 1:
        return torch.nn.functional.avg_pool2d(v.unsqueeze(-2), (1, ks[0]), (1, st[0]),
                                              divisor_override=1).squeeze(-2)
    return _AVG_POOL[len(ks)](v, ks, st, divisor_override=1)


def _pool(x, kernel, stride, padding, nd, kind, data_format, ceil_mode=False,
          count_include_pad=True):
    """Max or average over windows, as the reference's ``_pool``: padding
    read as the convolutions read it, ``ceil_mode`` as extra high-side
    padding no window counts (``_ceil_extra``), the average's divisor the
    window size (``count_include_pad``, or no padding at all) or the count
    of input elements under it."""
    ks = _tuple_n(kernel, nd)
    st = _tuple_n(stride if stride is not None else kernel, nd)
    v = _channels_first(x, data_format)
    pad = _conv_padding(padding, nd)
    from_str = isinstance(pad, str)
    spatial = tuple(v.shape[2:])
    pairs = _padtype_pairs(pad, spatial, ks, st) if from_str else [tuple(p) for p in pad]
    extras = (0,) * nd
    if ceil_mode and not from_str:
        extras = tuple(_ceil_extra(n, k, s, lo, hi)
                       for (lo, hi), n, k, s in zip(pairs, spatial, ks, st))
    full = [(lo, hi + e) for (lo, hi), e in zip(pairs, extras)]
    if kind == "max":
        if _torch_pad_ok(full, ks):
            return _to_format(_MAX_POOL[nd](v, ks, st, [lo for lo, _ in full]), data_format)
        fill = -math.inf if v.is_floating_point() else torch.iinfo(v.dtype).min
        v = torch.nn.functional.pad(v, _flat_pad(full), value=fill)
        return _to_format(_MAX_POOL[nd](v, ks, st), data_format)
    no_pad = not from_str and all(p == (0, 0) for p in full)
    by_window = (count_include_pad and not any(extras)) or no_pad
    if by_window and _torch_pad_ok(full, ks):
        out = _AVG_POOL[nd](v, ks, st, [lo for lo, _ in full], count_include_pad=True)
        return _to_format(out, data_format)
    sums = _window_sum(torch.nn.functional.pad(v, _flat_pad(full)), ks, st)
    if by_window:
        return _to_format(sums / math.prod(ks), data_format)
    ones = torch.ones((1, 1) + spatial, dtype=torch.float32, device=v.device)
    if count_include_pad:   # the real padding counts, the ceil extension does not
        ones = torch.nn.functional.pad(ones, _flat_pad(pairs), value=1.0)
        ones = torch.nn.functional.pad(ones, _flat_pad([(0, e) for e in extras]))
    else:
        ones = torch.nn.functional.pad(ones, _flat_pad(full))
    counts = _window_sum(ones, ks, st)
    return _to_format(sums / counts.to(sums.dtype), data_format)


def _check_no_mask(return_mask):
    if return_mask:
        raise NotImplementedError(
            "return_mask=True (argmax indices for max_unpool) is not implemented: "
            "the reference has none either")


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCL", name=None):
    _check_no_mask(return_mask)
    return _pool(x, kernel_size, stride, padding, 1, "max", data_format, ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW", name=None):
    """Max over windows (-inf padding); ``return_mask`` raises."""
    _check_no_mask(return_mask)
    return _pool(x, kernel_size, stride, padding, 2, "max", data_format, ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCDHW", name=None):
    _check_no_mask(return_mask)
    return _pool(x, kernel_size, stride, padding, 3, "max", data_format, ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
               data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", data_format, ceil_mode,
                 count_include_pad=not exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    """Mean over windows; ``exclusive`` divides by the input elements a
    window covers (torch's ``count_include_pad=False``).
    ``divisor_override`` is taken and not read, as in the reference."""
    return _pool(x, kernel_size, stride, padding, 2, "avg", data_format, ceil_mode,
                 count_include_pad=not exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", data_format, ceil_mode,
                 count_include_pad=not exclusive)


_ADAPTIVE = {("avg", 1): torch.nn.functional.adaptive_avg_pool1d,
             ("avg", 2): torch.nn.functional.adaptive_avg_pool2d,
             ("avg", 3): torch.nn.functional.adaptive_avg_pool3d,
             ("max", 1): torch.nn.functional.adaptive_max_pool1d,
             ("max", 2): torch.nn.functional.adaptive_max_pool2d,
             ("max", 3): torch.nn.functional.adaptive_max_pool3d}


def _adaptive_pool(x, output_size, nd, mode, data_format):
    """Adaptive pooling with the reference's bins: bin i of an axis of S
    into O covers [floor(i·S/O), ceil((i+1)·S/O)), which are torch's; a
    ``None`` size keeps its axis.  (Where every axis divides, the
    reference takes a strided pool of the same windows.)"""
    if output_size is None or isinstance(output_size, int):
        output_size = (output_size,) * nd
    v = _channels_first(x, data_format)
    out = tuple(s if o is None else int(o) for s, o in zip(v.shape[2:], output_size))
    return _to_format(_ADAPTIVE[mode, nd](v, out if nd > 1 else out[0]), data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over adaptive bins (see ``_adaptive_pool``)."""
    return _adaptive_pool(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """Max over adaptive bins; ``return_mask`` is taken and not read, as in
    the reference."""
    return _adaptive_pool(x, output_size, 1, "max", "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """Max over adaptive bins; ``return_mask`` is taken and not read, as in
    the reference."""
    return _adaptive_pool(x, output_size, 2, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask: bool = False, name=None):
    if return_mask:
        raise NotImplementedError("adaptive_max_pool3d return_mask: argmax indices are "
                                  "not implemented, as in the reference")
    return _adaptive_pool(x, output_size, 3, "max", "NCDHW")


# ---------------------------------------------------------------------------
# batch, group, instance and local-response norms, normalize
# ---------------------------------------------------------------------------
def _affine(out: torch.Tensor, weight, bias, shape) -> torch.Tensor:
    """``out * weight + bias`` in f32, each reshaped to ``shape``."""
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training: bool = False,
               momentum: float = 0.9, epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats=None, name=None) -> torch.Tensor:
    """Batch norm over every axis but the channel's (1 for "NC...", the
    last otherwise), in f32, the affine in f32, rounded once to x's dtype.

    In training (unless ``use_global_stats``) it normalises with the
    batch's mean and biased variance, differentiated through, and updates
    the running buffers in place by paddle's rule ``r = m·r + (1 − m)·batch``
    (m = ``momentum``, the biased variance).  torch's ``batch_norm`` in
    training uses the momentum the other way round and the unbiased
    variance, so it is given no buffers.  Otherwise it normalises with the
    running statistics: torch's ``batch_norm`` in eval mode, the same
    formula in f32 (cuDNN on the card, NHWC kernels for a channels-last
    input)."""
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    if training and not use_global_stats:
        dims = tuple(i for i in range(x.dim()) if i != c_axis)
        shape = [1] * x.dim()
        shape[c_axis] = x.shape[c_axis]
        xf = x.float()
        var, mean = torch.var_mean(xf, dims, correction=0)
        out = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + epsilon)
        if running_mean is not None:
            with torch.no_grad():
                running_mean.copy_(momentum * running_mean
                                   + (1 - momentum) * mean.to(running_mean.dtype))
                running_var.copy_(momentum * running_var
                                  + (1 - momentum) * var.to(running_var.dtype))
        return _affine(out, weight, bias, shape).to(x.dtype)
    v = x if c_axis == 1 else x.movedim(-1, 1)
    out = torch.nn.functional.batch_norm(
        v, running_mean.float(), running_var.float(),
        None if weight is None else weight.float(), None if bias is None else bias.float(),
        training=False, eps=epsilon)
    return out if c_axis == 1 else out.movedim(1, -1)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None, data_format="NCHW",
               name=None) -> torch.Tensor:
    """Norm over each group of ``num_groups`` channel groups (and the
    spatial axes), f32 inside; "NHWC" raises, as in the reference."""
    if not data_format.startswith("NC"):
        raise NotImplementedError("group_norm: NHWC not yet supported (as in the reference)")
    n, c = x.shape[:2]
    xf = x.float().reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    var, mean = torch.var_mean(xf, tuple(range(2, xf.dim())), correction=0, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine(out, weight, bias, [1, c] + [1] * (x.dim() - 2)).to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-5, data_format="NCHW",
                  name=None) -> torch.Tensor:
    """Norm over each sample's channel (the axes after 1), f32 inside.  As
    in the reference, the running statistics, ``use_input_stats``,
    ``momentum`` and ``data_format`` are taken and not read."""
    xf = x.float()
    var, mean = torch.var_mean(xf, tuple(range(2, x.dim())), correction=0, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return _affine(out, weight, bias, [1, x.shape[1]] + [1] * (x.dim() - 2)).to(x.dtype)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None) -> torch.Tensor:
    """x over its p-norm along ``axis``, the norm floored at ``epsilon``."""
    n = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / n.clamp(min=epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                        name=None) -> torch.Tensor:
    """x / (k + alpha · (sum of squares over ``size`` channels) / size)^beta,
    the channels (axis 1) padded (size//2, size − size//2 − 1); as in the
    reference, ``data_format`` is not read."""
    c = x.shape[1]
    pads = [0, 0] * (x.dim() - 2) + [size // 2, size - size // 2 - 1]
    sq = torch.nn.functional.pad(x.square(), pads)
    acc = sum(sq[:, i:i + c] for i in range(size))
    return x / (k + alpha * acc / size) ** beta


# ---------------------------------------------------------------------------
# resampling and the image functionals
# ---------------------------------------------------------------------------
def _interp_coords(n_in, n_out, align_corners, align_mode):
    """Source coordinate of each output index (paddle's three rules)."""
    if align_corners:
        if n_out == 1:
            return np.zeros(1)
        return np.linspace(0.0, n_in - 1.0, n_out)
    ratio = n_in / n_out
    if align_mode == 1:  # asymmetric: src = i · ratio
        return np.arange(n_out) * ratio
    return (np.arange(n_out) + 0.5) * ratio - 0.5  # half-pixel


def _interp_matrix(n_in, n_out, align_corners, align_mode):
    """The (n_out, n_in) linear-interpolation weights of one axis."""
    coords = np.clip(_interp_coords(n_in, n_out, align_corners, align_mode), 0.0, n_in - 1.0)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w = coords - lo
    mat = np.zeros((n_out, n_in), np.float32)
    mat[np.arange(n_out), lo] += 1.0 - w
    mat[np.arange(n_out), hi] += w
    return mat


def _triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x):
    """Keys' cubic kernel with a = −0.5 (torch's bicubic uses −0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _resize_matrix(n_in, n_out, kernel):
    """The (n_out, n_in) weights of ``jax.image.resize`` on one axis
    (``scale_and_translate``): half-pixel centres, the kernel widened by
    the scale when shrinking (antialias, JAX's default), each row
    normalised over the taps inside the input, in f32."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    w = kernel(np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
               / kernel_scale).astype(np.float32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(np.float32)


def _resample(v: torch.Tensor, mats, first: int) -> torch.Tensor:
    """Each spatial axis ``first + i`` multiplied by ``mats[i]`` (None:
    the axis is kept)."""
    for i, mat in enumerate(mats):
        if mat is None:
            continue
        m = torch.from_numpy(mat).to(device=v.device, dtype=v.dtype)
        v = torch.matmul(v.movedim(first + i, -1), m.T).movedim(-1, first + i)
    return v


def _take(v: torch.Tensor, idxs, first: int) -> torch.Tensor:
    for i, idx in enumerate(idxs):
        if idx is not None:
            v = v.index_select(first + i, torch.from_numpy(idx).to(v.device))
    return v


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
                align_mode=0, data_format="NCHW", name=None) -> torch.Tensor:
    """Resize the spatial axes to ``size`` (or times ``scale_factor``,
    floored), as the reference computes it:

    - ``"area"``: the adaptive average pool;
    - a linear mode with ``align_corners`` or ``align_mode=1``: separable
      interpolation matrices (corner-aligned or src = i · in/out), in f32;
    - ``"nearest"`` with ``align_corners``: the index floor(src + 0.5);
    - otherwise ``jax.image.resize``'s rules: ``"nearest"`` takes index
      floor((i + 0.5) · in/out) (torch's ``"nearest-exact"``, not its
      ``"nearest"``); ``"linear"``/``"bilinear"``/``"trilinear"`` and
      ``"bicubic"`` are the triangle and Keys (a = −0.5) kernels with
      half-pixel centres, widened when shrinking (antialias).  torch's
      modes differ (bicubic a = −0.75, no antialias by default), so the
      weights are built here, one matrix an axis.

    Another mode with ``align_corners`` raises, as in the reference."""
    first = 2 if data_format.startswith("NC") else 1
    spatial = tuple(x.shape[first:first + x.dim() - 2])
    nd = len(spatial)
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * nd
        size = tuple(int(s * f) for s, f in zip(spatial, scale_factor))
    else:
        size = _tuple_n(size, nd)
    if mode == "area":
        return _adaptive_pool(x, size, nd, "avg", data_format)
    linear = ("linear", "bilinear", "trilinear")
    if (align_corners or align_mode == 1) and mode in linear:
        mats = [_interp_matrix(s, o, align_corners, align_mode) for s, o in zip(spatial, size)]
        return _resample(x.float(), mats, first).to(x.dtype)
    if align_corners and mode == "nearest":
        idxs = [np.floor(_interp_coords(s, o, True, 0) + 0.5).astype(np.int64).clip(0, s - 1)
                for s, o in zip(spatial, size)]
        return _take(x, idxs, first)
    if align_corners:
        raise NotImplementedError(
            f"interpolate(mode={mode!r}, align_corners=True) is not supported, as in the "
            f"reference")
    kernel = {"nearest": None, "bilinear": _triangle, "linear": _triangle,
              "bicubic": _keys_cubic, "trilinear": _triangle}[mode]
    if kernel is None:
        idxs = [None if s == o else np.floor(
            (np.arange(o, dtype=np.float32) + np.float32(0.5)) * np.float32(s)
            / np.float32(o)).astype(np.int64) for s, o in zip(spatial, size)]
        return _take(x, idxs, first)
    v = x if x.is_floating_point() else x.float()
    mats = [None if s == o else _resize_matrix(s, o, kernel) for s, o in zip(spatial, size)]
    return _resample(v, mats, first).to(x.dtype)


upsample = interpolate


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None) -> torch.Tensor:
    """[N, C·r², H, W] to [N, C, H·r, W·r]; reads NCHW whatever
    ``data_format`` says, as the reference does."""
    r = upscale_factor
    n, c, h, w = x.shape
    v = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return v.reshape(n, c // (r * r), h * r, w * r)


def pixel_unshuffle(x, downscale_factor: int, data_format: str = "NCHW",
                    name=None) -> torch.Tensor:
    """The inverse of :func:`pixel_shuffle`, in either layout (the channel
    order (c, r, r) in both)."""
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return v.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    v = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return v.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups: int, data_format: str = "NCHW", name=None) -> torch.Tensor:
    """Channels regrouped: [g, c/g] read as [c/g, g]."""
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4).reshape(n, h, w, c)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None) -> torch.Tensor:
    """Sliding patches of [N, C, H, W] as [N, C·kh·kw, L] (the reference's
    ``conv_general_dilated_patches``, channel-major as torch's ``unfold``);
    ``paddings`` is one int or one int an axis."""
    pd = _tuple_n(paddings, 2)
    return torch.nn.functional.unfold(x, _tuple_n(kernel_sizes, 2), _tuple_n(dilations, 2),
                                      pd[:2], _tuple_n(strides, 2))


def zeropad2d(x, padding, data_format: str = "NCHW", name=None) -> torch.Tensor:
    """Zeros around H and W; ``padding`` an int or [left, right, top, bottom]."""
    if isinstance(padding, int):
        padding = [padding] * 4
    l, r, t, b = padding
    if data_format == "NCHW":
        return torch.nn.functional.pad(x, [l, r, t, b])
    return torch.nn.functional.pad(x, [0, 0, l, r, t, b])


def bilinear(x1, x2, weight, bias=None, name=None) -> torch.Tensor:
    """out[b, o] = x1[b] @ W[o] @ x2[b] (+ bias)."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


_PAD_MODES = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None) -> torch.Tensor:
    """Pad by (low, high) pairs: ``2·ndim`` numbers pair the axes in order;
    fewer pad the trailing axes last axis first (torch's order), as in the
    reference.  Modes "constant" (``value``), "reflect", "replicate",
    "circular" (numpy's reflect, edge and wrap); ``data_format`` is not
    read.  The non-constant modes gather each axis by numpy's padded index
    (any rank, any axis)."""
    if isinstance(pad, torch.Tensor):
        pad = pad.reshape(-1).tolist()
    nd = x.dim()
    if len(pad) == 2 * nd:
        width = [(int(pad[2 * i]), int(pad[2 * i + 1])) for i in range(nd)]
    else:
        npairs = len(pad) // 2
        pairs = [(int(pad[2 * i]), int(pad[2 * i + 1])) for i in range(npairs)]
        width = [(0, 0)] * (nd - npairs) + pairs[::-1]
    if mode == "constant":
        return torch.nn.functional.pad(x, [v for lo, hi in reversed(width) for v in (lo, hi)],
                                       value=value)
    np_mode = _PAD_MODES[mode]
    for axis, (lo, hi) in enumerate(width):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[axis]), (lo, hi), mode=np_mode)
            x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
    return x


# ---------------------------------------------------------------------------
# the remaining functionals (reference nn/functional/__init__.py), ROADMAP A3c
# ---------------------------------------------------------------------------
def label_smooth(label: torch.Tensor, prior_dist=None, epsilon: float = 0.1,
                 name=None) -> torch.Tensor:
    """``(1 - epsilon) * label + epsilon * prior`` (uniform prior by
    default)."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * torch.as_tensor(prior_dist, device=label.device)
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def square_error_cost(input: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return torch.square(input - label)


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-example loss, kept on a size-1 ``axis`` (and the softmax with
    ``return_softmax``)."""
    loss = cross_entropy(logits, label, soft_label=soft_label, ignore_index=ignore_index,
                         reduction="none", axis=axis)
    loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def sequence_mask(x: torch.Tensor, maxlen=None, dtype="int64", name=None) -> torch.Tensor:
    """``mask[..., j] = j < x[...]`` over ``maxlen`` columns (``x.max()`` by
    default)."""
    m = int(x.max()) if maxlen is None else int(maxlen)
    return (torch.arange(m, device=x.device) < x[..., None]).to(convert_dtype(dtype))


def log_loss(input: torch.Tensor, label: torch.Tensor, epsilon: float = 1e-4,
             name=None) -> torch.Tensor:
    """Elementwise negative log likelihood of the probabilities ``input``."""
    return -(label * torch.log(input + epsilon) + (1 - label) * torch.log1p(epsilon - input))


def dice_loss(input: torch.Tensor, label: torch.Tensor, epsilon: float = 1e-5,
              name=None) -> torch.Tensor:
    """1 − the Dice coefficient of the class probabilities ``input`` [N, ...,
    C] and the labels [N, ..., 1], averaged over N."""
    oh = torch.nn.functional.one_hot(label[..., 0].long(), input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = torch.sum(input * oh, dims)
    union = torch.sum(input, dims) + torch.sum(oh, dims)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


def npair_loss(anchor: torch.Tensor, positive: torch.Tensor, labels: torch.Tensor,
               l2_reg: float = 0.002, name=None) -> torch.Tensor:
    """The N-pair metric loss: softmax cross entropy of anchor·positiveᵀ
    against the same-label targets, plus the L2 term."""
    reg = l2_reg * (torch.mean(torch.sum(torch.square(anchor), 1)) +
                    torch.mean(torch.sum(torch.square(positive), 1))) * 0.25
    sim = anchor @ positive.T
    lab = labels.reshape(-1)
    targets = (lab[:, None] == lab[None, :]).to(sim.dtype)
    targets = targets / torch.sum(targets, 1, keepdim=True)
    return torch.mean(-torch.sum(targets * torch.log_softmax(sim, 1), 1)) + reg


def sigmoid_focal_loss(logit: torch.Tensor, label: torch.Tensor, normalizer=None,
                       alpha: float = 0.25, gamma: float = 2.0, reduction: str = "sum",
                       name=None) -> torch.Tensor:
    """The focal loss of the logits ``logit`` against 0/1 ``label``."""
    p = torch.sigmoid(logit)
    ce = -(label * torch.nn.functional.logsigmoid(logit)
           + (1 - label) * torch.nn.functional.logsigmoid(-logit))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


def temporal_shift(x: torch.Tensor, seg_num: int, shift_ratio: float = 0.25,
                   data_format: str = "NCHW", name=None) -> torch.Tensor:
    """The TSM shift: of each segment's channels, the first ``shift_ratio``
    come from the next frame, the next ``shift_ratio`` from the previous
    one (zeros past the ends)."""
    v = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    nt, c, h, w = v.shape
    v = v.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    back = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])], 1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]), v[:, :-1, fold:2 * fold]], 1)
    out = torch.cat([back, fwd, v[:, :, 2 * fold:]], 2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def affine_grid(theta: torch.Tensor, out_shape, align_corners: bool = True,
                name=None) -> torch.Tensor:
    """The sampling grid [N, H, W, 2] (x, y in [-1, 1]) of the 2x3 affine
    matrices ``theta`` [N, 2, 3] over ``out_shape`` [N, C, H, W]."""
    shape = out_shape.tolist() if isinstance(out_shape, torch.Tensor) else out_shape
    _, _, h, w = (int(s) for s in shape)
    dev = theta.device
    if align_corners:
        ys, xs = torch.linspace(-1, 1, h, device=dev), torch.linspace(-1, 1, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return torch.einsum("nij,hwj->nhwi", theta.float(), base)


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = True,
                name=None) -> torch.Tensor:
    """``x`` [N, C, H, W] sampled at ``grid`` [N, Hg, Wg, 2] (x, y in
    [-1, 1]): bilinear or nearest, zeros or border padding (reflection
    raises, as in the reference)."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError("mode must be bilinear or nearest")
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError("padding_mode reflection is not supported")
    return torch.nn.functional.grid_sample(x, grid.to(x.dtype), mode=mode,
                                           padding_mode=padding_mode,
                                           align_corners=align_corners)


def gumbel_softmax(x: torch.Tensor, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1, name=None) -> torch.Tensor:
    """``softmax((x + g) / temperature)`` with Gumbel noise g drawn from the
    device's generator (``framework.random``); ``hard`` gives the one-hot of
    the argmax with the soft sample's gradient."""
    from ..framework.random import generator_for

    u = torch.empty_like(x).exponential_(generator=generator_for(x.device))
    y = torch.softmax((x - u.log()) / temperature, dim=axis)
    if hard:
        index = y.argmax(axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, index, 1.0)
        y = y_hard + y - y.detach()
    return y


def _inplace(op_fn: Callable) -> Callable:
    def wrapper(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        # the op runs on a copy, so that writing ``x`` cannot invalidate a
        # value the op saved for its backward
        return x.copy_(op_fn(x.clone(), *args, **kwargs))

    wrapper.__name__ = op_fn.__name__ + "_"
    wrapper.__qualname__ = wrapper.__name__
    wrapper.__doc__ = f"In-place {op_fn.__name__}: writes the result into ``x`` and returns it."
    return wrapper


relu_ = _inplace(relu)
tanh_ = _inplace(tanh)
softmax_ = _inplace(softmax)
elu_ = _inplace(elu)
hardtanh_ = _inplace(hardtanh)
leaky_relu_ = _inplace(leaky_relu)
thresholded_relu_ = _inplace(thresholded_relu)

__all__ += ["one_hot", "label_smooth", "square_error_cost", "softmax_with_cross_entropy",
            "sequence_mask", "log_loss", "dice_loss", "npair_loss", "sigmoid_focal_loss",
            "temporal_shift", "affine_grid", "grid_sample", "gumbel_softmax", "relu_",
            "tanh_", "softmax_", "elu_", "hardtanh_", "leaky_relu_", "thresholded_relu_"]
