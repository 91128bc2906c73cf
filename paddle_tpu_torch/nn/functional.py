"""The functional operators (port of the reference's
``nn/functional/__init__.py``): ``linear``, ``embedding``, ``rms_norm``,
``layer_norm``, ``dropout``, ``scaled_dot_product_attention``,
``gather_tree``, the activations, the losses with
``fused_linear_cross_entropy``, and the distances.

``rms_norm``, ``swiglu`` and ``scaled_dot_product_attention`` reach the hand kernels
through the dispatch seam: without grad, :func:`~paddle_tpu_torch.ops.use_kernel`
picks the forward kernel; with grad, :func:`~paddle_tpu_torch.ops.use_function`
picks the op's autograd Function (forward and backward kernels on the
card, the plain pair on the CPU).  A flag turned off gives the plain
PyTorch ops, differentiated by autograd.  The activations and losses are
plain PyTorch in the reference's formulas, as the reference leaves them
to XLA; each computes in its input's dtype where the reference does, and
in f32 where the reference casts.  The convolution, pooling,
interpolation and vision functionals come with their layers (ROADMAP
A3b).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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
           "triplet_margin_with_distance_loss", "pairwise_distance"]


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
            f"generator (Philox) the port does not have yet (ROADMAP A9); use "
            f"p = 0 or eval mode")


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
selu = _unary("selu", lambda v: 1.0507009873554805 * torch.where(
    v > 0, v, 1.6732632423543772 * torch.expm1(v)))
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
    training; in training the slope is drawn at random, which needs the
    counter-based generator of ROADMAP A9, and raises."""
    if not 0 <= lower <= upper <= 1:
        raise ValueError(f"rrelu requires 0 <= lower <= upper <= 1, got [{lower}, {upper}]")
    if training:
        raise NotImplementedError(
            "rrelu in training draws a random slope a element: that needs a "
            "counter-based generator (Philox) the port does not have yet "
            "(ROADMAP A9); use training=False")
    return torch.where(x >= 0, x, (lower + upper) / 2 * x)


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
