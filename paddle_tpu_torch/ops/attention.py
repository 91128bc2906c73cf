"""Plain scaled dot-product attention in the paddle flash-attn layout
[batch, seq, heads, head_dim]: the composite path of
``nn.functional.scaled_dot_product_attention`` (port of the reference's
``ops/attention.py`` ``sdpa_reference``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..framework import random as _random

__all__ = ["sdpa_reference"]


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   is_causal: bool = False, dropout_p: float = 0.0,
                   scale: Optional[float] = None, dropout_key=None) -> torch.Tensor:
    """q [b, sq, hq, d]; k/v [b, sk, hkv, d]; additive ``mask``
    broadcastable to [b, hq, sq, sk]; causal masking bottom-right aligned.
    Scores (scaled by ``scale``, default 1/sqrt(d)) and softmax in f32;
    returns [b, sq, hq, d] in v's dtype.  With ``dropout_p > 0`` and a
    ``dropout_key`` (a generator or a ``framework.random`` key) the f32
    probabilities are dropped by a mask drawn through the seam
    (``framework.random._keep_mask``) and the kept ones divided by
    1 − ``dropout_p`` (times its reciprocal) before the cast; without a
    key nothing is dropped, as in the reference."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if hkv != hq:
        if hq % hkv:
            raise ValueError(f"GQA requires kv heads ({hkv}) to divide q "
                             f"heads ({hq})")
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask.float()
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and dropout_key is not None:
        keep = _random._keep_mask(probs.shape, 1.0 - dropout_p, probs.device,
                                  generator=dropout_key)
        # times the reciprocal: XLA folds the reference's division by a constant
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_p)), 0.0)
    probs = probs.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
