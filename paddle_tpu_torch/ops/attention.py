"""Plain scaled dot-product attention in the paddle flash-attn layout
[batch, seq, heads, head_dim]: the composite path of
``nn.functional.scaled_dot_product_attention`` (port of the reference's
``ops/attention.py`` ``sdpa_reference``)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sdpa_reference"]


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   is_causal: bool = False, dropout_p: float = 0.0,
                   scale: Optional[float] = None, dropout_key=None) -> torch.Tensor:
    """q [b, sq, hq, d]; k/v [b, sk, hkv, d]; additive ``mask``
    broadcastable to [b, hq, sq, sk]; causal masking bottom-right aligned.
    Scores (scaled by ``scale``, default 1/sqrt(d)) and softmax in f32;
    returns [b, sq, hq, d] in v's dtype.  Dropout on the probabilities
    needs the counter-based generator of ROADMAP A9: ``dropout_p > 0`` with
    a ``dropout_key`` raises (the reference drops nothing without a key)."""
    if dropout_p > 0.0 and dropout_key is not None:
        raise NotImplementedError(
            "sdpa_reference: attention dropout needs a counter-based generator "
            "(Philox) the port does not have yet (ROADMAP A9)")
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
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
