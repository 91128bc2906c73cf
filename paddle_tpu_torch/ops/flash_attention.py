"""Flash-attention forward: the hand kernel B3 (``csrc/flash_attention.cu``)
and its plain PyTorch twin, for causal prefill and the left-padded
(varlen) prefill.

Replaces the reference's ``ops/pallas/flash_attention.py`` forward
(``flash_attention`` and ``flash_attention_varlen`` → ``_fwd`` →
``_fwd_kernel``).  The backward kernels (B3b, B3c) are not ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import LAUNCHES, _build

__all__ = ["flash_attention_plain", "flash_attention_fwd"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + \
    (ctypes.c_float, ctypes.c_int, ctypes.c_int)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          pad_lens: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b, sq, hq, d]; k/v [b, sk, hkv, d]; scores scaled by 1/sqrt(d);
    ``pad_lens`` [b] masks keys below it.  Causal is bottom-right aligned.  A row with no valid key
    gives zeros and lse -inf.  Returns (out [b, sq, hq, d] in q's dtype,
    lse [b, hq, sq] f32); all arithmetic in f32."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(hq // hkv, dim=2)
    vf = v.float().repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    col = torch.arange(sk, device=q.device)
    keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        keep = col[None, :] <= torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    keep = keep[None, None]
    if pad_lens is not None:
        keep = keep & (col >= pad_lens.to(q.device).long()[:, None, None, None])
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m_ok = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m_ok)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.transpose(1, 2)
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        pad_lens: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, the plain version on CPU tensors;
    returns (out, lse) as :func:`flash_attention_plain` does."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal, pad_lens)
    b, sq, hq, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or \
            k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"flash kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         f"[b, s, h, d] with kv heads dividing q heads")
    if d % 8 or d > 256:
        raise ValueError(f"flash kernel takes head_dim % 8 == 0 and <= 256, "
                         f"got {d}")
    tensors = (q, k, v) if pad_lens is None else (q, k, v, pad_lens)
    if any(t.device != q.device for t in tensors) or \
            not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash kernel takes contiguous tensors on one device")
    if pad_lens is not None and (pad_lens.dtype != torch.int32 or
                                 pad_lens.shape != (b,)):
        raise ValueError(f"flash kernel: pad_lens must be int32 [{b}]")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernel: bf16 q, k, v must start on 16-byte "
                         "boundaries (it loads 16 bytes a thread)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash backward kernels (B3b, B3c) are not ported yet; run "
            "the forward under torch.no_grad()")
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _build.launch("flash_attention", "ptt_flash_attention_fwd", _ARGTYPES,
                  q.device, _build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(pad_lens), _build.ptr(out), _build.ptr(lse),
                  b, sq, sk, hq, hkv, d, 1.0 / math.sqrt(d), int(causal),
                  _DTYPES[q.dtype])
    LAUNCHES["flash_attention"] += 1
    return out, lse
