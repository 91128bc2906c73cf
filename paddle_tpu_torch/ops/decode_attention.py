"""Decode attention: the hand kernel B6 (``csrc/decode_attention.cu``) and
its plain PyTorch twin.  Both append the step's key and value to the cache
IN PLACE, in the caller's cache tensors.

Replaces the reference's ``ops/pallas/decode_attention.py``
``decode_attention`` → ``_decode_kernel``, whose aliased output block is
the TPU's form of the same in-place append.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import LAUNCHES, _build

__all__ = ["decode_attention_plain", "decode_attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + \
    (ctypes.c_float, ctypes.c_int)


def decode_attention_plain(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, pos: int,
                           pad_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write ``k_new``/``v_new`` [b, 1, kv, d] into row ``pos`` of the
    caches [b, C, kv, d] in place, then attend q [b, 1, h, d] (head
    ``ikv * g + ig``) over cache columns [pad_lens[b], pos] in f32; column
    ``pos``, the new token, is always attended."""
    b, _, h, d = q.shape
    kv = cache_k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    cache_k[:, pos] = k_new[:, 0]
    cache_v[:, pos] = v_new[:, 0]
    keys = cache_k[:, :pos + 1].float()
    vals = cache_v[:, :pos + 1].float()
    s = torch.einsum("bkgd,bckd->bkgc", q.float().reshape(b, kv, g, d),
                     keys) * scale
    if pad_lens is not None:  # the new token at pos stays valid, even if pad >= pos
        col = torch.arange(pos + 1, device=q.device)
        pad = pad_lens.to(q.device).long()[:, None, None, None]
        s = s.masked_fill((col < pad) & (col < pos), float("-inf"))
    out = torch.einsum("bkgc,bckd->bkgd", torch.softmax(s, dim=-1), vals)
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     pad_lens: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, the plain version on CPU tensors.
    Returns (out [b, 1, h, d], cache_k, cache_v); the caches returned are
    the caller's tensors, updated in place at row ``pos``."""
    pos = int(pos)
    b, s, h, d = q.shape
    C, kv = cache_k.shape[1], cache_k.shape[2]
    if s != 1 or k_new.shape != (b, 1, kv, d) or v_new.shape != k_new.shape \
            or cache_v.shape != cache_k.shape or cache_k.shape[0] != b \
            or cache_k.shape[3] != d or h % kv:
        raise ValueError(
            f"decode attention: q {tuple(q.shape)} must be [b, 1, h, d], "
            f"k_new/v_new [b, 1, kv, d] and caches [b, C, kv, d], kv | h; got "
            f"k_new {tuple(k_new.shape)}, cache {tuple(cache_k.shape)}")
    if not 0 <= pos < C:
        raise ValueError(f"decode attention: pos {pos} outside the cache [0, {C})")
    if not q.is_cuda:
        return (decode_attention_plain(q, k_new, v_new, cache_k, cache_v, pos,
                                       pad_lens), cache_k, cache_v)
    tensors = (q, k_new, v_new, cache_k, cache_v)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("decode kernel takes f32 or bf16 q, k_new, v_new and "
                        "caches of one dtype")
    if d % 8 or d > 256:
        raise ValueError(f"decode kernel takes head_dim % 8 == 0 and <= 256, "
                         f"got {d}")
    if pad_lens is not None:
        tensors += (pad_lens,)
        if pad_lens.dtype != torch.int32 or pad_lens.shape != (b,):
            raise ValueError(f"decode kernel: pad_lens must be int32 [{b}]")
    if any(t.device != q.device for t in tensors) or \
            not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode kernel takes contiguous tensors on one device")
    if any(t.data_ptr() % 16 for t in tensors[:5]):
        raise ValueError("decode kernel: q, k_new, v_new and the caches must "
                         "start on 16-byte boundaries (vector loads)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("decode attention has no backward; run it "
                                  "under torch.no_grad()")
    out = torch.empty_like(q)
    _build.launch("decode_attention", "ptt_decode_attention", _ARGTYPES,
                  q.device, _build.ptr(q), _build.ptr(k_new), _build.ptr(v_new),
                  _build.ptr(cache_k), _build.ptr(cache_v), _build.ptr(pad_lens),
                  _build.ptr(out), b, C, h, kv, d, pos, 1.0 / math.sqrt(d),
                  _DTYPES[q.dtype])
    LAUNCHES["decode_attention"] += 1
    return out, cache_k, cache_v
