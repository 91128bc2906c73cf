"""Decode attention over a bf16/f32 cache (B6), an int8 cache with
per-token scales (B8) and an e4m3 cache under one static scale (B9): the
hand kernels in ``csrc/decode_attention.cu`` and their plain PyTorch twins.
All of them append the step's key and value to the cache IN PLACE, in the
caller's tensors (B8 and B9 quantized, with B8's scale).

Replaces the reference's ``ops/pallas/decode_attention.py``:
``decode_attention`` → ``_decode_kernel`` (B6), ``decode_attention_int8``
→ ``_decode_kernel_int8`` (B8) and ``decode_attention_fp8`` →
``_decode_kernel_fp8`` (B9), whose aliased output blocks are the TPU's
form of the same in-place append.  The reference's ``*_supported`` gates
are TPU tiling rules and have no counterpart: the kernels take any cache
length and raise on what they cannot take.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import LAUNCHES, _build

__all__ = ["decode_attention_plain", "decode_attention",
           "decode_attention_int8_plain", "decode_attention_int8",
           "decode_attention_fp8_plain", "decode_attention_fp8"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + \
    (ctypes.c_float, ctypes.c_int)
_INT8_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6 + \
    (ctypes.c_float, ctypes.c_int)
_FP8_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + \
    (ctypes.c_float, ctypes.c_float, ctypes.c_int)


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


def _check_shapes(q, k_new, v_new, cache_k, cache_v, pos) -> int:
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
    return pos


def _check_launch(name: str, tensors, pad_lens, d: int, d_multiple: int):
    """Raise unless the kernel can take these CUDA inputs: ``tensors``
    starts with q, k_new, v_new, cache_k, cache_v."""
    q = tensors[0]
    if d % d_multiple or d > 256:
        raise ValueError(f"{name} kernel takes head_dim % {d_multiple} == 0 "
                         f"and <= 256, got {d}")
    if pad_lens is not None:
        if pad_lens.dtype != torch.int32 or pad_lens.shape != (q.shape[0],):
            raise ValueError(f"{name} kernel: pad_lens must be int32 [{q.shape[0]}]")
        tensors = (*tensors, pad_lens)
    if any(t.device != q.device for t in tensors) or \
            not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous tensors on one device")
    if any(t.data_ptr() % 16 for t in tensors[:5]):
        raise ValueError(f"{name} kernel: q, k_new, v_new and the caches must "
                         f"start on 16-byte boundaries (vector loads)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} has no backward; run it under "
                                  f"torch.no_grad()")


def decode_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     pad_lens: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, the plain version on CPU tensors.
    Returns (out [b, 1, h, d], cache_k, cache_v); the caches returned are
    the caller's tensors, updated in place at row ``pos``."""
    pos = _check_shapes(q, k_new, v_new, cache_k, cache_v, pos)
    b, _, h, d = q.shape
    C, kv = cache_k.shape[1], cache_k.shape[2]
    if not q.is_cuda:
        return (decode_attention_plain(q, k_new, v_new, cache_k, cache_v, pos,
                                       pad_lens), cache_k, cache_v)
    tensors = (q, k_new, v_new, cache_k, cache_v)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("decode kernel takes f32 or bf16 q, k_new, v_new and "
                        "caches of one dtype")
    _check_launch("decode attention", tensors, pad_lens, d, 8)
    out = torch.empty_like(q)
    _build.launch("decode_attention", "ptt_decode_attention", _ARGTYPES,
                  q.device, _build.ptr(q), _build.ptr(k_new), _build.ptr(v_new),
                  _build.ptr(cache_k), _build.ptr(cache_v), _build.ptr(pad_lens),
                  _build.ptr(out), b, C, h, kv, d, pos, 1.0 / math.sqrt(d),
                  _DTYPES[q.dtype])
    LAUNCHES["decode_attention"] += 1
    return out, cache_k, cache_v


def _attend_quantized(q, k_new, v_new, keys, vals, k_fac, v_fac, pos, pad_lens,
                      scale: float):
    """The B8/B9 attention in f32, as the TPU kernels compute it: q over
    the dequantized cache columns [pad_lens[b], pos) and the new token,
    which folds in exact (unquantized).  ``keys``/``vals`` [b, pos, kv, d]
    f32 cache rows before their scales; a cached column's score is
    ``(q . k) * k_fac * scale`` and its value weight ``p * v_fac``, while
    the softmax denominator sums the unscaled p; ``k_fac``/``v_fac``
    broadcast to [b, kv, 1, pos]."""
    b, _, h, d = q.shape
    kv = keys.shape[2]
    qf = q.float().reshape(b, kv, h // kv, d)
    s = torch.einsum("bkgd,bckd->bkgc", qf, keys) * k_fac * scale
    if pad_lens is not None:
        col = torch.arange(pos, device=q.device)
        s = s.masked_fill(col < pad_lens.to(q.device).long()[:, None, None, None],
                          float("-inf"))
    kn, vn = k_new.float()[:, 0], v_new.float()[:, 0]            # [b, kv, d]
    s_new = torch.einsum("bkgd,bkd->bkg", qf, kn)[..., None] * scale
    s = torch.cat([s, s_new], dim=-1)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bkgc,bckd->bkgd", p[..., :pos] * v_fac, vals) \
        + p[..., pos:] * vn[:, :, None, :]
    out = acc / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_int8_plain(q, k_new, v_new, cache_k, cache_v, k_scale,
                                v_scale, pos: int, pad_lens=None, *,
                                scale: Optional[float] = None):
    """B8's function in PyTorch: attend q [b, 1, h, d] over the int8 caches
    [b, C, kv, d] dequantized by the f32 scale planes k_scale/v_scale
    [b, kv, C] (the reference's lane-major layout), cache columns
    [pad_lens[b], pos) and the exact new token; then write row ``pos`` of
    the caches and column ``pos`` of the scales with the quantized
    k_new/v_new, in place.  Returns (out, cache_k, cache_v, k_scale,
    v_scale)."""
    from ..serving.kv_quant import quantize_kv  # serving imports this module

    sc = 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)
    out = _attend_quantized(
        q, k_new, v_new, cache_k[:, :pos].float(), cache_v[:, :pos].float(),
        k_scale[:, :, None, :pos], v_scale[:, :, None, :pos], pos, pad_lens, sc)
    kq, ks = quantize_kv(k_new[:, 0])
    vq, vs = quantize_kv(v_new[:, 0])
    cache_k[:, pos], cache_v[:, pos] = kq, vq
    k_scale[:, :, pos], v_scale[:, :, pos] = ks, vs
    return out, cache_k, cache_v, k_scale, v_scale


def decode_attention_fp8_plain(q, k_new, v_new, cache_k, cache_v, pos: int,
                               pad_lens=None, *, kv_scale: float = 1.0,
                               scale: Optional[float] = None):
    """B9's function in PyTorch: as :func:`decode_attention_int8_plain`
    over float8_e4m3fn caches under one static ``kv_scale`` (scores take
    ``scale * kv_scale``, values ``kv_scale``); row ``pos`` is written with
    ``clip(x / kv_scale, ±448)`` cast to e4m3, in place.  Returns (out,
    cache_k, cache_v)."""
    from ..serving.kv_quant import quantize_kv_fp8  # serving imports this module

    sc = 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)
    kvs = float(kv_scale)
    out = _attend_quantized(
        q, k_new, v_new, cache_k[:, :pos].float(), cache_v[:, :pos].float(),
        kvs, kvs, pos, pad_lens, sc)
    cache_k[:, pos] = quantize_kv_fp8(k_new[:, 0], kvs)
    cache_v[:, pos] = quantize_kv_fp8(v_new[:, 0], kvs)
    return out, cache_k, cache_v


def decode_attention_int8(q, k_new, v_new, cache_k, cache_v, k_scale, v_scale,
                          pos: int, pad_lens=None, *, scale: Optional[float] = None):
    """B8: the kernel on CUDA tensors, the plain twin on CPU tensors, with
    the reference's signature and return tuple.  q, k_new, v_new f32 or
    bf16; caches int8 [b, C, kv, d]; scales f32 [b, kv, C]; every cache
    length and ``pos`` in [0, C); head_dim % 16 == 0 and <= 256."""
    pos = _check_shapes(q, k_new, v_new, cache_k, cache_v, pos)
    b, _, h, d = q.shape
    C, kv = cache_k.shape[1], cache_k.shape[2]
    if k_scale.shape != (b, kv, C) or v_scale.shape != (b, kv, C):
        raise ValueError(f"decode_attention_int8: scales must be [{b}, {kv}, {C}], "
                         f"got {tuple(k_scale.shape)} and {tuple(v_scale.shape)}")
    if not q.is_cuda:
        return decode_attention_int8_plain(q, k_new, v_new, cache_k, cache_v,
                                           k_scale, v_scale, pos, pad_lens,
                                           scale=scale)
    if q.dtype not in _DTYPES or k_new.dtype != q.dtype or v_new.dtype != q.dtype \
            or cache_k.dtype != torch.int8 or cache_v.dtype != torch.int8 \
            or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("decode_attention_int8 kernel takes f32 or bf16 q, k_new "
                        "and v_new of one dtype, int8 caches and f32 scales")
    _check_launch("decode_attention_int8",
                  (q, k_new, v_new, cache_k, cache_v, k_scale, v_scale), pad_lens, d, 16)
    sc = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.empty_like(q)
    _build.launch("decode_attention", "ptt_decode_attention_int8", _INT8_ARGTYPES,
                  q.device, _build.ptr(q), _build.ptr(k_new), _build.ptr(v_new),
                  _build.ptr(cache_k), _build.ptr(cache_v), _build.ptr(k_scale),
                  _build.ptr(v_scale), _build.ptr(pad_lens), _build.ptr(out),
                  b, C, h, kv, d, pos, sc, _DTYPES[q.dtype])
    LAUNCHES["decode_attention_int8"] += 1
    return out, cache_k, cache_v, k_scale, v_scale


def decode_attention_fp8(q, k_new, v_new, cache_k, cache_v, pos: int,
                         pad_lens=None, *, kv_scale: float = 1.0,
                         scale: Optional[float] = None):
    """B9: the kernel on CUDA tensors, the plain twin on CPU tensors, with
    the reference's signature and return tuple.  Caches float8_e4m3fn
    [b, C, kv, d] under the static ``kv_scale`` (> 0); otherwise as
    :func:`decode_attention_int8`."""
    pos = _check_shapes(q, k_new, v_new, cache_k, cache_v, pos)
    b, _, h, d = q.shape
    C, kv = cache_k.shape[1], cache_k.shape[2]
    if not float(kv_scale) > 0.0:
        raise ValueError(f"decode_attention_fp8: kv_scale must be > 0, got {kv_scale}")
    if not q.is_cuda:
        return decode_attention_fp8_plain(q, k_new, v_new, cache_k, cache_v, pos,
                                          pad_lens, kv_scale=kv_scale, scale=scale)
    if q.dtype not in _DTYPES or k_new.dtype != q.dtype or v_new.dtype != q.dtype \
            or cache_k.dtype != torch.float8_e4m3fn \
            or cache_v.dtype != torch.float8_e4m3fn:
        raise TypeError("decode_attention_fp8 kernel takes f32 or bf16 q, k_new "
                        "and v_new of one dtype and float8_e4m3fn caches")
    _check_launch("decode_attention_fp8", (q, k_new, v_new, cache_k, cache_v),
                  pad_lens, d, 16)
    sc = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.empty_like(q)
    _build.launch("decode_attention", "ptt_decode_attention_fp8", _FP8_ARGTYPES,
                  q.device, _build.ptr(q), _build.ptr(k_new), _build.ptr(v_new),
                  _build.ptr(cache_k), _build.ptr(cache_v), _build.ptr(pad_lens),
                  _build.ptr(out), b, C, h, kv, d, pos, sc, float(kv_scale),
                  _DTYPES[q.dtype])
    LAUNCHES["decode_attention_fp8"] += 1
    return out, cache_k, cache_v
