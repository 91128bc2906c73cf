"""Flash attention: the hand kernels B3 (forward, ``csrc/flash_attention.cu``)
and B3b/B3c (backward, ``csrc/flash_attention_bwd.cu``), their plain
PyTorch twins, and the autograd Function that pairs them.

Replaces the reference's ``ops/pallas/flash_attention.py``: the forward
(``flash_attention`` and ``flash_attention_varlen`` → ``_fwd`` →
``_fwd_kernel``) and the backward (``_flash_bwd`` → ``_bwd`` →
``_bwd_dq_kernel``, ``_bwd_dkv_kernel``).  As in the reference, the
left-padded (varlen) form is forward only; the trainable path is the
unpadded one, :class:`FlashAttentionFunction`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build, count_launch

__all__ = ["flash_attention_plain", "flash_attention_fwd",
           "flash_attention_bwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "FlashAttentionFunction"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + \
    (ctypes.c_float, ctypes.c_int, ctypes.c_int)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6 + \
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
    _check(q, k, v, pad_lens)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash kernel wrappers do not record gradients; call "
            "nn.functional.scaled_dot_product_attention "
            "(FlashAttentionFunction) for the autograd pair")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _build.launch("flash_attention", "ptt_flash_attention_fwd", _ARGTYPES,
                  q.device, _build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(pad_lens), _build.ptr(out), _build.ptr(lse),
                  b, sq, sk, hq, hkv, d, 1.0 / math.sqrt(d), int(causal),
                  _DTYPES[q.dtype])
    count_launch("flash_attention")
    return out, lse


def _check(q, k, v, pad_lens=None) -> None:
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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernel: q, k, v must start on 16-byte "
                         "boundaries (it loads 16 bytes a thread)")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor,
                              dout: torch.Tensor, causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The FA2 backward written out as the TPU kernels compute it (not
    autograd of the forward): p = exp(s·scale − lse) from the forward's
    f32 logsumexp [b, hq, sq], delta = rowsum(dO·O), dp = dO Vᵀ,
    ds = p·(dp − delta)·scale; dQ = ds K, dK = dsᵀ Q and dV = pᵀ dO, with
    dK and dV summed over each kv head's group of q heads.  f32
    arithmetic; p and ds are rounded to the input dtype before their
    products, as the kernels do in bf16.  A row with lse −inf has p = 0."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    keep = (lse != float("-inf"))[..., None].expand(b, hq, sq, sk)
    if causal:
        col = torch.arange(sk, device=q.device)
        keep = keep & (col[None, :] <= torch.arange(sq, device=q.device)[:, None]
                       + (sk - sq))
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    delta = (dof * out.float()).sum(-1).transpose(1, 2)          # [b, hq, sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(b, sk, hkv, rep, d).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(b, sk, hkv, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, lse, **like_q) -> None:
    _check(q, k, v)
    b, sq, hq, _ = q.shape
    for name, t in like_q.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash bwd kernel: {name} must be a contiguous "
                             f"{q.dtype} tensor of q's shape {tuple(q.shape)} "
                             f"starting on a 16-byte boundary (the kernels "
                             f"read it 16 bytes a thread, dout by cp.async)")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash bwd kernel: lse must be contiguous f32 "
                         f"[{b}, {hq}, {sq}]")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, *like_q.values())):
        raise RuntimeError("the flash bwd kernel wrappers do not record "
                           "gradients (no double backward)")


def _bwd_dims(q, k, causal):
    b, sq, hq, d = q.shape
    return (b, sq, k.shape[1], hq, k.shape[2], d, 1.0 / math.sqrt(d), int(causal),
            _DTYPES[q.dtype])


def flash_attention_bwd_dq(q, k, v, out, lse, dout, causal: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3b on CUDA tensors: (dq, delta [b, hq, sq] f32 = rowsum(dO·O))."""
    _check_bwd(q, k, v, lse, out=out, dout=dout)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _build.launch("flash_attention_bwd", "ptt_flash_attention_bwd_dq", _BWD_ARGTYPES,
                  q.device, _build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(out), _build.ptr(dout), _build.ptr(lse),
                  _build.ptr(dq), _build.ptr(delta), *_bwd_dims(q, k, causal))
    count_launch("flash_attention_bwd_dq")
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3c on CUDA tensors: (dk, dv), summed over each kv head's group of
    q heads, from B3b's ``delta``."""
    if delta.shape != lse.shape or delta.dtype != torch.float32 or \
            delta.device != q.device or not delta.is_contiguous():
        raise ValueError("flash bwd kernel: delta must be contiguous f32 of "
                         "lse's shape")
    _check_bwd(q, k, v, lse, dout=dout)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch("flash_attention_bwd", "ptt_flash_attention_bwd_dkv", _BWD_ARGTYPES,
                  q.device, _build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(dout), _build.ptr(lse), _build.ptr(delta),
                  _build.ptr(dk), _build.ptr(dv), *_bwd_dims(q, k, causal))
    count_launch("flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the kernels B3b then B3c on CUDA tensors, by the
    plain version on CPU tensors."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, dout, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Unpadded attention with its backward: B3 then B3b/B3c on CUDA
    tensors, the plain pair on CPU tensors.  Saves q, k, v, out and the f32
    lse [b, hq, sq]."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None
