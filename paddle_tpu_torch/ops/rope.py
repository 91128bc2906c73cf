"""Rotary position embedding: the hand kernel B2 (``csrc/rope.cu``), which
also serves as its backward, its plain PyTorch twin, and the autograd
Function that pairs them.

Replaces the reference's ``ops/pallas/rope.py`` (``fused_rope`` →
``_rope_raw`` → ``_rope_kernel``; the backward ``_rope_bwd`` is the same
kernel with the sine negated, since R(θ)ᵀ = R(−θ)).  Unlike the TPU kernel,
which takes tables already sliced to the sequence, both versions take each
token's position ``pos_ids [b, s]`` and the full ``[max_pos, d]`` tables,
so one function serves prefill, decode steps, left-padded rows and the
backward.  The kernel takes the sine's sign as an argument, so the
backward reads the same table.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, count_launch, export_route, exported_op, use_function, use_kernel

__all__ = ["rope_plain", "fused_rope", "fused_rope_bwd", "RopeFunction", "rotate"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_longlong,) + (ctypes.c_int,) * 4 + \
    (ctypes.c_float, ctypes.c_int)


def _rotate_half(v: torch.Tensor) -> torch.Tensor:
    half = v.shape[-1] // 2
    return torch.cat([-v[..., half:], v[..., :half]], dim=-1)


def rope_plain(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, pos_ids: torch.Tensor, sin_sign: float = 1.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b, s, hq, d], k [b, s, hk, d], cos/sin [max_pos, d], pos_ids
    [b, s] (clipped into the table) → rotated (q, k), in f32, cast back.
    ``sin_sign`` −1 rotates by −θ: the backward."""
    p = pos_ids.long().clamp(0, cos.shape[0] - 1)
    c = cos.float()[p][:, :, None, :]
    s = sin.float()[p][:, :, None, :]
    if sin_sign != 1.0:
        s = sin_sign * s
    qf, kf = q.float(), k.float()
    return ((qf * c + _rotate_half(qf) * s).to(q.dtype),
            (kf * c + _rotate_half(kf) * s).to(k.dtype))


def _launch(q, k, cos, sin, pos_ids, sin_sign: float):
    b, s, hq, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise TypeError(f"rope kernel takes f32 or bf16 q and k of one dtype, "
                        f"got {q.dtype} and {k.dtype}")
    if k.dim() != 4 or k.shape[:2] != (b, s) or k.shape[3] != d or d % 2:
        raise ValueError(f"rope kernel: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be [b, s, h, d], d even")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32 or \
            cos.shape != sin.shape or cos.dim() != 2 or cos.shape[1] != d:
        raise ValueError(f"rope kernel: cos/sin must be f32 [max_pos, {d}]")
    if pos_ids.dtype != torch.int32 or pos_ids.shape != (b, s):
        raise ValueError(f"rope kernel: pos_ids must be int32 [{b}, {s}]")
    tensors = (q, k, cos, sin, pos_ids)
    if any(t.device != q.device for t in tensors) or \
            not all(t.is_contiguous() for t in tensors):
        raise ValueError("rope kernel takes contiguous tensors on one device")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        raise RuntimeError(
            "the rope kernel wrappers do not record gradients; call "
            "models.llama.apply_rotary_pos_emb (RopeFunction) for the "
            "autograd pair")
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    _build.launch("rope", "ptt_rope_fwd", _ARGTYPES, q.device,
                  _build.ptr(q), _build.ptr(k), _build.ptr(pos_ids),
                  _build.ptr(cos), _build.ptr(sin), _build.ptr(q_out),
                  _build.ptr(k_out), b * s, hq, k.shape[2], d, cos.shape[0],
                  float(sin_sign), _DTYPES[q.dtype])
    return q_out, k_out


def fused_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, pos_ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: the kernel on CUDA tensors, the plain version on CPU tensors."""
    if not q.is_cuda:
        return rope_plain(q, k, cos, sin, pos_ids)
    out = _launch(q, k, cos, sin, pos_ids, 1.0)
    count_launch("rope")
    return out


def fused_rope_bwd(dq: torch.Tensor, dk: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, pos_ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2's backward: the gradients rotated by −θ, by the same kernel with
    the sine's sign −1 on CUDA tensors, by the plain version on CPU ones."""
    if not dq.is_cuda:
        return rope_plain(dq, dk, cos, sin, pos_ids, sin_sign=-1.0)
    out = _launch(dq, dk, cos, sin, pos_ids, -1.0)
    count_launch("rope_bwd")
    return out


class RopeFunction(torch.autograd.Function):
    """RoPE of (q, k) with its backward; saves nothing but the tables and
    positions (the rotation is orthogonal)."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, pos_ids):
        ctx.save_for_backward(cos, sin, pos_ids)
        return fused_rope(q, k, cos, sin, pos_ids)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin, pos_ids = ctx.saved_tensors
        dq_in, dk_in = fused_rope_bwd(dq.contiguous(), dk.contiguous(), cos, sin,
                                      pos_ids)
        return dq_in, dk_in, None, None, None


def rotate(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           pos_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rope seam: :class:`RopeFunction` when a gradient is wanted and
    ``use_fused_rope`` is on, B2 on the card with the flag on, the plain
    version otherwise; while a program is exported, the flag-on call is
    traced as the ``paddle_tpu_torch::rope`` operator."""
    if export_route("use_fused_rope"):
        return exported_op("rope")(q, k, cos, sin, pos_ids)
    if use_function("use_fused_rope", q, k):
        return RopeFunction.apply(q, k, cos, sin, pos_ids)
    if use_kernel("use_fused_rope", q):
        return fused_rope(q, k, cos, sin, pos_ids)
    return rope_plain(q, k, cos, sin, pos_ids)
