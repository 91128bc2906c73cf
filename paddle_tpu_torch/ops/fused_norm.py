"""RMSNorm: the hand kernels B1 (forward) and B1b (backward) in
``csrc/rms_norm.cu``, their plain PyTorch twins, and the autograd Function
that pairs them.

Replaces the reference's ``ops/pallas/fused_norm.py`` (``fused_rms_norm``:
``_rms_fwd`` → ``_fwd_kernel``, ``_rms_bwd`` → ``_bwd_kernel``).  The
kernel wrappers take no part in autograd: under grad they refuse inputs
that need a gradient, and :class:`RMSNormFunction` (what
``nn.functional.rms_norm`` calls when grad is on) wraps them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, count_launch

__all__ = ["rms_norm_plain", "rms_norm_bwd_plain", "fused_rms_norm",
           "fused_rms_norm_bwd", "RMSNormFunction"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_longlong,) + (ctypes.c_int,) * 3
# B1b's persistent grid: blocks an SM, one f32 dw partial row each; two are
# what fit an SM at its registers (3 and 4 timed slower on the H100)
_BWD_BLOCKS_PER_SM = 2


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., H], weight [H] → (out [..., H] in x's dtype, rstd [..., 1]
    f32); the normalisation and the weight product in f32."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * rstd * weight.float()).to(x.dtype), rstd


def rms_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor,
                       dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward step by step, as the TPU kernel computes it, in f32:
    x^ = x·rstd, dx = rstd·(dy·w − x^·mean(dy·w·x^)) in x's dtype, and
    dw = Σ_rows dy·x^ in w's dtype.  rstd [..., 1] as the forward returns
    it."""
    h = x.shape[-1]
    xhat = x.float() * rstd.float()
    dyf = dy.float()
    dyw = dyf * weight.float()
    m = (dyw * xhat).sum(-1, keepdim=True) / h
    dx = rstd * (dyw - xhat * m)
    dw = (dyf * xhat).reshape(-1, h).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    h = x.shape[-1]
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"rms_norm kernel takes f32 or bf16 x and a weight of "
                        f"the same dtype, got {x.dtype} and {weight.dtype}")
    if weight.shape != (h,) or weight.device != x.device:
        raise ValueError(f"rms_norm kernel: weight must be [{h}] on {x.device}, "
                         f"got {tuple(weight.shape)} on {weight.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel takes contiguous x and weight")


def _refuse_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the rms_norm kernel wrappers do not record gradients; call "
            "nn.functional.rms_norm (RMSNormFunction) for the autograd pair")


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not x.is_cuda:
        return rms_norm_plain(x, weight, eps)
    _check(x, weight)
    _refuse_grad(x, weight)
    h = x.shape[-1]
    out = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    _build.launch("rms_norm", "ptt_rms_norm_fwd", _ARGTYPES, x.device,
                  _build.ptr(x), _build.ptr(weight), _build.ptr(out),
                  _build.ptr(rstd), x.numel() // h, h, float(eps),
                  _DTYPES[x.dtype])
    count_launch("rms_norm")
    return out, rstd


def fused_rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor,
                       dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1b: (dx, dw) by the kernel on CUDA tensors, by the plain version on
    CPU tensors.  The kernel's persistent grid writes one f32 dw partial row
    a block into a scratch tensor allocated here (with room for the row sums
    of rows wider than one segment) and sums them in a second kernel."""
    if not x.is_cuda:
        return rms_norm_bwd_plain(x, weight, rstd, dy)
    _check(x, weight)
    _refuse_grad(x, weight, dy)
    h = x.shape[-1]
    n = x.numel() // h
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"rms_norm bwd kernel: dy must be a contiguous "
                         f"{x.dtype} tensor of x's shape {tuple(x.shape)}")
    if rstd.dtype != torch.float32 or rstd.numel() != n or \
            rstd.device != x.device or not rstd.is_contiguous():
        raise ValueError(f"rms_norm bwd kernel: rstd must be {n} contiguous "
                         f"f32 values on {x.device}")
    dx = torch.empty_like(x)
    if n == 0:
        return dx, torch.zeros_like(weight)
    dw = torch.empty_like(weight)
    blocks = min(n, _BWD_BLOCKS_PER_SM * _build.sm_count(x.device))
    scratch = torch.empty(blocks * h + n, dtype=torch.float32, device=x.device)
    _build.launch("rms_norm", "ptt_rms_norm_bwd", _BWD_ARGTYPES, x.device,
                  _build.ptr(x), _build.ptr(weight), _build.ptr(rstd),
                  _build.ptr(dy), _build.ptr(dx), _build.ptr(dw),
                  _build.ptr(scratch), n, h, blocks, _DTYPES[x.dtype])
    count_launch("rms_norm_bwd")
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with its backward: B1 and B1b on CUDA tensors, the plain
    pair on CPU tensors.  Saves (x, w, rstd)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, eps: float):
        out, rstd = fused_rms_norm(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return out

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = fused_rms_norm_bwd(x, weight, rstd, dy.contiguous())
        return dx, dw, None
