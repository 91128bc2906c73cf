"""RMSNorm forward: the hand kernel B1 (``csrc/rms_norm.cu``) and its plain
PyTorch twin.

Replaces the reference's ``ops/pallas/fused_norm.py`` forward
(``fused_rms_norm`` → ``_rms_fwd`` → ``_fwd_kernel``).  The backward kernel
(B1b) is not ported yet; the kernel wrapper refuses inputs that need a
gradient.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import LAUNCHES, _build

__all__ = ["rms_norm_plain", "fused_rms_norm"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., H], weight [H] → (out [..., H] in x's dtype, rstd [..., 1]
    f32); the normalisation and the weight product in f32."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * rstd * weight.float()).to(x.dtype), rstd


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not x.is_cuda:
        return rms_norm_plain(x, weight, eps)
    h = x.shape[-1]
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"rms_norm kernel takes f32 or bf16 x and a weight of "
                        f"the same dtype, got {x.dtype} and {weight.dtype}")
    if weight.shape != (h,) or weight.device != x.device:
        raise ValueError(f"rms_norm kernel: weight must be [{h}] on {x.device}, "
                         f"got {tuple(weight.shape)} on {weight.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel takes contiguous x and weight")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise NotImplementedError(
            "the rms_norm backward kernel (B1b) is not ported yet; run the "
            "forward under torch.no_grad()")
    out = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    _build.launch("rms_norm", "ptt_rms_norm_fwd", _ARGTYPES, x.device,
                  _build.ptr(x), _build.ptr(weight), _build.ptr(out),
                  _build.ptr(rstd), x.numel() // h, h, float(eps),
                  _DTYPES[x.dtype])
    LAUNCHES["rms_norm"] += 1
    return out, rstd
