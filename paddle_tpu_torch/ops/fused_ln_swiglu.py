"""Fused SwiGLU (B4), the one-sweep AdamW update (B5) and the fused
residual-add + LayerNorm (B11, B11b): the hand kernels in
``csrc/fused_ln_swiglu.cu``, their plain PyTorch twins, and the autograd
Functions that pair the forward and backward kernels.

Replaces the reference's ``ops/pallas/fused_ln_swiglu.py``, whole:
``fused_swiglu`` (``_swiglu_fwd``/``_swiglu_bwd`` → ``_elementwise_call``),
``fused_adamw`` and ``fused_add_layer_norm`` (``_ln_fwd``, ``_ln_bwd``).
Each plain twin computes what the TPU kernel computes, step by step, in
f32.  The kernel wrappers take the plain twin on a CPU tensor and launch
the kernel on a CUDA tensor, or raise; they take no part in autograd
(:class:`SwiGLUFunction` and :class:`AddLayerNormFunction` do).  The TPU
wrappers' shape gates (rows % 8, h % 128, ``fused_adamw_supported``) are
Mosaic tiling limits, not semantics: the kernels here take every size.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import LAUNCHES, _build

__all__ = ["swiglu_plain", "swiglu_bwd_plain", "fused_swiglu", "fused_swiglu_bwd",
           "SwiGLUFunction", "adamw_scalars", "adamw_plain", "fused_adamw",
           "add_layer_norm_plain", "add_layer_norm_bwd_plain", "fused_add_layer_norm",
           "fused_add_layer_norm_bwd", "AddLayerNormFunction"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_SWIGLU_ARGTYPES = (_P, _P, _P, ctypes.c_longlong, ctypes.c_int)
_SWIGLU_BWD_ARGTYPES = (_P,) * 5 + (ctypes.c_longlong, ctypes.c_int)
_ADAMW_ARGTYPES = (_P,) * 4 + (ctypes.c_longlong,) + (ctypes.c_float,) * 9 + \
    (ctypes.c_int, ctypes.c_int)
_LN_ARGTYPES = (_P,) * 8 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                            ctypes.c_int, ctypes.c_int)
_LN_BWD_ARGTYPES = (_P,) * 10 + (ctypes.c_longlong,) + (ctypes.c_int,) * 4
_LN_BWD_BLOCKS_PER_SM = 2       # B11b's persistent grid: blocks an SM (as B1b's)
_SMEM_BYTES = 227 * 1024        # shared memory one block may take on the H100


def _refuse_grad(op: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"the {op} kernel wrappers do not record gradients; "
                           f"call its autograd Function")


def _check_like(op: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Every tensor a contiguous one of ``ref``'s shape, dtype and device."""
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{op} kernel takes f32 or bf16, got {ref.dtype}")
    for name, t in dict(ref=ref, **tensors).items():
        if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device \
                or not t.is_contiguous():
            raise ValueError(f"{op} kernel: {name} must be a contiguous {ref.dtype} "
                             f"tensor of shape {tuple(ref.shape)} on {ref.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------------------
# B4: SwiGLU
# ---------------------------------------------------------------------------
def swiglu_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in f32, in gate's dtype (``_swiglu_fwd_kernel``)."""
    g, u = gate.float(), up.float()
    return (g * torch.sigmoid(g) * u).to(gate.dtype)


def swiglu_bwd_plain(gate: torch.Tensor, up: torch.Tensor, dy: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgate, dup) in f32, both in gate's dtype (``_swiglu_bwd_kernel``):
    dg = dy·u·(σ + silu·(1 − σ)), du = dy·silu."""
    g, u, d = gate.float(), up.float(), dy.float()
    sig = torch.sigmoid(g)
    silu = g * sig
    return ((d * u * (sig + silu * (1.0 - sig))).to(gate.dtype),
            (d * silu).to(gate.dtype))


def fused_swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """B4 forward: the kernel on CUDA tensors, the plain twin on CPU ones."""
    if not gate.is_cuda:
        return swiglu_plain(gate, up)
    _check_like("swiglu", gate, up=up)
    _refuse_grad("swiglu", gate, up)
    out = torch.empty_like(gate)
    _build.launch("fused_ln_swiglu", "ptt_swiglu_fwd", _SWIGLU_ARGTYPES, gate.device,
                  _build.ptr(gate), _build.ptr(up), _build.ptr(out), gate.numel(),
                  _DTYPES[gate.dtype])
    LAUNCHES["swiglu"] += 1
    return out


def fused_swiglu_bwd(gate: torch.Tensor, up: torch.Tensor, dy: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4 backward: (dgate, dup) by the kernel on CUDA tensors, by the plain
    twin on CPU ones."""
    if not gate.is_cuda:
        return swiglu_bwd_plain(gate, up, dy)
    _check_like("swiglu bwd", gate, up=up, dy=dy)
    _refuse_grad("swiglu", gate, up, dy)
    dg, du = torch.empty_like(gate), torch.empty_like(gate)
    _build.launch("fused_ln_swiglu", "ptt_swiglu_bwd", _SWIGLU_BWD_ARGTYPES, gate.device,
                  _build.ptr(gate), _build.ptr(up), _build.ptr(dy), _build.ptr(dg),
                  _build.ptr(du), gate.numel(), _DTYPES[gate.dtype])
    LAUNCHES["swiglu_bwd"] += 1
    return dg, du


class SwiGLUFunction(torch.autograd.Function):
    """silu(gate) * up with its backward: B4's two kernels on CUDA tensors,
    the plain pair on CPU ones.  Saves (gate, up), as the custom VJP does."""

    @staticmethod
    def forward(ctx, gate: torch.Tensor, up: torch.Tensor):
        ctx.save_for_backward(gate, up)
        return fused_swiglu(gate, up)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        gate, up = ctx.saved_tensors
        return fused_swiglu_bwd(gate, up, dy.contiguous())


# ---------------------------------------------------------------------------
# B5: AdamW
# ---------------------------------------------------------------------------
def adamw_scalars(lr: float, t: int, beta1: float, beta2: float
                  ) -> Tuple[float, float, float]:
    """(lr, 1 − β1^t, 1 − β2^t) computed in f32, as the TPU wrapper computes
    them (``fused_adamw``: ``lr`` and ``t`` as f32 arrays)."""
    tf = np.float32(t)
    one = np.float32(1.0)
    return (float(np.float32(lr)), float(one - np.float32(beta1) ** tf),
            float(one - np.float32(beta2) ** tf))


def adamw_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                lr: float, bc1: float, bc2: float, beta1: float, beta2: float,
                eps: float, weight_decay: float, decay: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(new p in p's dtype, new m, new v in f32), step by step as
    ``_adamw_kernel``: ``lr``, ``bc1`` = 1 − β1^t and ``bc2`` = 1 − β2^t are
    f32 values (:func:`adamw_scalars`); with ``decay`` the old p decays by
    lr·weight_decay (their f32 product)."""
    pf, gf = p.float(), g.float()
    m_new = beta1 * m.float() + (1.0 - beta1) * gf
    v_new = beta2 * v.float() + (1.0 - beta2) * gf.square()
    update = (m_new / bc1) / ((v_new / bc2).sqrt() + eps)
    new_p = pf - lr * update
    if decay:
        new_p = new_p - float(np.float32(lr) * np.float32(weight_decay)) * pf
    return new_p.to(p.dtype), m_new, v_new


def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                lr: float, t: int, beta1: float, beta2: float, eps: float,
                weight_decay: float, decay: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B5: one AdamW step of ``p`` (any shape; p and g of one dtype, m and
    v f32), written IN PLACE into p, m and v, which are returned.  The TPU
    kernel returns new arrays; updating in place saves three f32 copies of
    every parameter a step.  The kernel on CUDA tensors, the plain twin
    (whose results are copied in) on CPU tensors."""
    lr32, bc1, bc2 = adamw_scalars(lr, t, beta1, beta2)
    _refuse_grad("adamw", p, g, m, v)
    if not p.is_cuda:
        new = adamw_plain(p, g, m, v, lr32, bc1, bc2, beta1, beta2, eps,
                          weight_decay, decay)
        for dst, src in zip((p, m, v), new):
            dst.copy_(src)
        return p, m, v
    _check_like("adamw", p, g=g)
    _check_like("adamw", m, v=v)
    if m.dtype != torch.float32 or m.shape != p.shape or m.device != p.device:
        raise ValueError(f"adamw kernel: m and v must be f32 {tuple(p.shape)} on "
                         f"{p.device}, got {m.dtype} {tuple(m.shape)}")
    _build.launch("fused_ln_swiglu", "ptt_adamw", _ADAMW_ARGTYPES, p.device,
                  _build.ptr(p), _build.ptr(g), _build.ptr(m), _build.ptr(v), p.numel(),
                  lr32, bc1, bc2, beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
                  float(np.float32(lr32) * np.float32(weight_decay)), int(decay),
                  _DTYPES[p.dtype])
    LAUNCHES["adamw"] += 1
    return p, m, v


# ---------------------------------------------------------------------------
# B11 / B11b: residual add + LayerNorm
# ---------------------------------------------------------------------------
def add_layer_norm_plain(x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, sum in x's dtype, mu, rstd [..., 1] in f32) as ``_ln_fwd_kernel``:
    s = x + r in f32, mu = mean(s), var = mean((s − mu)²), rstd =
    rsqrt(var + eps), out = (s − mu)·rstd·w + b.  w and b may be f32 while
    x is bf16."""
    s = x.float() + residual.float()
    mu = s.mean(-1, keepdim=True)
    rstd = torch.rsqrt((s - mu).square().mean(-1, keepdim=True) + eps)
    out = (s - mu) * rstd * weight.float() + bias.float()
    return out.to(x.dtype), s.to(x.dtype), mu, rstd


def add_layer_norm_bwd_plain(s: torch.Tensor, weight: torch.Tensor, mu: torch.Tensor,
                             rstd: torch.Tensor, dy: torch.Tensor,
                             dpre: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dw, db) as ``_ln_bwd_kernel``, in f32: x^ = (s − mu)·rstd from the
    stored sum ``s`` (rounded to its dtype) and the forward's f32 mu, rstd;
    c1 = mean(dy·w), c2 = mean(dy·w·x^); dx = rstd·(dy·w − c1 − x^·c2) +
    dpre in s's dtype (the gradient of both x and the residual); dw = Σ
    dy·x^ and db = Σ dy over every row, in w's dtype."""
    h = s.shape[-1]
    xhat = (s.float() - mu) * rstd
    dyf = dy.float()
    dyw = dyf * weight.float()
    c1 = dyw.sum(-1, keepdim=True) / h
    c2 = (dyw * xhat).sum(-1, keepdim=True) / h
    dx = rstd * (dyw - c1 - xhat * c2)
    if dpre is not None:
        dx = dx + dpre.float()
    dw = (dyf * xhat).reshape(-1, h).sum(0)
    db = dyf.reshape(-1, h).sum(0)
    return dx.to(s.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def _check_ln(op: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              **like_x: torch.Tensor) -> None:
    h = x.shape[-1]
    _check_like(op, x, **like_x)
    if weight.dtype not in _DTYPES:
        raise TypeError(f"{op} kernel takes an f32 or bf16 weight, got {weight.dtype}")
    _check_like(op, weight, bias=bias)
    if weight.shape != (h,) or weight.device != x.device:
        raise ValueError(f"{op} kernel: weight and bias must be [{h}] on {x.device}, "
                         f"got {tuple(weight.shape)} on {weight.device}")


def fused_add_layer_norm(x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """B11: (out, sum, mu, rstd) by the kernel on CUDA tensors, by the plain
    twin on CPU ones."""
    if not x.is_cuda:
        return add_layer_norm_plain(x, residual, weight, bias, eps)
    _check_ln("add_layer_norm", x, weight, bias, residual=residual)
    _refuse_grad("add_layer_norm", x, residual, weight, bias)
    h = x.shape[-1]
    if h * 4 > _SMEM_BYTES:
        raise ValueError(f"add_layer_norm kernel keeps a row's f32 sum in shared memory: "
                         f"h = {h} exceeds {_SMEM_BYTES} bytes")
    out, s = torch.empty_like(x), torch.empty_like(x)
    mu = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    _build.launch("fused_ln_swiglu", "ptt_add_layer_norm_fwd", _LN_ARGTYPES, x.device,
                  _build.ptr(x), _build.ptr(residual), _build.ptr(weight), _build.ptr(bias),
                  _build.ptr(out), _build.ptr(s), _build.ptr(mu), _build.ptr(rstd),
                  x.numel() // h, h, float(eps), _DTYPES[x.dtype], _DTYPES[weight.dtype])
    LAUNCHES["add_layer_norm"] += 1
    return out, s, mu, rstd


def fused_add_layer_norm_bwd(s: torch.Tensor, weight: torch.Tensor, mu: torch.Tensor,
                             rstd: torch.Tensor, dy: torch.Tensor,
                             dpre: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B11b: (dx, dw, db) by the kernel on CUDA tensors, by the plain twin
    on CPU ones.  The kernel's persistent grid writes f32 dw and db partial
    rows, one pair a block, into a scratch tensor allocated here (with room
    for the row sums of rows wider than one segment) and sums them in a
    second kernel.  Any h: the kernel keeps no row in shared memory."""
    if not s.is_cuda:
        return add_layer_norm_bwd_plain(s, weight, mu, rstd, dy, dpre)
    like = dict(dy=dy) if dpre is None else dict(dy=dy, dpre=dpre)
    _check_ln("add_layer_norm bwd", s, weight, weight, **like)
    _refuse_grad("add_layer_norm", s, weight, dy)
    h = s.shape[-1]
    n = s.numel() // h
    for name, t in (("mu", mu), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.numel() != n or t.device != s.device \
                or not t.is_contiguous():
            raise ValueError(f"add_layer_norm bwd kernel: {name} must be {n} "
                             f"contiguous f32 values on {s.device}")
    dx = torch.empty_like(s)
    if n == 0:
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    blocks = min(n, _LN_BWD_BLOCKS_PER_SM * _build.sm_count(s.device))
    scratch = torch.empty(blocks * 2 * h + 2 * n, dtype=torch.float32, device=s.device)
    _build.launch("fused_ln_swiglu", "ptt_add_layer_norm_bwd", _LN_BWD_ARGTYPES, s.device,
                  _build.ptr(s), _build.ptr(weight), _build.ptr(mu), _build.ptr(rstd),
                  _build.ptr(dy), _build.ptr(dpre), _build.ptr(dx), _build.ptr(dw),
                  _build.ptr(db), _build.ptr(scratch), n, h, blocks, _DTYPES[s.dtype],
                  _DTYPES[weight.dtype])
    LAUNCHES["add_layer_norm_bwd"] += 1
    return dx, dw, db


class AddLayerNormFunction(torch.autograd.Function):
    """(LayerNorm(x + residual)·w + b, x + residual) with the backward: B11
    and B11b on CUDA tensors, the plain pair on CPU ones.  Saves (sum, w,
    mu, rstd); the backward takes the cotangents of both outputs and gives
    x and the residual the same gradient."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps: float):
        out, s, mu, rstd = fused_add_layer_norm(x, residual, weight, bias, eps)
        ctx.save_for_backward(s, weight, mu, rstd)
        return out, s

    @staticmethod
    def backward(ctx, dy, dpre):
        s, weight, mu, rstd = ctx.saved_tensors
        dx, dw, db = fused_add_layer_norm_bwd(
            s, weight, mu, rstd, dy.contiguous(),
            None if dpre is None else dpre.contiguous())
        return dx, dx, dw, db, None
