"""Quantized KV-cache pages: dtype resolution, per-token int8 scales, the
static-scale fp8 format, and page byte accounting (port of the reference's
``serving/kv_quant.py``).

- **int8** pages store ``int8`` values and a per-(token slot, kv head)
  ``float32`` scale computed at write time from the token's own absmax
  (``scale = max(|x|, 1e-8) / 127``, computed as below), so no
  calibration pass is needed.
- **fp8** pages store ``float8_e4m3fn`` under ONE static scale
  (``PADDLE_TPU_KV_FP8_SCALE``, default 1.0) and no scale planes, so an fp8
  page costs exactly half a bf16 page.

The serving engine quantizes on its page scatter and dequantizes at its
gather; the B8/B9 decode kernels' plain twins (``ops/decode_attention.py``)
quantize the row they append with the same functions.

The reference's programs are compiled by XLA, which turns a division by a
constant (127, the fp8 scale) into a multiplication by the constant's f32
reciprocal; the values it stores come from that product, not from the
true quotient (which can differ in the last bit).  These functions, and
the B8/B9 kernels, compute the same product, so the pages, scales and
appended rows agree with the reference's bit for bit.  A division by a
tensor (``x / scale`` per element) stays a true division everywhere.

Env: ``PADDLE_TPU_KV_DTYPE=bf16|int8|fp8`` (default ``bf16``, the engine's
native compute dtype); ``PADDLE_TPU_KV_FP8_SCALE`` sets the fp8 scale.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["KV_DTYPES", "kv_cache_dtype", "quantize_kv", "dequantize_kv",
           "quantize_kv_fp8", "dequantize_kv_fp8", "default_fp8_scale",
           "observe_kv_absmax", "kv_page_bytes", "kv_scale_page_bytes",
           "FP8_MAX", "DTYPE_BYTES"]

KV_DTYPES = ("bf16", "int8", "fp8")
_QMAX = 127.0
_SCALE_EPS = 1e-8       # all-zero tokens (trash page writes) quantize to 0
FP8_MAX = 448.0         # float8_e4m3fn's largest finite value (it has no inf)

# itemsize by dtype code: the reference prices pages through
# ``analysis.program.DTYPE_BYTES``; these are the entries kv pages use
DTYPE_BYTES = {"f32": 4, "bf16": 2, "s8": 1, "f8e4m3fn": 1}


def kv_cache_dtype(override: Optional[str] = None) -> str:
    """Resolve the KV page dtype: ``override`` beats ``PADDLE_TPU_KV_DTYPE``
    beats the ``bf16`` default, which means the engine's native compute
    dtype (f32 for an f32 model)."""
    v = (override if override is not None
         else os.environ.get("PADDLE_TPU_KV_DTYPE", "bf16")).strip().lower()
    if v in ("bf16", "bfloat16", "native", "f32", "float32", ""):
        return "bf16"
    if v in ("int8", "s8"):
        return "int8"
    if v in ("fp8", "f8", "f8e4m3fn"):
        return "fp8"
    if v == "f8e5m2":
        raise NotImplementedError(
            "PADDLE_TPU_KV_DTYPE=f8e5m2: only the e4m3fn fp8 flavor is "
            "wired (KV magnitudes want mantissa, not exponent range). "
            f"Supported PADDLE_TPU_KV_DTYPE values: {KV_DTYPES}")
    raise ValueError(
        f"PADDLE_TPU_KV_DTYPE={v!r}: expected one of {KV_DTYPES} "
        "(aliases: bfloat16/native/f32/float32 -> bf16, s8 -> int8, "
        "f8/f8e4m3fn -> fp8)")


def _reciprocal(value: float) -> float:
    """The f32 reciprocal of the f32 constant ``value``, as XLA folds it.
    An f32 tensor times this Python float is an f32 product on the CPU and
    the card alike (the float is exactly an f32)."""
    return float(np.float32(1.0) / np.float32(value))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: ``x`` [..., kv, d] → (int8 values, f32
    scales [..., kv] over the trailing ``d`` axis): ``scale = max(amax,
    1e-8) * f32(1/127)``, ``round(x / scale)`` half to even, as the
    reference's ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(_SCALE_EPS) * _reciprocal(_QMAX)
    q = torch.round(xf / scale[..., None]).clamp(-_QMAX, _QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: f32 values ``q * scale``."""
    return q.float() * scale[..., None].float()


def default_fp8_scale() -> float:
    """Static per-tensor fp8 scale (``PADDLE_TPU_KV_FP8_SCALE``, default
    1.0, which stores KV raw; e4m3fn's ±448 covers typical magnitudes)."""
    s = float(os.environ.get("PADDLE_TPU_KV_FP8_SCALE", "1.0"))
    if not s > 0.0:
        raise ValueError(f"PADDLE_TPU_KV_FP8_SCALE={s}: must be > 0")
    return s


def quantize_kv_fp8(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Static-scale e4m3fn: ``clip(x * f32(1/scale), ±FP8_MAX)`` cast to
    fp8 (the reference's ``x / scale`` as XLA compiles it).  The
    clip makes saturation explicit and independent of the PyTorch version:
    some versions' casts saturate, others turn an overflow into NaN."""
    xf = x.float() * _reciprocal(scale)
    return xf.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)


def dequantize_kv_fp8(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_fp8`: f32 values ``q * scale``."""
    return q.float() * scale


def observe_kv_absmax(samples) -> float:
    """Calibrate the fp8 scale from sample KV tensors.  Needs the
    quantization observers (``quantization.AbsmaxObserver``), which are not
    ported yet."""
    raise NotImplementedError(
        "observe_kv_absmax needs the PTQ observers (quantization/), which "
        "are not ported yet: ROADMAP queue A10")


def _dtype_code(kv_dtype: str) -> str:
    return {"bf16": "bf16", "int8": "s8", "fp8": "f8e4m3fn"}[kv_dtype]


def kv_page_bytes(page_tokens: int, kv_heads: int, head_dim: int,
                  kv_dtype: str, *, n_layers: int = 1) -> int:
    """Device bytes of ONE pool page's k+v arena slices across
    ``n_layers``, with ``bf16`` priced at 2 bytes (the reference's
    accounting, whatever the engine's compute dtype).  Excludes scales."""
    per = DTYPE_BYTES[_dtype_code(kv_dtype)]
    return 2 * n_layers * page_tokens * kv_heads * head_dim * per


def kv_scale_page_bytes(page_tokens: int, kv_heads: int, kv_dtype: str,
                        *, n_layers: int = 1) -> int:
    """Bytes of one page's k+v scale slices (f32 per token slot per kv
    head): zero for bf16 and for fp8, whose one scale is a scalar."""
    if kv_dtype in ("bf16", "fp8"):
        return 0
    return 2 * n_layers * page_tokens * kv_heads * DTYPE_BYTES["f32"]
