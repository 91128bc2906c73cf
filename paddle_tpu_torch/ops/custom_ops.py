"""The forward kernels as ``torch.library`` operators: the face that
``torch.export`` can trace.

A kernel wrapper hands raw device addresses to its ``ctypes`` entry point,
and ``torch.export`` traces with fake tensors, which have no address.  So
each forward kernel that a model's forward can reach is registered here as
an operator of the ``paddle_tpu_torch`` namespace: B1 ``rms_norm``, B2
``rope``, B3 ``flash_attention`` (causal or full, f32 or bf16, head_dim up
to 256, with or without ``pad_lens``), B4 ``swiglu`` and B11
``add_layer_norm``.  An operator's body is the kernel's wrapper, which
launches the kernel on a CUDA tensor (and counts the launch in
``LAUNCHES``) or raises, and takes the plain version on a CPU tensor; its
fake gives the wrapper's output shapes and dtypes, contiguous.  A saved program holds
``paddle_tpu_torch::flash_attention`` and its fellows as nodes, and
loading the program needs this module imported, which ``jit.load`` does.

Only the export seam calls these operators (:func:`..ops.export_route`):
an eager call keeps its direct wrapper, with no dispatcher in between.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention_fwd
from .fused_ln_swiglu import fused_add_layer_norm, fused_swiglu
from .fused_norm import fused_rms_norm
from .rope import fused_rope

__all__ = ["OPS", "op"]

NAMESPACE = "paddle_tpu_torch"


@torch.library.custom_op(f"{NAMESPACE}::rms_norm", mutates_args=())
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: (out [..., H] in x's dtype, rstd [..., 1] f32)."""
    return fused_rms_norm(x.contiguous(), weight.contiguous(), eps)


@rms_norm.register_fake
def _(x, weight, eps):
    return x.new_empty(x.shape), x.new_empty(x.shape[:-1] + (1,), dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::rope", mutates_args=())
def rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
         pos_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: q, k rotated at ``pos_ids`` (clipped into the tables)."""
    return fused_rope(q.contiguous(), k.contiguous(), cos.contiguous(),
                      sin.contiguous(), pos_ids.contiguous())


@rope.register_fake
def _(q, k, cos, sin, pos_ids):
    return q.new_empty(q.shape), k.new_empty(k.shape)


@torch.library.custom_op(f"{NAMESPACE}::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    pad_lens: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: (out [b, sq, hq, d] in q's dtype, lse [b, hq, sq] f32), both
    contiguous as the kernel writes them (the plain version's out is a
    strided view)."""
    out, lse = flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                                   None if pad_lens is None else pad_lens.contiguous())
    return out.contiguous(), lse.contiguous()


@flash_attention.register_fake
def _(q, k, v, causal, pad_lens=None):
    b, sq, hq, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, hq, sq), dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::swiglu", mutates_args=())
def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """B4: silu(gate) * up in f32, in gate's dtype."""
    return fused_swiglu(gate.contiguous(), up.contiguous())


@swiglu.register_fake
def _(gate, up):
    return gate.new_empty(gate.shape)


@torch.library.custom_op(f"{NAMESPACE}::add_layer_norm", mutates_args=())
def add_layer_norm(x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """B11: (out, sum in x's dtype, mu, rstd [..., 1] f32)."""
    return fused_add_layer_norm(x.contiguous(), residual.contiguous(),
                                weight.contiguous(), bias.contiguous(), eps)


@add_layer_norm.register_fake
def _(x, residual, weight, bias, eps):
    stat = x.new_empty(x.shape[:-1] + (1,), dtype=torch.float32)
    return x.new_empty(x.shape), x.new_empty(x.shape), stat, stat.new_empty(stat.shape)


# the seam's flag → operator
OPS = {"rms_norm": rms_norm, "rope": rope, "flash_attention": flash_attention,
       "swiglu": swiglu, "add_layer_norm": add_layer_norm}


def op(name: str):
    """The registered operator ``paddle_tpu_torch::<name>``."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default
