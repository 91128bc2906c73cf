"""The port's operators: a plain PyTorch version and a hand-written Hopper
kernel for each TPU kernel of the serving and training paths.

The dispatch seam (port of the reference's ``pallas_eligible`` /
``pallas_mode``, ``ops/__init__.py:26-58``) is :func:`use_kernel`: a
tensor on the card whose kernel flag is on gets the hand kernel; a CPU
tensor, or a flag the caller turned off, gets the plain version.  There is
no other branch: no shape gate and no fallback.  A kernel wrapper given a
CUDA tensor it cannot take raises.  When a gradient is wanted and the flag
is on, :func:`use_function` routes the call through the op's
``torch.autograd.Function``, which pairs the forward kernel with its
backward kernel on the card and the two plain versions on the CPU.

While ``torch.export`` traces (``jit.save``), :func:`export_route` sends a
flag-on call to the op's registered operator (``custom_ops``) on either
device, so that the saved graph holds the kernel as a node; a flag the
caller turned off is honoured and the plain version is traced.  Eager
calls never take that route.

``LAUNCHES`` counts the launches of each kernel.  A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path
went through the kernels (``chip_smoke.py`` resets and reads it).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..framework.flags import get_flags

__all__ = ["use_kernel", "use_function", "export_route", "exported_op", "exporting",
           "LAUNCHES", "reset_launch_counts"]

LAUNCHES: Dict[str, int] = {"rms_norm": 0, "rope": 0, "flash_attention": 0,
                            "decode_attention": 0, "rms_norm_bwd": 0,
                            "rope_bwd": 0, "flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_dkv": 0, "swiglu": 0,
                            "swiglu_bwd": 0, "adamw": 0, "add_layer_norm": 0,
                            "add_layer_norm_bwd": 0,
                            "decode_attention_int8": 0, "decode_attention_fp8": 0,
                            "ring_merge": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_EXPORTING = [0]


class exporting:
    """Context of a ``torch.export`` trace that ``jit.save`` opens; inside
    it (or wherever ``torch.compiler.is_exporting()`` holds) the seam
    routes to the registered operators."""

    def __enter__(self):
        _EXPORTING[0] += 1
        return self

    def __exit__(self, *exc):
        _EXPORTING[0] -= 1


def export_route(flag_name: str) -> bool:
    """True while a program is being exported and the kernel flag is on:
    the op is then traced as its ``paddle_tpu_torch::`` operator."""
    if not (_EXPORTING[0] or torch.compiler.is_exporting()):
        return False
    return bool(get_flags(flag_name)[flag_name])


def exported_op(name: str):
    """The operator ``paddle_tpu_torch::<name>`` (registered on first use)."""
    from .custom_ops import op

    return op(name)


def use_kernel(flag_name: str, x: torch.Tensor) -> bool:
    """True when ``x`` lies on the card and the kernel flag is on."""
    return x.is_cuda and bool(get_flags(flag_name)[flag_name])


def use_function(flag_name: str, *tensors: torch.Tensor) -> bool:
    """True when the kernel flag is on and grad is wanted for one of
    ``tensors``: the op then runs its forward/backward Function."""
    return (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
            and bool(get_flags(flag_name)[flag_name]))
