"""paddle_tpu_torch: the PyTorch and CUDA port of ``paddle_tpu``.

Module paths mirror the JAX package, so each module's counterpart is found
at the same relative path, and the reference's top-level names
(``paddle_tpu/__init__.py``) are here as far as the port has them:
``import paddle_tpu_torch as paddle`` then ``paddle.seed(0)``,
``paddle.to_tensor``, ``paddle.no_grad``, ``paddle.grad``, ``paddle.float32``,
``paddle.save``/``load``, ``paddle.io``, ``paddle.distributed``, ....  A
reference name whose module is not ported yet raises NotImplementedError
naming its ROADMAP item.  This package imports ``torch`` only, never
``jax`` or ``paddle_tpu``.  Entry points run on the CUDA card unless the
caller asks for the CPU (:func:`set_device`, or ``device="cpu"``).

The port's slices, over hand-written Hopper kernels (``ops/csrc/``) for
RMSNorm, RoPE, flash attention, decode attention (bf16, int8, fp8 caches),
SwiGLU, residual-add LayerNorm and AdamW:

- Llama serving: ``models.LlamaForCausalLM.generate``,
  ``inference.Predictor``, ``generation`` (beam search, speculative
  decoding) and the ``serving`` engine (paged KV cache, prefix cache,
  offload, journal, context and tensor parallelism);
- training: ``jit.TrainStep`` with ``optimizer.AdamW``, ``nn`` clips and
  ``amp.decorate(level="O2")``, the GPT and ERNIE models, and
  ``distributed`` (collectives, ``DataParallel``, ``fleet``'s hybrid step,
  pipelines, ZeRO with offload, ``auto_parallel``);
- the ``nn.Layer`` tree with the image layers (``vision.models.resnet``),
  ``io``'s data loading and ``metric``;
- the core: :class:`Tensor` (which is ``torch.Tensor``), the tensor
  functions, autograd (``grad``, ``PyLayer``, ``jacobian``), the dtypes and
  the generators, and the eager idiom ``loss.backward(); opt.step();
  opt.clear_grad()``.
"""

from __future__ import annotations

import importlib

import torch

__version__ = "0.1.0"

from .framework import dtype as _dtype  # noqa: E402,F401
from .framework.dtype import (bfloat16, bool_, complex128, complex64, finfo,  # noqa: E402,F401
                              float16, float32, float64, iinfo, int16, int32, int64, int8,
                              uint8)
from .framework.flags import flag_guard, get_flags, set_flags  # noqa: E402,F401
from .framework.random import Generator, get_rng_state, seed, set_rng_state  # noqa: E402,F401
from .device import (CPUPlace, CUDAPlace, DeviceGuard, Place, TPUPlace,  # noqa: E402,F401
                     XPUPlace, device_count, get_device, is_compiled_with_tpu, set_device,
                     synchronize)

from .tensor import *  # noqa: E402,F401,F403
from .tensor import Tensor, is_tensor, to_tensor  # noqa: E402,F401
from .tensor.creation import Parameter  # noqa: E402,F401

from .autograd import (enable_grad, grad, is_grad_enabled, no_grad,  # noqa: E402,F401
                       set_grad_enabled)
from . import autograd  # noqa: E402,F401
from . import amp, framework, jit, nn, optimizer  # noqa: E402,F401
from .framework.io import load, save  # noqa: E402,F401

# subpackages imported on first use (they import more of torch)
_SUBPACKAGES = frozenset({"io", "distributed", "metric", "vision", "incubate", "telemetry",
                          "inference", "generation", "models", "serving", "ops", "convert"})

# the reference's top-level names whose modules wait for a ROADMAP item
_UNPORTED = {
    **dict.fromkeys(("profiler", "compile", "hapi", "Model", "callbacks", "distribution",
                     "fft", "audio", "hub", "geometric", "signal", "sparse", "onnx",
                     "quantization", "static", "text", "utils"),
                    "A10 (tooling and long tail)"),
}


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _UNPORTED:
        raise NotImplementedError(
            f"paddle_tpu_torch.{name} is not ported yet (ROADMAP {_UNPORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def is_compiled_with_cuda() -> bool:
    """True when this torch was built with CUDA."""
    return torch.version.cuda is not None


def is_compiled_with_xpu() -> bool:
    return False


def in_dynamic_mode() -> bool:
    return True


def disable_static(*a, **k) -> None:
    pass


def enable_static(*a, **k) -> None:
    raise NotImplementedError(
        "paddle_tpu_torch has no static graph mode; it runs eagerly "
        "(jit.to_static is ROADMAP A3d)")
