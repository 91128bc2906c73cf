"""paddle_tpu_torch: the PyTorch and CUDA port of ``paddle_tpu``.

Module paths mirror the JAX package, so each module's counterpart is found
at the same relative path.  This package imports ``torch`` only, never
``jax`` or ``paddle_tpu``.  Entry points run on the CUDA card unless the
caller asks for the CPU (:func:`set_device`, or ``device="cpu"``).

The first slice is Llama serving: ``models.LlamaForCausalLM.generate`` and
``inference.Predictor.from_model(...).generate_batch``, over hand-written
Hopper kernels for RMSNorm, RoPE, flash attention and decode attention
(``ops/csrc/``).  The second is the Llama training step:
``jit.TrainStep`` with ``optimizer.AdamW``, ``nn.ClipGradByGlobalNorm`` and
``amp.decorate(level="O2")``, over the backward kernels of RMSNorm, RoPE
and flash attention.
"""

from . import amp, jit, nn, optimizer  # noqa: F401
from .device import get_device, set_device  # noqa: F401
from .framework.flags import flag_guard, get_flags, set_flags  # noqa: F401

__all__ = ["set_device", "get_device", "get_flags", "set_flags", "flag_guard",
           "amp", "jit", "nn", "optimizer"]
