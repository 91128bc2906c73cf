"""Runtime flags read by the port's serving and training paths.

A copy of the registry in the reference package (``framework/flags.py``),
with the same flag names, so that ``set_flags`` calls written for the JAX
package keep working.  Each flag can be set from the environment as
``FLAGS_<name>`` before import.

The reference's flags that nothing in the port reads are defined all the
same, each saying so in its doc, so that setting them keeps working.
The tile-size defaults were measured on a TPU and are kept only as names:
none of them has been measured on the H100.  The Hopper kernels take their
tile shapes from their CUDA sources (``ops/csrc/``), so nothing in this
slice reads ``flash_block_q``, ``flash_block_k``, ``decode_block_k`` or
``generate_cache_size`` (eager generation compiles no programs to cache).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Iterable, Optional, Union

__all__ = ["define_flag", "get_flags", "set_flags", "flag_guard"]

_TRUTHY = {"1", "true", "yes", "on", "y", "t"}
_FALSY = {"0", "false", "no", "off", "n", "f", ""}


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in _TRUTHY:
        return True
    if s in _FALSY:
        return False
    raise ValueError(f"cannot parse boolean flag value: {v!r}")


_lock = threading.RLock()
_values: Dict[str, Any] = {}
_casters: Dict[str, Callable[[Any], Any]] = {}
_read_only: set = set()


def define_flag(name: str, default: Any, doc: str = "", *,
                type: Optional[Callable[[Any], Any]] = None,
                writable: bool = True) -> None:
    """Define a flag; ``FLAGS_<name>`` in the environment overrides the
    default.  ``type`` casts set values (default: the default's type; a
    None default keeps values as given); a flag with ``writable=False``
    refuses ``set_flags``.  ``doc`` is for the reader of this file."""
    if type is not None:
        caster = type
    elif isinstance(default, bool):
        caster = _parse_bool
    elif default is None:
        caster = lambda v: v  # noqa: E731
    else:
        caster = default.__class__
    with _lock:
        if name in _values:
            raise ValueError(f"flag {name!r} already defined")
        env = os.environ.get(f"FLAGS_{name}")
        _casters[name] = caster
        _values[name] = default if env is None else caster(env)
        if not writable:
            _read_only.add(name)


def get_flags(flags: Union[str, Iterable[str], None] = None) -> Dict[str, Any]:
    """A dict of flag values (all flags when ``flags`` is None)."""
    with _lock:
        if flags is None:
            names = sorted(_values)
        elif isinstance(flags, str):
            names = [flags]
        else:
            names = list(flags)
        for n in names:
            if n not in _values:
                raise KeyError(f"unknown flag {n!r}")
        return {n: _values[n] for n in names}


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flag values, e.g. ``set_flags({'use_flash_attention': False})``."""
    with _lock:
        for name, value in flags.items():
            if name not in _values:
                raise KeyError(f"unknown flag {name!r}")
            if name in _read_only:
                raise ValueError(f"flag {name!r} is not writable at runtime")
            _values[name] = _casters[name](value)


class flag_guard:
    """Context manager that sets flags and restores them on exit."""

    def __init__(self, **overrides: Any) -> None:
        self._overrides = overrides
        self._saved: Dict[str, Any] = {}

    def __enter__(self) -> "flag_guard":
        self._saved = get_flags(list(self._overrides))
        set_flags(self._overrides)
        return self

    def __exit__(self, *exc: Any) -> None:
        set_flags(self._saved)


define_flag("use_flash_attention", True,
            "Causal prefill attention (unpadded and left-padded) runs the "
            "hand flash kernel on a CUDA tensor.")
define_flag("use_fused_rms_norm", True,
            "rms_norm runs the hand RMSNorm kernel on a CUDA tensor.")
define_flag("use_fused_rope", True,
            "Rotary embedding runs the hand RoPE kernel on a CUDA tensor.")
define_flag("use_decode_attention", True,
            "Single-token cached attention, with its in-place cache append, "
            "runs the hand decode kernel on a CUDA tensor.")
define_flag("use_fused_swiglu", False,
            "Two-argument swiglu runs the hand fused SwiGLU kernels (B4, "
            "forward and backward) on CUDA tensors, and their f32 plain twins "
            "on CPU tensors. Default off, as in the reference: not yet set "
            "from an H100 measurement (PERF.md has the step with the flag "
            "on and off).")
define_flag("use_fused_adamw", False,
            "Adam/AdamW updates run the hand one-sweep AdamW kernel (B5), in "
            "place, on CUDA tensors, and its f32 plain twin on CPU tensors. "
            "Default off, as in the reference: not yet set from an H100 "
            "measurement (PERF.md has the step with the flag on and off).")
define_flag("use_fused_layernorm", False,
            "incubate.nn.functional.fused_layer_norm with a residual and a "
            "bias runs the hand residual-add + LayerNorm kernels (B11, B11b) "
            "on CUDA tensors, and their f32 plain twins on CPU tensors. "
            "Default off, as in the reference: not yet set from an H100 "
            "measurement (PERF.md).")
define_flag("flash_block_q", 512,
            "Reference name only: the TPU's flash query tile. Not measured "
            "on the H100 and not read by the port.")
define_flag("flash_block_k", 512,
            "Reference name only: the TPU's flash key tile. Not measured on "
            "the H100 and not read by the port.")
define_flag("decode_block_k", 256,
            "Reference name only: the TPU's decode cache tile. Not measured "
            "on the H100 and not read by the port.")
define_flag("generate_cache_size", 32,
            "Reference name only: the JAX package's bound on compiled "
            "generate programs. The eager port compiles none.")
define_flag("check_nan_inf", False,
            "Scan the outputs of the tensor functions (tensor/) for NaN/Inf and "
            "raise FloatingPointError naming the function, as the reference's "
            "eager ops do.")
define_flag("benchmark", False,
            "Reference name: synchronise after every eager op. Not read by the "
            "port.")
define_flag("use_bf16_default", True,
            "AMP's 'half' means bfloat16: amp.auto_cast(dtype='float16') casts to "
            "bfloat16 while it is on. amp.decorate takes its dtype as given.")
define_flag("eager_op_jit_cache", True,
            "Reference name: the per-op compiled-callable cache. No counterpart: "
            "the port's eager ops compile nothing.")
define_flag("tracer_mode", "eager",
            "Reference name: the default execution mode hint. Not read by the "
            "port, which runs eagerly.")
define_flag("allocator_strategy", "auto_growth",
            "Reference name, kept for parity. Means nothing on the card: "
            "PyTorch's caching allocator manages its memory.")
define_flag("comm_timeout_seconds", 1800.0,
            "Timeout of the process group that distributed.init_parallel_env "
            "creates (torch.distributed's collective timeout).")
define_flag("log_level", "INFO", "Reference name: framework log level. Not read by "
            "the port.")
define_flag("pallas_interpret", False,
            "Reference name: run Pallas kernels in the interpreter. Means "
            "nothing here: the port has no Pallas kernels, and CPU tensors run "
            "the plain twins.")
define_flag("seed_offset_by_rank", True,
            "Offset the global seed (framework.random.seed) by the process rank "
            "of torch.distributed, when it is initialized.")
define_flag("fast_dropout_rng", True,
            "Reference name: the TPU's 'rbg' dropout PRNG. On or off, the port "
            "draws dropout masks from torch's generators (Philox on the card), "
            "which are counter-based already: there is nothing to swap.")
