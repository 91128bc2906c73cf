"""Runtime flags read by the port's serving and training paths.

A copy of the registry in the reference package (``framework/flags.py``),
with the same flag names, so that ``set_flags`` calls written for the JAX
package keep working.  Each flag can be set from the environment as
``FLAGS_<name>`` before import.

The tile-size defaults were measured on a TPU and are kept only as names:
none of them has been measured on the H100.  The Hopper kernels take their
tile shapes from their CUDA sources (``ops/csrc/``), so nothing in this
slice reads ``flash_block_q``, ``flash_block_k``, ``decode_block_k`` or
``generate_cache_size`` (eager generation compiles no programs to cache).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Iterable, Union

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


def define_flag(name: str, default: Any, doc: str = "") -> None:
    """Define a flag; ``FLAGS_<name>`` in the environment overrides the
    default.  ``doc`` is for the reader of this file."""
    caster = _parse_bool if isinstance(default, bool) else type(default)
    with _lock:
        if name in _values:
            raise ValueError(f"flag {name!r} already defined")
        env = os.environ.get(f"FLAGS_{name}")
        _casters[name] = caster
        _values[name] = default if env is None else caster(env)


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
