"""Serving on one card (port of the reference's ``serving/``): the
continuous-batching :class:`ServingEngine` over a paged KV pool with bf16,
int8 or fp8 pages, its admission control and its SLO meter.

    engine = ServingEngine(model, max_batch=8, kv_dtype="int8")
    rid = engine.submit(prompt_ids, max_new_tokens=64, eos_token_id=2,
                        deadline=Deadline(ttft_s=2.0, total_s=30.0))
    outputs = engine.run()          # {rid: generated token array}
    engine.meter.summary()          # ttft_ms_p99, kv_bytes_per_token, ...

The engine runs where the model lies: the card, or the CPU for a model
made with ``device="cpu"``.  The journal, the fleet, the router, the
autoscaler, the prefix cache, disaggregated prefill and the offload tier
are not ported yet (ROADMAP A1, A8).
"""

from .admission import (AdmissionController, CircuitBreaker, Deadline,  # noqa: F401
                        Overloaded, warming_retry_hint)
from .engine import Request, ServingEngine  # noqa: F401
from .kv_pool import (PagedKVPool, PoolExhausted, TRASH_PAGE,  # noqa: F401
                      default_page_tokens)
from .kv_quant import (DTYPE_BYTES, FP8_MAX, KV_DTYPES,  # noqa: F401
                       default_fp8_scale, dequantize_kv, dequantize_kv_fp8,
                       kv_cache_dtype, kv_page_bytes, kv_scale_page_bytes,
                       observe_kv_absmax, quantize_kv, quantize_kv_fp8)
from .metrics import RequestClock, SLOMeter  # noqa: F401

__all__ = [
    "PagedKVPool", "PoolExhausted", "TRASH_PAGE", "default_page_tokens",
    "KV_DTYPES", "kv_cache_dtype", "quantize_kv", "dequantize_kv",
    "quantize_kv_fp8", "dequantize_kv_fp8", "default_fp8_scale", "FP8_MAX",
    "DTYPE_BYTES", "observe_kv_absmax", "kv_page_bytes", "kv_scale_page_bytes",
    "RequestClock", "SLOMeter",
    "AdmissionController", "CircuitBreaker", "Deadline", "Overloaded",
    "warming_retry_hint", "Request", "ServingEngine",
]
