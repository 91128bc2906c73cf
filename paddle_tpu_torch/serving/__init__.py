"""Serving on one card (port of the reference's ``serving/``): the
continuous-batching :class:`ServingEngine` over a paged KV pool with bf16,
int8 or fp8 pages, its admission control, its SLO meter, the prefix cache,
the host-RAM offload tier and the crash-recovery journal.

    engine = ServingEngine(model, max_batch=8, kv_dtype="int8")
    rid = engine.submit(prompt_ids, max_new_tokens=64, eos_token_id=2,
                        deadline=Deadline(ttft_s=2.0, total_s=30.0))
    outputs = engine.run()          # {rid: generated token array}
    engine.meter.summary()          # ttft_ms_p99, kv_bytes_per_token, ...

Each feature is off by default and turned on by its argument or its
environment variable:

- prefix cache: ``ServingEngine(model, prefix_cache=True)`` (or an ``int``
  page budget, or a :class:`PrefixCache`), or ``PADDLE_TPU_PREFIX_CACHE=1``;
  its budget ``PADDLE_TPU_PREFIX_PAGES`` (64 pages); ``engine.prefix.
  summary()`` gives hits, misses and tokens saved;
- host-RAM KV offload: ``ServingEngine(model, offload=True)`` (or an
  ``int`` page budget, or an :class:`OffloadPool`), or
  ``PADDLE_TPU_KV_OFFLOAD=1``; its budget ``PADDLE_TPU_KV_OFFLOAD_PAGES``
  (64 pages); the meter's ``kv_offloads``, ``kv_recalls`` and
  ``kv_offload_stalls`` count its traffic;
- journal: ``ServingEngine(model, journal="/path/to/dir",
  journal_ship=ship, on_token=TokenSink("out.jsonl"))``; after a crash a
  fresh engine on the same directory calls ``engine.recover()`` then
  ``run()``; ``PADDLE_TPU_RESUME_REPORT`` names the report ``recover``
  writes.

The engine runs where the model lies: the card, or the CPU for a model
made with ``device="cpu"``.  Tensor-parallel decode is
``ServingEngine(model, tp=2)`` over ``decode_mesh``, ``shard_arenas`` and
``shard_llama_params`` (``disagg.py``).

The fleet: :class:`ServingFrontend` routes across N replicas
(:class:`Router`: least-loaded, deadline-aware spill), membership rides
heartbeat leases, every replica ships its journal to the launcher's depot
at the flush that gates emission, and a dead replica's work is fenced,
folded and replayed on the survivors with the delivered high-water marks
primed: every token reaches its client exactly once across a replica's
death (``fleet.py``).  :class:`Autoscaler` scales a ``ReplicaPool`` on
the same signals.  Disaggregated prefill: :class:`PrefillWorker` streams
a prompt's pages through the depot and :class:`DisaggCoordinator` routes
long prompts through it (``disagg.py``).

``check_decode_donation`` lints a compiled XLA program; whether the eager
port has a counterpart is ROADMAP A10's decision, and it raises naming it.
"""

from .disagg import (DisaggCoordinator, PrefillWorker,  # noqa: F401
                     decode_mesh, default_min_prompt, pack_kv_frame,
                     shard_arenas, shard_llama_params, take_prefilled,
                     unpack_kv_frame)
from .admission import (AdmissionController, CircuitBreaker, Deadline,  # noqa: F401
                        Overloaded, warming_retry_hint)
from .engine import Request, ServingEngine  # noqa: F401
from .journal import JournalState, ServingJournal, TokenSink  # noqa: F401
from .kv_pool import (OffloadPool, PagedKVPool, PoolExhausted,  # noqa: F401
                      TRASH_PAGE, default_offload_pages, default_page_tokens)
from .kv_quant import (DTYPE_BYTES, FP8_MAX, KV_DTYPES,  # noqa: F401
                       default_fp8_scale, dequantize_kv, dequantize_kv_fp8,
                       kv_cache_dtype, kv_page_bytes, kv_scale_page_bytes,
                       observe_kv_absmax, quantize_kv, quantize_kv_fp8)
from .metrics import FleetMeter, RequestClock, SLOMeter  # noqa: F401
from .prefix_cache import PrefixCache, default_prefix_pages  # noqa: F401
from .router import ReplicaStatus, Router  # noqa: F401
from .fleet import (EngineReplica, LocalKV, RemoteReplica,  # noqa: F401
                    ReplicaFlags, ReplicaServer, ServingFrontend,
                    TokenCollector, fold_depot_journal, run_replica)
from .autoscaler import Autoscaler, AutoscalePolicy, FleetSignals  # noqa: F401

__all__ = [
    "PagedKVPool", "OffloadPool", "PoolExhausted", "TRASH_PAGE",
    "default_page_tokens", "default_offload_pages",
    "KV_DTYPES", "kv_cache_dtype", "quantize_kv", "dequantize_kv",
    "quantize_kv_fp8", "dequantize_kv_fp8", "default_fp8_scale", "FP8_MAX",
    "DTYPE_BYTES", "observe_kv_absmax", "kv_page_bytes", "kv_scale_page_bytes",
    "RequestClock", "SLOMeter", "FleetMeter", "PrefixCache", "default_prefix_pages",
    "ServingJournal", "JournalState", "TokenSink",
    "AdmissionController", "CircuitBreaker", "Deadline", "Overloaded",
    "warming_retry_hint", "Request", "ServingEngine", "decode_mesh", "shard_arenas",
    "shard_llama_params", "ReplicaStatus", "Router",
    "EngineReplica", "LocalKV", "RemoteReplica", "ReplicaFlags",
    "ReplicaServer", "ServingFrontend", "TokenCollector",
    "fold_depot_journal", "run_replica",
    "Autoscaler", "AutoscalePolicy", "FleetSignals",
    "DisaggCoordinator", "PrefillWorker", "default_min_prompt",
    "pack_kv_frame", "unpack_kv_frame", "take_prefilled",
]

# the reference's export that lints a compiled XLA program (ROADMAP A10)
_UNPORTED = frozenset({"check_decode_donation"})


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"serving.{name} lints a compiled XLA decode program for donation; whether "
            "the eager port has a counterpart is decided with ROADMAP A10 (compile/ and "
            "analysis/)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
