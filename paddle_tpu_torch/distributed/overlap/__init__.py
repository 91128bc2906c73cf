"""paddle_tpu_torch.distributed.overlap: hiding communication under
computation (port of the reference's ``distributed/overlap/``).

- :mod:`.collective_matmul`: the ring-decomposed ``all_gather_matmul`` /
  ``matmul_reduce_scatter`` (and their sequence-parallel forms) with
  mirrored-ring backwards, taken by the tensor-parallel layers behind
  ``PADDLE_TPU_TP_OVERLAP`` (on by default at model degree 2 and up);
- :mod:`.bucketer`: size-targeted, reverse-topological gradient buckets
  (``PADDLE_TPU_BUCKET_MB``) for the sharded-optimizer stages;
- :mod:`.measure`: the measured overlap fraction from a Chrome trace (what
  ``torch.profiler`` exports) and the analytic bound.

The reference's ``xla_flags`` (XLA's latency-hiding scheduler flags) has no
counterpart: the port compiles no XLA program, so there is no flag to set.
:func:`overlap_fingerprint` says so by leaving its key out.
"""

from .bucketer import DEFAULT_BUCKET_MB, GradientBucketer, grad_bucket_bytes  # noqa: F401
from .collective_matmul import (MODEL_AXIS, all_gather_matmul,  # noqa: F401
                                all_gather_matmul_seq, matmul_reduce_scatter,
                                matmul_reduce_scatter_seq, overlap_min_rows,
                                should_decompose, should_decompose_seq,
                                tp_overlap_enabled)
from .measure import hidden_comm_seconds, overlap_fraction_from_trace  # noqa: F401

__all__ = [
    "all_gather_matmul", "matmul_reduce_scatter", "should_decompose",
    "all_gather_matmul_seq", "matmul_reduce_scatter_seq",
    "should_decompose_seq",
    "tp_overlap_enabled", "overlap_min_rows", "MODEL_AXIS",
    "GradientBucketer", "grad_bucket_bytes", "DEFAULT_BUCKET_MB",
    "overlap_fraction_from_trace", "hidden_comm_seconds",
    "overlap_fingerprint",
]


def overlap_fingerprint() -> dict:
    """The overlap configuration as key material (the reference folds it
    into its compiled-program fingerprint): the ring switch, its row
    threshold and the bucket target.  The reference's ``xla_flags`` key is
    left out: no XLA flag exists here (module docstring)."""
    return {
        "tp_overlap": bool(tp_overlap_enabled()),
        "min_rows": int(overlap_min_rows()),
        "bucket_bytes": int(grad_bucket_bytes()),
    }
