"""Hybrid-parallel building blocks (port of the reference's
``distributed/meta_parallel/``): the tensor-parallel layers, sequence
parallelism, and context parallelism (ring attention and Ulysses).  The
pipeline names import and raise naming ROADMAP A6c."""

from .context_parallel import ring_attention, ulysses_attention  # noqa: F401
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa: F401
                        RowParallelLinear, VocabParallelEmbedding)
from .pipeline_parallel import PipelineParallel, PipelineParallelWithInterleave  # noqa: F401
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .sequence_parallel import (AllGatherOp, ColumnSequenceParallelLinear, GatherOp,  # noqa: F401
                                ReduceScatterOp, RowSequenceParallelLinear, ScatterOp,
                                is_sequence_parallel_parameter,
                                mark_as_sequence_parallel_parameter,
                                register_sequence_parallel_allreduce_hooks,
                                sequence_parallel_enabled, sp_fingerprint)
