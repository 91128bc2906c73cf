"""Pipeline-parallel runtimes (the reference's
``distributed/meta_parallel/pipeline_parallel.py``): not ported yet.  The
names import and raise ``NotImplementedError`` naming ROADMAP A6c when
one is built."""

from __future__ import annotations

from typing import Optional

from .pp_layers import _waits

__all__ = ["PipelineParallel", "PipelineParallelWithInterleave"]


class PipelineParallel:
    """The 1F1B micro-batch schedule over a ``PipelineLayer``: waits for A6c."""

    def __init__(self, layers, hcg=None, strategy=None,
                 accumulate_steps: Optional[int] = None):
        raise _waits(type(self).__name__)


class PipelineParallelWithInterleave(PipelineParallel):
    """The interleaved (virtual-stage) schedule: waits for A6c."""
