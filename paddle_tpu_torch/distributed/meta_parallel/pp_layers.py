"""Pipeline model segmentation (the reference's
``distributed/meta_parallel/pp_layers.py``): not ported yet.  The names
import, so that model code written for the JAX package loads, and raise
``NotImplementedError`` naming ROADMAP A6c (the pipe axis and its
schedules) when one is built."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


def _waits(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: pipeline parallelism is not ported to "
                               f"paddle_tpu_torch yet (ROADMAP A6c)")


class LayerDesc:
    """A deferred layer of a :class:`PipelineLayer`: waits for A6c."""

    def __init__(self, layer_func: Callable, *inputs, **kwargs):
        raise _waits("LayerDesc")


class SharedLayerDesc(LayerDesc):
    """A layer shared across pipeline stages: waits for A6c."""

    def __init__(self, key: str, layer_func: Callable, forward_func: Optional[Callable] = None,
                 shared_weight_attr: str = "weight", *inputs, **kwargs):
        raise _waits("SharedLayerDesc")


class PipelineLayer:
    """A model cut into pipeline stages: waits for A6c."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn: Optional[Callable] = None,
                 seg_method: str = "uniform", recompute_interval: int = 0,
                 num_virtual_pipeline_stages: Optional[int] = None, **kwargs):
        raise _waits("PipelineLayer")
