"""Pipeline model segmentation (port of the reference's
``distributed/meta_parallel/pp_layers.py``; paddle's
``parallel_layers/pp_layers.py``: ``PipelineLayer``:237, ``LayerDesc``:56,
``SharedLayerDesc``:76).

A :class:`PipelineLayer` is built from a flat list of layer descriptors
(a :class:`LayerDesc`, a module, or a callable) and cut into ``num_stages``
x ``num_virtual_pipeline_stages`` contiguous segments; every stage stays
built in the one process, and ``get_stage_layers`` / ``get_chunk_layers``
give a stage's (or a virtual chunk's) layers to the pipeline runtimes.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

from torch import nn

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    """A layer built later: ``layer_func(*inputs, **kwargs)``."""

    def __init__(self, layer_func: Callable, *inputs, **kwargs):
        if not callable(layer_func):
            raise TypeError("layer_func must be a Module subclass or callable")
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self) -> nn.Module:
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({getattr(self.layer_func, '__name__', self.layer_func)})"


class SharedLayerDesc(LayerDesc):
    """A layer shared across stages (tied embeddings): every occurrence of
    one ``key`` is the same built layer, so the tied weight is one
    parameter and its gradient sums every use (the reference's
    ``allreduce_shared_weight_gradients`` falls out of autograd).
    ``forward_func(layer, *args)`` replaces the layer's forward at an
    occurrence."""

    def __init__(self, key: str, layer_func: Callable, forward_func: Optional[Callable] = None,
                 shared_weight_attr: str = "weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _SharedLayerProxy(nn.Module):
    def __init__(self, inner: nn.Module, forward_func: Optional[Callable]):
        super().__init__()
        self.shared = inner
        self._forward_func = forward_func

    def forward(self, *args, **kwargs):
        if self._forward_func is not None:
            return self._forward_func(self.shared, *args, **kwargs)
        return self.shared(*args, **kwargs)


class _FnLayer(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def _call(layer, x):
    return layer(*x) if isinstance(x, tuple) else layer(x)


class PipelineLayer(nn.Module):
    """``layers`` cut into stages.  ``num_stages`` defaults to the hybrid
    group's pipe degree; ``seg_method`` is ``"uniform"`` (equal layer
    counts, the remainder to the first segments) or ``"layer:<regex>"``
    (cut before every k-th layer whose class name matches);
    ``num_virtual_pipeline_stages`` v > 1 gives stage s the segments s, s +
    P, ... (chunk c = segment c·P + s).  ``loss_fn(output, label)`` is the
    runtimes' loss."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn: Optional[Callable] = None,
                 seg_method: str = "uniform", recompute_interval: int = 0,
                 num_virtual_pipeline_stages: Optional[int] = None, **kwargs):
        super().__init__()
        from ..topology import get_hybrid_communicate_group

        if num_stages is None:
            hcg = get_hybrid_communicate_group()
            num_stages = hcg.get_pipe_parallel_world_size() if hcg else 1
        self._num_stages = num_stages
        self._num_virtual_pipeline_stages = num_virtual_pipeline_stages or 1
        self._loss_fn = loss_fn
        self._seg_method = seg_method
        self._shared: Dict[str, nn.Module] = {}
        built: List[nn.Module] = []
        self._desc_names: List[str] = []
        for item in layers:
            if isinstance(item, SharedLayerDesc):
                if item.layer_name not in self._shared:
                    self._shared[item.layer_name] = item.build_layer()
                built.append(_SharedLayerProxy(self._shared[item.layer_name],
                                               item.forward_func))
                self._desc_names.append(item.layer_name)
            elif isinstance(item, LayerDesc):
                built.append(item.build_layer())
                self._desc_names.append(type(built[-1]).__name__)
            elif isinstance(item, nn.Module):
                built.append(item)
                self._desc_names.append(type(item).__name__)
            elif callable(item):
                built.append(_FnLayer(item))
                self._desc_names.append(getattr(item, "__name__", "fn"))
            else:
                raise TypeError(f"unsupported pipeline item: {item!r}")
        self.run_function = nn.ModuleList(built)
        self._segment()

    def _segment(self) -> None:
        n = len(self.run_function)
        stages = self._num_stages * self._num_virtual_pipeline_stages
        if self._seg_method.startswith("layer:"):
            pattern = self._seg_method.split("layer:", 1)[1]
            idxs = [i for i, name in enumerate(self._desc_names) if re.search(pattern, name)]
            if len(idxs) < stages:
                raise ValueError(f"seg_method {self._seg_method}: found {len(idxs)} cut "
                                 f"layers for {stages} stages")
            per = len(idxs) // stages
            bounds = [0] + [idxs[s * per] for s in range(1, stages)] + [n]
        else:
            per, rem = divmod(n, stages)
            bounds = [0]
            for s in range(stages):
                bounds.append(bounds[-1] + per + (1 if s < rem else 0))
        self.segment_parts = bounds

    def get_stage_layers(self, stage_id: int) -> List[nn.Module]:
        if self._num_virtual_pipeline_stages > 1:
            raise RuntimeError(
                "with num_virtual_pipeline_stages > 1 a stage's layers are "
                "non-contiguous chunks: use get_chunk_layers(stage, chunk) / "
                "chunk_forward (PipelineParallelWithInterleave drives these)")
        lo, hi = self.segment_parts[stage_id], self.segment_parts[stage_id + 1]
        return list(self.run_function)[lo:hi]

    def get_chunk_layers(self, stage_id: int, chunk_id: int) -> List[nn.Module]:
        """Virtual chunk ``chunk_id`` of ``stage_id``: segment c·P + s."""
        seg = chunk_id * self._num_stages + stage_id
        lo, hi = self.segment_parts[seg], self.segment_parts[seg + 1]
        return list(self.run_function)[lo:hi]

    def chunk_forward(self, stage_id: int, chunk_id: int, x):
        for layer in self.get_chunk_layers(stage_id, chunk_id):
            x = _call(layer, x)
        return x

    def stage_forward(self, stage_id: int, x):
        for layer in self.get_stage_layers(stage_id):
            x = _call(layer, x)
        return x

    def forward(self, x):
        for layer in self.run_function:
            x = _call(layer, x)
        return x

    @property
    def num_stages(self) -> int:
        return self._num_stages

    def shared_layers(self) -> Dict[str, nn.Module]:
        return dict(self._shared)
