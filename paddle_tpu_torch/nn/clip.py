"""Gradient clipping (port of the reference's ``nn/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm`` and
``clip_grad_norm_``.

A clip object is a callable over ``[(param, grad)]`` lists, as in the
reference, returning new gradients in the gradients' dtypes (the norms are
taken in f32).  Parameters whose ``need_clip`` attribute is False keep
their gradient, and the global norm leaves them out."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_"]

ParamsGrads = List[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _clipped(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads: ParamsGrads) -> ParamsGrads:
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads: ParamsGrads) -> ParamsGrads:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient element clamped to [min, max] (min defaults to -max)."""

    def __init__(self, max: float, min: float = None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads: ParamsGrads) -> ParamsGrads:
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / its L2 norm, 1)``."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads: ParamsGrads) -> ParamsGrads:
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                g32 = g.float()
                norm = torch.sqrt(torch.sum(torch.square(g32)))
                scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
                g = (g32 * scale).to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken over all clipped gradients in f32.  As in the
    reference, ``group_name`` is kept and ``auto_skip_clip`` has no effect."""

    def __init__(self, clip_norm: float, group_name: str = "default_group",
                 auto_skip_clip: bool = False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _dygraph_clip(self, params_grads: ParamsGrads) -> ParamsGrads:
        scale = self.global_scale(params_grads)
        if scale is None:
            return params_grads
        return [(p, self.scaled(p, g, scale)) for p, g in params_grads]

    def global_scale(self, params_grads: Iterable[Tuple[torch.Tensor, torch.Tensor]]
                     ) -> Optional[torch.Tensor]:
        """``clip_norm / max(global_norm, clip_norm)``, or None when no
        gradient is clipped.  ``params_grads`` may be a generator: each
        gradient is read once, in order, and may be dropped after."""
        terms = [g.float().square().sum() for p, g in params_grads if _clipped(p, g)]
        if not terms:
            return None
        norm = torch.sqrt(sum(terms))
        return self.clip_norm / torch.clamp(norm, min=self.clip_norm)

    @staticmethod
    def scaled(p: torch.Tensor, g: Optional[torch.Tensor],
               scale: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``g`` clipped by ``scale`` (from :meth:`global_scale`)."""
        if scale is None or not _clipped(p, g):
            return g
        return (g.float() * scale).to(g.dtype)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place by
    ``min(max_norm / total_norm, 1)``; returns the total norm (f32)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.tensor(0.0)
    if norm_type == float("inf"):
        total = torch.max(torch.stack([g.detach().abs().max().float() for g in grads]))
    else:
        total = torch.sum(torch.stack([torch.sum(g.detach().float().abs() ** norm_type)
                                       for g in grads])) ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad = (p.grad.float() * scale).to(p.grad.dtype)
    return total
