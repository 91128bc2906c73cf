"""Gradient clipping by the global norm (port of the reference's
``nn/clip.py`` ``ClipGradByGlobalNorm``).

A clip object is a callable over ``[(param, grad)]`` lists, as in the
reference.  Parameters whose ``need_clip`` attribute is False are left
out of the norm and keep their gradient."""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken over all clipped gradients in f32."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads: List[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        clipped = [g for p, g in params_grads
                   if g is not None and getattr(p, "need_clip", True)]
        if not clipped:
            return params_grads
        norm = torch.sqrt(sum(g.float().square().sum() for g in clipped))
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [(p, g if g is None or not getattr(p, "need_clip", True)
                 else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]
