"""Gradient clipping by the global norm (port of the reference's
``nn/clip.py`` ``ClipGradByGlobalNorm``).

A clip object is a callable over ``[(param, grad)]`` lists, as in the
reference.  Parameters whose ``need_clip`` attribute is False are left
out of the norm and keep their gradient."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken over all clipped gradients in f32.  As in the
    reference, ``group_name`` is kept and ``auto_skip_clip`` has no effect."""

    def __init__(self, clip_norm: float, group_name: str = "default_group",
                 auto_skip_clip: bool = False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads: List[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        scale = self.global_scale(params_grads)
        if scale is None:
            return params_grads
        return [(p, self.scaled(p, g, scale)) for p, g in params_grads]

    def global_scale(self, params_grads: Iterable[Tuple[torch.Tensor, torch.Tensor]]
                     ) -> Optional[torch.Tensor]:
        """``clip_norm / max(global_norm, clip_norm)``, or None when no
        gradient is clipped.  ``params_grads`` may be a generator: each
        gradient is read once, in order, and may be dropped after."""
        terms = [g.float().square().sum() for p, g in params_grads
                 if g is not None and getattr(p, "need_clip", True)]
        if not terms:
            return None
        norm = torch.sqrt(sum(terms))
        return self.clip_norm / torch.clamp(norm, min=self.clip_norm)

    @staticmethod
    def scaled(p: torch.Tensor, g: Optional[torch.Tensor],
               scale: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``g`` clipped by ``scale`` (from :meth:`global_scale`)."""
        if g is None or scale is None or not getattr(p, "need_clip", True):
            return g
        return (g.float() * scale).to(g.dtype)
