"""fleet.utils ``recompute`` (port of the reference's
``distributed/fleet_utils.py``): the activations inside the wrapped call
are not kept for the backward pass but recomputed there, trading device
memory for a second forward.  The reference wraps ``jax.checkpoint``; the
port wraps ``torch.utils.checkpoint`` in its non-reentrant form, which
takes keyword arguments and non-tensor positionals as they are."""

from __future__ import annotations

from typing import Callable

import torch.utils.checkpoint

__all__ = ["recompute"]


def recompute(function: Callable, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward pass; ``function`` may be a module, whose parameters get
    their gradients as usual."""
    return torch.utils.checkpoint.checkpoint(function, *args, use_reentrant=False,
                                             **kwargs)
