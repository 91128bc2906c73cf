"""The global random state (the part of the reference's
``framework/random.py`` that ``Layer`` reads; its key scopes and state
helpers wait for ROADMAP A3c).

The reference splits JAX PRNG keys from one global generator seeded by
``paddle.seed``.  The port's global generators are torch's own, one a
device (``torch.default_generator`` on the CPU, each card's default CUDA
generator), so :func:`seed` is ``torch.manual_seed``, offset by the
process rank when ``seed_offset_by_rank`` is on, and a draw given no
generator takes the generator of the device it draws on.  JAX's and
torch's bits differ, so a seed fixes the port's draws, not the
reference's: weights cross between the packages through ``convert.py``.
"""

from __future__ import annotations

import torch

from .flags import get_flags

__all__ = ["seed"]


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def seed(value: int) -> torch.Generator:
    """Seed every device's global generator (``paddle.seed``).  Returns
    the CPU's."""
    offset = _rank() if get_flags("seed_offset_by_rank")["seed_offset_by_rank"] else 0
    return torch.manual_seed(int(value) + offset)
