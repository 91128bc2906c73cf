"""``group_sharded_parallel`` (port of the reference's
``distributed/sharding.py``; paddle's ``sharding/group_sharded.py:40``,
the ZeRO entry point).

``level`` "os" (stage 1: optimizer states), "os_g" (stage 2: and
gradients) or "p_g_os" (stage 3: and parameters) tags the model and the
optimizer with the stage that ``DistributedTrainStep`` reads; a
non-default ``buffer_max_size`` is the gradient bucket target in bytes,
else ``PADDLE_TPU_BUCKET_MB`` (default 25) decides.  ``offload=True``
(states in pinned host memory) waits for ROADMAP A6c2 and raises, and
``save_group_sharded_model`` waits for A3 (``framework.io.save``).
"""

from __future__ import annotations

from typing import Tuple

from torch import nn

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model: nn.Module, optimizer, level: str, scaler=None,
                           group=None, offload: bool = False, sync_buffers: bool = False,
                           buffer_max_size: int = 2 ** 23, segment_size: int = 2 ** 20,
                           sync_comm: bool = False, dp_group=None,
                           exclude_layer=None) -> Tuple:
    """Tag ``model`` and ``optimizer`` with ``level``'s ZeRO stage and the
    bucket target; returns (model, optimizer, scaler)."""
    from .overlap import grad_bucket_bytes

    if level not in _LEVELS:
        raise ValueError(f"level must be one of {sorted(_LEVELS)}, got {level!r}")
    if offload:
        raise NotImplementedError(
            "group_sharded_parallel offload=True (optimizer states in pinned host "
            "memory) is not ported yet (ROADMAP A6c2); the reference keeps them in "
            "device memory where it cannot place them on the host")
    optimizer._sharding_stage = _LEVELS[level]
    model._sharding_stage = _LEVELS[level]
    optimizer._grad_bucket_bytes = int(buffer_max_size) if buffer_max_size != 2 ** 23 \
        else grad_bucket_bytes()
    optimizer._sharding_offload = False
    return model, optimizer, scaler


def save_group_sharded_model(model: nn.Module, output: str, optimizer=None) -> None:
    """Waits for ROADMAP A3 (``framework.io.save``)."""
    raise NotImplementedError(
        "save_group_sharded_model needs framework.io.save, which is not ported yet "
        "(ROADMAP A3); save model.state_dict() with torch.save meanwhile")
