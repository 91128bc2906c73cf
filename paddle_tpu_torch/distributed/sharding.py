"""``group_sharded_parallel`` (port of the reference's
``distributed/sharding.py``; paddle's ``sharding/group_sharded.py:40``,
the ZeRO entry point).

``level`` "os" (stage 1: optimizer states), "os_g" (stage 2: and
gradients) or "p_g_os" (stage 3: and parameters) tags the model and the
optimizer with the stage that ``DistributedTrainStep`` reads; a
non-default ``buffer_max_size`` is the gradient bucket target in bytes,
else ``PADDLE_TPU_BUCKET_MB`` (default 25) decides.  ``offload=True`` tags
the optimizer so that ``DistributedTrainStep`` holds its masters and
moments in pinned host memory.  ``save_group_sharded_model`` writes the
model's and the optimizer's state dicts with ``framework.io.save``.
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
    optimizer._sharding_stage = _LEVELS[level]
    model._sharding_stage = _LEVELS[level]
    optimizer._grad_bucket_bytes = int(buffer_max_size) if buffer_max_size != 2 ** 23 \
        else grad_bucket_bytes()
    optimizer._sharding_offload = bool(offload)
    return model, optimizer, scaler


def save_group_sharded_model(model: nn.Module, output: str, optimizer=None) -> None:
    """``output + ".pdmodel"`` (the model's state dict) and, given the
    optimizer, ``output + ".pdopt"`` (its state dict, in each parameter's
    own layout), through ``framework.io.save``."""
    from ..framework.io import save

    save(model.state_dict(), output + ".pdmodel")
    if optimizer is not None:
        save(optimizer.state_dict(), output + ".pdopt")
