"""Carry weights from the JAX package's models into the port's.

The two packages share parameter names and layouts (paddle ``[in, out]``
Linear weights), so a state dict crosses as numpy arrays::

    arrays = {k: np.asarray(v.numpy()) for k, v in jax_model.state_dict().items()}
    load_numpy_state_dict(torch_model, arrays)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["load_numpy_state_dict"]


def load_numpy_state_dict(model: torch.nn.Module,
                          arrays: Dict[str, np.ndarray]) -> None:
    """Copy ``arrays`` into ``model``'s parameters and persistent buffers,
    cast to each one's dtype and device.  Raises KeyError on a missing or
    unexpected name and ValueError on a shape mismatch.  The non-persistent
    buffers (the rope tables) are not loaded: where ``arrays`` carries one,
    it is checked against the model's own."""
    targets = model.state_dict()
    extra = dict(model.named_buffers())
    unexpected = sorted(k for k in arrays if k not in targets and k not in extra)
    missing = sorted(k for k in targets if k not in arrays)
    if unexpected or missing:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        ref = targets.get(name, extra.get(name))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != model's "
                             f"{tuple(ref.shape)}")
        # floats (bf16 from ml_dtypes included) cross as f32, then cast
        src = torch.from_numpy(np.array(arr) if arr.dtype.kind in "biu"
                               else np.array(arr, dtype=np.float32))
        if name not in targets:
            if not torch.allclose(src.to(ref.device, ref.dtype), ref,
                                  rtol=1e-6, atol=1e-6):
                raise ValueError(f"{name}: differs from the model's own table")
            continue
        with torch.no_grad():
            ref.copy_(src.to(device=ref.device, dtype=ref.dtype))
