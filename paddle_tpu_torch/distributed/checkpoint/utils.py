"""Shared helpers: state_dict flattening, slice overlaps, and tensors to and
from host arrays (port of the reference's ``distributed/checkpoint/utils.py``
with its ``compute_overlap``).

numpy has no bfloat16 of its own.  A bf16 tensor therefore goes to the host
as its raw 16-bit patterns: an ``ml_dtypes.bfloat16`` array where that
package is installed (the array the reference saves, so its loader reads
the port's shards), else ``uint16``; the metadata names the dtype
``bfloat16`` either way, and :func:`from_host` reads both forms.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["flatten_state_dict", "unflatten_key", "compute_overlap",
           "tensor_value", "shard_offsets", "to_host", "from_host", "dtype_name"]


def tensor_value(t):
    """A tensor's value as the checkpoint takes it: the tensor itself."""
    return getattr(t, "_value", t)


def flatten_state_dict(state_dict, prefix: Tuple[str, ...] = ()):
    """Nested dicts / lists / tuples → {flat_key: leaf} + {flat_key:
    key_path}.  Sequence elements are indexed positionally."""
    flat: Dict[str, Any] = {}
    mapping: Dict[str, Tuple[str, ...]] = {}
    items = state_dict.items() if isinstance(state_dict, dict) else enumerate(state_dict)
    for k, v in items:
        path = prefix + (str(k),)
        if isinstance(v, (dict, list, tuple)):
            sub_flat, sub_map = flatten_state_dict(v, path)
            flat.update(sub_flat)
            mapping.update(sub_map)
        else:
            key = ".".join(path)
            flat[key] = v
            mapping[key] = path
    return flat, mapping


def unflatten_key(target, path: Tuple[str, ...], value) -> None:
    d = target
    for p in path[:-1]:
        d = d[int(p)] if isinstance(d, (list, tuple)) else d.setdefault(p, {})
    if isinstance(d, list):
        d[int(path[-1])] = value
    elif isinstance(d, tuple):
        raise TypeError(
            f"cannot write scalar leaf back into a tuple at {'.'.join(path)}; "
            "use a list in the target state_dict")
    else:
        d[path[-1]] = value


def compute_overlap(saved_offset, saved_shape, want_offset, want_shape
                    ) -> Optional[Tuple[Tuple[slice, ...], Tuple[slice, ...]]]:
    """Intersection of a saved shard and a wanted shard, both in global
    coordinates: (slices into the saved array, slices into the wanted
    array), or None when disjoint."""
    src_slices, dst_slices = [], []
    for so, sl, wo, wl in zip(saved_offset, saved_shape, want_offset, want_shape):
        lo = max(so, wo)
        hi = min(so + sl, wo + wl)
        if hi <= lo:
            return None
        src_slices.append(slice(lo - so, hi - so))
        dst_slices.append(slice(lo - wo, hi - wo))
    return tuple(src_slices), tuple(dst_slices)


def shard_offsets(index, shape) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """A shard's index (a tuple of slices) → (global_offset, local_shape)."""
    offset, local = [], []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        offset.append(start)
        local.append(stop - start)
    return tuple(offset), tuple(local)


def dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype (``bfloat16`` for bf16)."""
    return str(t.dtype).replace("torch.", "")


def _bf16_np():
    try:
        import ml_dtypes
    except ImportError:
        return None
    return ml_dtypes.bfloat16


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (bf16 as its bit patterns): one copy,
    never a view of ``t``'s own memory."""
    t = t.detach()
    bf16 = t.dtype == torch.bfloat16
    src = t.contiguous().view(torch.int16) if bf16 else t
    h = src.cpu()
    if h.data_ptr() == src.data_ptr():      # a CPU tensor: .cpu() is itself
        h = h.clone()
    if not bf16:
        return h.numpy()
    bits = h.numpy().view(np.uint16)
    np_bf16 = _bf16_np()
    return bits if np_bf16 is None else bits.view(np_bf16)


def from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host array saved with dtype name ``dtype`` as a CPU tensor."""
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))   # keeps a 0-d array 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy() if not arr.flags.writeable else arr)


def host_empty(shape, dtype: str) -> np.ndarray:
    """An empty host array to assemble ``dtype`` shards into."""
    return np.empty(shape, np.uint16 if dtype == "bfloat16" else np.dtype(dtype))


def host_bits(arr: np.ndarray, dtype: str) -> np.ndarray:
    """A saved piece as :func:`host_empty`'s dtype (bf16 as uint16 bits)."""
    return np.asarray(arr).view(np.uint16) if dtype == "bfloat16" else np.asarray(arr)


def fp_array(arr: np.ndarray, dtype: str) -> np.ndarray:
    """What a shard's value fingerprint is taken over: a bf16 shard's raw
    bytes (as the reference takes them), any other shard's values."""
    return np.ascontiguousarray(arr).view(np.uint8) if dtype == "bfloat16" else arr


def mark_local_shard(t: torch.Tensor, global_offset, global_shape) -> torch.Tensor:
    """Tag ``t`` as this process's block of a larger tensor, at
    ``global_offset`` within ``global_shape``: ``save_state_dict`` writes it
    at that offset and ``load_state_dict`` fills it from whatever saved
    blocks overlap it.  An untagged tensor is whole (offset 0), as every
    tensor of a single-controller mesh is.  Returns ``t``."""
    t._ckpt_global = (tuple(int(o) for o in global_offset),
                      tuple(int(s) for s in global_shape))
    return t


def global_place(t: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(global offset, global shape) of a tensor leaf."""
    tag = getattr(t, "_ckpt_global", None)
    if tag is not None:
        return tag
    return (0,) * t.dim(), tuple(t.shape)
