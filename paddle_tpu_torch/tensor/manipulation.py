"""Shape and layout functions (port of the reference's
``tensor/manipulation.py``).

The in-place forms (``reshape_``, ``squeeze_``, ``unsqueeze_``,
``scatter_``) mutate their argument and return it, and autograd stays right,
as the reference's ``_rebind`` keeps it: a shape change of a tensor in a
graph is torch's in-place ``as_strided_`` (of one outside a graph, a
storage rebind), and ``scatter_`` copies the scattered result in, which
autograd records.  A leaf that requires grad refuses, as in the reference.
"""

from __future__ import annotations

import builtins
from typing import Sequence

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ._op_utils import ensure_tensor, nondiff  # noqa: F401
from .tensor import apply_op

__all__ = [
    "reshape", "reshape_", "flatten", "transpose", "moveaxis", "swapaxes", "squeeze",
    "unsqueeze", "squeeze_", "unsqueeze_", "concat", "stack", "split", "chunk", "unbind",
    "unstack", "tile", "expand", "expand_as", "broadcast_to", "broadcast_tensors",
    "broadcast_shape", "flip", "rot90", "roll", "gather", "gather_nd", "scatter", "scatter_",
    "scatter_nd_add", "scatter_nd", "index_select", "index_sample", "index_add", "index_put",
    "take_along_axis", "put_along_axis", "masked_select", "masked_fill", "slice",
    "strided_slice", "repeat_interleave", "cast", "pad", "crop", "unique",
    "unique_consecutive", "as_strided", "view", "tensordot",
]


def _int(v) -> int:
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _shape_arg(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(_int(s) for s in shape)


def _index(index, device) -> torch.Tensor:
    t = index if isinstance(index, torch.Tensor) else torch.as_tensor(np.asarray(index))
    return t.to(device=device, dtype=torch.long)


def reshape(x, shape, name=None):
    x = ensure_tensor(x)
    s = _shape_arg(shape)
    return apply_op("reshape", lambda v: v.reshape(s), (x,))


def _inplace_shape(x: torch.Tensor, new_shape) -> torch.Tensor:
    """``x`` given ``new_shape`` in place (same elements, row-major), kept
    in its graph: torch's in-place ``as_strided_`` where ``x`` requires
    grad, a storage rebind where it does not."""
    if x.requires_grad and x.is_leaf:
        raise RuntimeError("a leaf tensor that requires grad cannot be changed in place; "
                           "use `with no_grad():` or the out-of-place function")
    new_shape = tuple(new_shape)
    strides = torch.empty(new_shape, device="meta").stride()
    if x.requires_grad:
        if not x.is_contiguous():
            raise RuntimeError("in-place reshape of a non-contiguous tensor that requires "
                               "grad: use the out-of-place function")
        return x.as_strided_(new_shape, strides, x.storage_offset())
    with torch.no_grad():
        return x.set_(x.contiguous().view(new_shape))


def reshape_(x, shape, name=None):
    return _inplace_shape(x, reshape(x, shape).shape)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = ensure_tensor(x)
    if x.dim() == 0:
        return apply_op("flatten", lambda v: v.reshape(1), (x,))
    return apply_op("flatten", lambda v: torch.flatten(v, start_axis, stop_axis), (x,))


def transpose(x, perm=None, name=None):
    x = ensure_tensor(x)
    p = tuple(range(x.dim() - 1, -1, -1)) if perm is None else tuple(int(i) for i in perm)
    return apply_op("transpose", lambda v: v.permute(*p), (x,))


def moveaxis(x, source, destination, name=None):
    x = ensure_tensor(x)
    return apply_op("moveaxis", lambda v: torch.movedim(v, source, destination), (x,))


def swapaxes(x, axis0, axis1, name=None):
    x = ensure_tensor(x)
    return apply_op("swapaxes", lambda v: torch.swapaxes(v, axis0, axis1), (x,))


def _squeeze_dims(v, axis):
    if axis is None:
        return tuple(d for d in range(v.dim()) if v.shape[d] == 1)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return tuple(a % v.dim() for a in (_int(a) for a in axes) if v.shape[a % v.dim()] == 1)


def squeeze(x, axis=None, name=None):
    x = ensure_tensor(x)
    dims = _squeeze_dims(x, axis)
    return apply_op("squeeze", lambda v: torch.squeeze(v, dims) if dims else v.view_as(v),
                    (x,))


def unsqueeze(x, axis, name=None):
    x = ensure_tensor(x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = [_int(a) for a in axes]
    nd = x.dim() + len(axes)
    axes = sorted(a % nd for a in axes)

    def fn(v):
        for a in axes:
            v = v.unsqueeze(a)
        return v

    return apply_op("unsqueeze", fn, (x,))


def squeeze_(x, axis=None, name=None):
    return _inplace_shape(x, squeeze(x, axis).shape)


def unsqueeze_(x, axis, name=None):
    return _inplace_shape(x, unsqueeze(x, axis).shape)


def concat(x: Sequence, axis=0, name=None):
    ts = [ensure_tensor(t) for t in x]
    ax = _int(axis)
    return apply_op("concat", lambda *vs: torch.cat(vs, ax), tuple(ts))


def stack(x: Sequence, axis=0, name=None):
    ts = [ensure_tensor(t) for t in x]
    return apply_op("stack", lambda *vs: torch.stack(vs, axis), tuple(ts))


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` equal parts, or parts of the given sizes (one
    of them may be -1: the rest)."""
    x = ensure_tensor(x)
    ax = _int(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: axis {ax} size {dim} is not divisible by {num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = [_int(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(sections) if s < 0]
        if neg:
            sections[neg[0]] = dim - builtins.sum(s for s in sections if s >= 0)
    return list(apply_op("split", lambda v: torch.split(v, sections, ax), (x,),
                         multi_out=True))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    x = ensure_tensor(x)
    return list(apply_op("unbind", lambda v: torch.unbind(v, axis), (x,), multi_out=True))


unstack = unbind


def tile(x, repeat_times, name=None):
    x = ensure_tensor(x)
    reps = _shape_arg(repeat_times)
    return apply_op("tile", lambda v: torch.tile(v, reps), (x,))


def expand(x, shape, name=None):
    x = ensure_tensor(x)
    s = _shape_arg(shape)
    return apply_op("expand", lambda v: v.expand(*s), (x,))


def expand_as(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    tgt = tuple(y.shape)
    return apply_op("expand_as", lambda v: v.expand(*tgt), (x,))


def broadcast_to(x, shape, name=None):
    x = ensure_tensor(x)
    s = _shape_arg(shape)
    return apply_op("broadcast_to", lambda v: torch.broadcast_to(v, s), (x,))


def broadcast_tensors(inputs, name=None):
    ts = [ensure_tensor(t) for t in inputs]
    return list(apply_op("broadcast_tensors", lambda *vs: torch.broadcast_tensors(*vs),
                         tuple(ts), multi_out=True))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def _axes(axis):
    return [axis] if isinstance(axis, int) else list(axis)


def flip(x, axis, name=None):
    x = ensure_tensor(x)
    return apply_op("flip", lambda v: torch.flip(v, _axes(axis)), (x,))


def rot90(x, k=1, axes=(0, 1), name=None):
    x = ensure_tensor(x)
    return apply_op("rot90", lambda v: torch.rot90(v, k, list(axes)), (x,))


def roll(x, shifts, axis=None, name=None):
    x = ensure_tensor(x)
    return apply_op("roll", lambda v: torch.roll(v, shifts, axis), (x,))


def gather(x, index, axis=0, name=None):
    """Slices of ``x`` along ``axis`` at ``index`` (flattened)."""
    x = ensure_tensor(x)
    idx = _index(index, x.device).reshape(-1)
    ax = _int(axis)
    return apply_op("gather", lambda v: torch.index_select(v, ax, idx), (x,))


def _nd(idx: torch.Tensor):
    return tuple(idx.movedim(-1, 0))


def gather_nd(x, index, name=None):
    x = ensure_tensor(x)
    idx = _index(index, x.device)
    return apply_op("gather_nd", lambda v: v[_nd(idx)], (x,))


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of ``x`` at ``index`` set to ``updates`` (``overwrite``), or set
    to the sum of the updates aimed at them."""
    x, updates = ensure_tensor(x), ensure_tensor(updates)
    idx = _index(index, x.device).reshape(-1)

    def fn(v, u):
        u = u.to(v.dtype)
        if overwrite:
            return v.index_put((idx,), u)
        return v.index_put((idx,), torch.zeros_like(u)).index_put((idx,), u, accumulate=True)

    return apply_op("scatter", fn, (x, updates))


def scatter_(x, index, updates, overwrite=True, name=None):
    new = scatter(x, index, updates, overwrite)
    if x.requires_grad and x.is_leaf:
        raise RuntimeError("a leaf tensor that requires grad cannot be changed in place; "
                           "use `with no_grad():` or scatter()")
    return x.copy_(new)


def scatter_nd_add(x, index, updates, name=None):
    x, updates = ensure_tensor(x), ensure_tensor(updates)
    idx = _index(index, x.device)
    return apply_op("scatter_nd_add",
                    lambda v, u: v.index_put(_nd(idx), u.to(v.dtype), accumulate=True),
                    (x, updates))


def scatter_nd(index, updates, shape, name=None):
    updates = ensure_tensor(updates)
    idx = _index(index, updates.device)
    s = _shape_arg(shape)
    return apply_op("scatter_nd", lambda u: torch.zeros(s, dtype=u.dtype, device=u.device)
                    .index_put(_nd(idx), u, accumulate=True), (updates,))


def index_select(x, index, axis=0, name=None):
    x = ensure_tensor(x)
    idx = _index(index, x.device)
    return apply_op("index_select", lambda v: torch.index_select(v, axis, idx.reshape(-1))
                    .reshape(*v.shape[:axis % v.dim()], *idx.shape,
                             *v.shape[axis % v.dim() + 1:]), (x,))


def index_sample(x, index):
    x = ensure_tensor(x)
    idx = _index(index, x.device)
    return apply_op("index_sample", lambda v: torch.gather(v, 1, idx), (x,))


def index_add(x, index, axis, value, name=None):
    x, value = ensure_tensor(x), ensure_tensor(value)
    idx = _index(index, x.device)
    return apply_op("index_add", lambda v, u: torch.index_add(v, axis, idx, u.to(v.dtype)),
                    (x, value))


def index_put(x, indices, value, accumulate=False, name=None):
    x, value = ensure_tensor(x), ensure_tensor(value)
    idx = tuple(i.to(x.device) if isinstance(i, torch.Tensor) and i.dtype == torch.bool
                else _index(i, x.device) for i in indices)
    return apply_op("index_put",
                    lambda v, u: v.index_put(idx, u.to(v.dtype), accumulate=accumulate),
                    (x, value))


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr = ensure_tensor(arr)
    idx = _index(indices, arr.device)
    return apply_op("take_along_axis", lambda v: torch.take_along_dim(v, idx, axis), (arr,))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None, **kw):
    arr, values = ensure_tensor(arr), ensure_tensor(values)
    idx = _index(indices, arr.device)

    def fn(v, u):
        u = torch.broadcast_to(u.to(v.dtype), idx.shape)
        if reduce == "add":
            return v.scatter_add(axis, idx, u)
        if reduce in ("mul", "multiply"):
            return v.scatter_reduce(axis, idx, u, "prod")
        return v.scatter(axis, idx, u)

    return apply_op("put_along_axis", fn, (arr, values))


def masked_select(x, mask, name=None):
    x = ensure_tensor(x)
    m = ensure_tensor(mask).to(x.device, torch.bool)
    return apply_op("masked_select", lambda v: torch.masked_select(v, m), (x,))


def masked_fill(x, mask, value, name=None):
    x = ensure_tensor(x)
    m = ensure_tensor(mask).to(x.device, torch.bool)
    if isinstance(value, torch.Tensor):
        return apply_op("masked_fill", lambda v, w: torch.where(m, w.to(v.dtype), v),
                        (x, value))
    return apply_op("masked_fill", lambda v: torch.masked_fill(v, m, value), (x,))


def slice(input, axes, starts, ends):
    input = ensure_tensor(input)
    idx = [builtins.slice(None)] * input.dim()
    for ax, s, e in zip(axes, starts, ends):
        idx[ax] = builtins.slice(_int(s), _int(e))
    idx = tuple(idx)
    return apply_op("slice", lambda v: v[idx], (input,))


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = ensure_tensor(x)
    idx = [builtins.slice(None)] * x.dim()
    flips = []
    for ax, s, e, st in zip(axes, starts, ends, strides):
        s, e, st = int(s), int(e), int(st)
        if st < 0:      # torch slices step forward only: take the range, then flip it
            n = x.shape[ax]
            rng = list(range(n))[builtins.slice(s, e, st)]
            idx[ax] = torch.tensor(rng, dtype=torch.long, device=x.device)
            flips.append(ax)
        else:
            idx[ax] = builtins.slice(s, e, st)

    def fn(v):
        for ax, i in enumerate(idx):
            if isinstance(i, torch.Tensor):
                v = torch.index_select(v, ax, i)
            else:
                v = v[(builtins.slice(None),) * ax + (i,)]
        return v

    return apply_op("strided_slice", fn, (x,))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = ensure_tensor(x)
    r = repeats.to(x.device) if isinstance(repeats, torch.Tensor) else repeats
    return apply_op("repeat_interleave", lambda v: torch.repeat_interleave(v, r, axis), (x,))


def cast(x, dtype):
    return ensure_tensor(x).to(convert_dtype(dtype))


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``pad``: [lo, hi] pairs for every dim (2 * ndim numbers, first dim
    first), or fewer pairs for the trailing dims, the last dim first."""
    x = ensure_tensor(x)
    if isinstance(pad, torch.Tensor):
        pad = pad.reshape(-1).tolist()
    nd = x.dim()
    if len(pad) == 2 * nd:
        pairs = [(int(pad[2 * i]), int(pad[2 * i + 1])) for i in range(nd)][::-1]
    else:
        pairs = [(int(pad[2 * i]), int(pad[2 * i + 1])) for i in range(len(pad) // 2)]
    while pairs and pairs[-1] == (0, 0):
        pairs.pop()
    flat = [p for pair in pairs for p in pair]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    flat = [p for pair in pairs for p in pair]

    def fn(v):
        if not flat:
            return v.clone()
        if mode == "constant":
            return torch.nn.functional.pad(v, flat, mode="constant", value=value)
        # torch pads the trailing dims in these modes after a batch and a
        # channel dim: give it those two
        lead = v.dim() - len(flat) // 2
        out = torch.nn.functional.pad(v.reshape(1, -1, *v.shape[lead:]), flat, mode=mode)
        return out.reshape(*v.shape[:lead], *out.shape[2:])

    return apply_op("pad", fn, (x,))


def crop(x, shape=None, offsets=None, name=None):
    x = ensure_tensor(x)
    s = _shape_arg(shape)
    offs = [0] * x.dim() if offsets is None else [int(o) for o in offsets]
    idx = tuple(builtins.slice(o, o + (x.shape[i] - o if d == -1 else d))
                for i, (o, d) in enumerate(zip(offs, s)))
    return apply_op("crop", lambda v: v[idx], (x,))


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    """numpy's ``unique`` (sorted), computed on the host, the results on
    ``x``'s device."""
    x = ensure_tensor(x)
    v = x.detach().cpu()
    res = np.unique(v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy(),
                    return_index=return_index, return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return torch.as_tensor(res, device=x.device).to(x.dtype)
    first = torch.as_tensor(res[0], device=x.device).to(x.dtype)
    return (first,) + tuple(torch.as_tensor(r, device=x.device).to(convert_dtype(dtype))
                            for r in res[1:])


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None, dtype="int64",
                       name=None):
    x = ensure_tensor(x)
    v = x.detach()
    if axis is None:
        v = v.reshape(-1)
    out = torch.unique_consecutive(v, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if not isinstance(out, tuple):
        return out
    return (out[0],) + tuple(o.to(convert_dtype(dtype)) for o in out[1:])


def as_strided(x, shape, stride, offset=0, name=None):
    x = ensure_tensor(x)
    return apply_op("as_strided", lambda v: torch.as_strided(v.contiguous(), tuple(shape),
                                                             tuple(stride), offset), (x,))


def view(x, shape_or_dtype, name=None):
    x = ensure_tensor(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    dt = convert_dtype(shape_or_dtype)
    return apply_op("view_dtype", lambda v: v.view(dt), (x,))


def tensordot(x, y, axes=2, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    ax = axes.tolist() if isinstance(axes, torch.Tensor) else axes
    if isinstance(ax, (list, tuple)):     # a pair: the axes of x, the axes of y
        ax = [list(a) if isinstance(a, (list, tuple)) else [a] for a in ax]
    return apply_op("tensordot", lambda a, b: torch.tensordot(a, b, dims=ax), (x, y))
