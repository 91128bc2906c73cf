"""Search and sort functions (port of the reference's ``tensor/search.py``).
Indices are int64 and outside any graph; values stay in it."""

from __future__ import annotations

import torch

from ._op_utils import ensure_tensor, nondiff
from .tensor import apply_op, to_tensor

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode", "where",
           "where_", "nonzero", "searchsorted", "bucketize", "index_fill", "masked_scatter",
           "isin"]

argmax = nondiff("argmax", lambda v, axis=None, keepdim=False, dtype=None:
                 torch.argmax(v, dim=axis, keepdim=keepdim))
argmin = nondiff("argmin", lambda v, axis=None, keepdim=False, dtype=None:
                 torch.argmin(v, dim=axis, keepdim=keepdim))


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    x = ensure_tensor(x)
    v = x.detach()
    if v.dtype == torch.bool:
        v = v.to(torch.uint8)
    return torch.argsort(v, dim=axis, descending=descending, stable=stable)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    x = ensure_tensor(x)
    idx = argsort(x, axis=axis, descending=descending, stable=stable)
    return apply_op("sort", lambda v: torch.take_along_dim(v, idx, axis), (x,))


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    x = ensure_tensor(x)
    kk = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    values, indices = apply_op("topk", lambda v: torch.topk(v, kk, axis, largest, sorted), (x,),
                               multi_out=True)
    return values, indices


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = ensure_tensor(x)
    values, indices = apply_op("kthvalue", lambda v: torch.kthvalue(v, k, axis, keepdim), (x,),
                               multi_out=True)
    return values, indices


def mode(x, axis=-1, keepdim=False, name=None):
    """The most common value along ``axis`` (the smallest of a tie) and how
    often it occurs, as the reference (scipy's ``mode``) gives them."""
    x = ensure_tensor(x)
    v = x.detach()
    s = torch.sort(v, dim=axis).values
    # the most common value: a value's count is its run length in the sorted row
    uniq_counts = (s.unsqueeze(axis if axis >= 0 else axis - 1) ==
                   s.unsqueeze(axis + 1 if axis >= 0 else axis)).sum(axis if axis >= 0
                                                                    else axis - 1)
    best = torch.argmax(uniq_counts, dim=axis, keepdim=True)
    value = torch.take_along_dim(s, best, axis)
    count = torch.take_along_dim(uniq_counts, best, axis)
    if not keepdim:
        value, count = value.squeeze(axis), count.squeeze(axis)
    return value, count


def _operand(v, other):
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=other.device) if isinstance(other, torch.Tensor) \
        else to_tensor(v)


def where(condition, x=None, y=None, name=None):
    cond = ensure_tensor(condition)
    if x is None and y is None:
        return nonzero(cond, as_tuple=True)
    x, y = _operand(x, y), _operand(y, x)
    c = cond.to(x.device, torch.bool)
    return apply_op("where", lambda a, b: torch.where(c, a, b.to(a.dtype)
                                                      if a.dtype != b.dtype else b), (x, y))


def where_(condition, x, y, name=None):
    out = where(condition, x, y)
    return x.copy_(out)


def nonzero(x, as_tuple=False):
    x = ensure_tensor(x)
    with torch.no_grad():
        return torch.nonzero(x, as_tuple=as_tuple)


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    seq, vals = ensure_tensor(sorted_sequence).detach(), ensure_tensor(values).detach()
    return torch.searchsorted(seq.contiguous(), vals.contiguous(), out_int32=out_int32,
                              right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_fill(x, index, axis, value, name=None):
    x = ensure_tensor(x)
    idx = ensure_tensor(index).to(x.device, torch.long).reshape(-1)
    return apply_op("index_fill", lambda v: torch.index_fill(v, axis, idx, value), (x,))


def masked_scatter(x, mask, value, name=None):
    x, value = ensure_tensor(x), ensure_tensor(value)
    m = ensure_tensor(mask).to(x.device, torch.bool)
    return apply_op("masked_scatter",
                    lambda v, s: torch.masked_scatter(v, m.expand_as(v),
                                                      s.reshape(-1).to(v.dtype)), (x, value))


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    x, t = ensure_tensor(x), ensure_tensor(test_x)
    return torch.isin(x, t.to(x.device), assume_unique=assume_unique, invert=invert)
