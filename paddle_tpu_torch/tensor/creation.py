"""Creation functions (port of the reference's ``tensor/creation.py``).

A new tensor is made on the default device (the card unless the caller
asked for the CPU: ``set_device("cpu")`` or a ``DeviceGuard``); a ``*_like``
function makes it on its argument's device.  Float tensors default to
float32; ``full`` and ``arange`` take their dtype from their values (an int
gives int64, ROADMAP §C).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..framework.dtype import canonical_dtype, convert_dtype, default_float_dtype  # noqa: F401
from ._op_utils import ensure_tensor
from .tensor import apply_op, to_tensor  # noqa: F401 (to_tensor: the reference's path)

__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
           "empty_like", "arange", "linspace", "logspace", "eye", "diag", "diagflat",
           "diag_embed", "tril", "triu", "tril_indices", "triu_indices", "meshgrid",
           "assign", "clone", "numel", "one_hot", "complex", "as_complex", "as_real",
           "Parameter", "to_tensor"]


def _dt(dtype, default=None):
    return default if dtype is None else convert_dtype(dtype)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (list, tuple)):
        return tuple(int(_scalar(s)) for s in shape)
    return (int(shape),)


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype, default_float_dtype()),
                       device=resolve_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype, default_float_dtype()),
                      device=resolve_device())


def full(shape, fill_value, dtype=None, name=None):
    return torch.full(_shape(shape), _scalar(fill_value), dtype=_dt(dtype),
                      device=resolve_device())


def empty(shape, dtype=None, name=None):
    """Zeros, as in the reference (XLA has no uninitialised memory)."""
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(ensure_tensor(x), dtype=_dt(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(ensure_tensor(x), dtype=_dt(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(ensure_tensor(x), _scalar(fill_value), dtype=_dt(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_dt(dtype), device=resolve_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dt(dtype, default_float_dtype()), device=resolve_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_scalar(start), _scalar(stop), int(_scalar(num)), base=base,
                          dtype=_dt(dtype, default_float_dtype()), device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype, default_float_dtype()), device=resolve_device())


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D ``x`` on the ``offset`` diagonal of a square matrix (the rest
    ``padding_value``); a 2-D ``x``'s ``offset`` diagonal."""
    x = ensure_tensor(x)

    def fn(v):
        out = torch.diag(v, offset)
        if v.dim() == 1 and padding_value != 0:
            mask = torch.diag(torch.ones_like(v, dtype=torch.bool), offset)
            out = torch.where(mask, out, torch.full_like(out, padding_value))
        return out

    return apply_op("diag", fn, (x,))


def diagflat(x, offset=0, name=None):
    x = ensure_tensor(x)
    return apply_op("diagflat", lambda v: torch.diagflat(v, offset), (x,))


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    x = ensure_tensor(x)
    return apply_op("diag_embed", lambda v: torch.diag_embed(v, offset, dim1, dim2), (x,))


def tril(x, diagonal=0, name=None):
    x = ensure_tensor(x)
    return apply_op("tril", lambda v: torch.tril(v, diagonal), (x,))


def triu(x, diagonal=0, name=None):
    x = ensure_tensor(x)
    return apply_op("triu", lambda v: torch.triu(v, diagonal), (x,))


def tril_indices(row, col, offset=0, dtype="int64", name=None):
    return torch.tril_indices(row, col, offset, dtype=convert_dtype(dtype),
                              device=resolve_device())


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    return torch.triu_indices(row, col or row, offset, dtype=convert_dtype(dtype),
                              device=resolve_device())


def meshgrid(*args, **kwargs):
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) else args
    ts = [ensure_tensor(t) for t in ts]
    return list(apply_op("meshgrid", lambda *vs: torch.meshgrid(*vs, indexing="ij"), ts,
                         multi_out=True))


def assign(x, output=None):
    """A copy of ``x``; written into ``output`` (and returned) if given."""
    out = apply_op("assign", torch.clone, (ensure_tensor(x),))
    if output is not None:
        if output.requires_grad and output.is_leaf:
            with torch.no_grad():
                return output.copy_(out)
        return output.copy_(out)
    return out


def clone(x, name=None):
    return apply_op("clone", torch.clone, (ensure_tensor(x),))


def numel(x, name=None):
    x = ensure_tensor(x)
    return torch.tensor(x.numel(), device=x.device)


def one_hot(x, num_classes, name=None):
    """float32 rows of ``num_classes`` with a one at each id of ``x``."""
    x = ensure_tensor(x)
    return torch.nn.functional.one_hot(x.long(), num_classes).to(default_float_dtype())


def complex(real, imag, name=None):
    real, imag = ensure_tensor(real), ensure_tensor(imag)
    return apply_op("complex", torch.complex, (real, imag))


def as_complex(x, name=None):
    x = ensure_tensor(x)
    return apply_op("as_complex", lambda v: torch.view_as_complex(v.contiguous()), (x,))


def as_real(x, name=None):
    x = ensure_tensor(x)
    return apply_op("as_real", torch.view_as_real, (x,))


def Parameter(value, stop_gradient=False, name=None):
    """A ``torch.nn.Parameter`` of ``value`` (persistable; named by its
    ``param_name``: a torch tensor's ``name`` is read-only)."""
    t = value.detach() if isinstance(value, torch.Tensor) else to_tensor(value)
    p = torch.nn.Parameter(t, requires_grad=not stop_gradient and
                           (t.is_floating_point() or t.is_complex()))
    p.persistable = True
    p.param_name = name
    return p

