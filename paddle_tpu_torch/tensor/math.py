"""Math functions: elementwise, binary, reductions, cumulative ops (port of
the reference's ``tensor/math.py``).

Each is torch's operator under the reference's signature: ``axis`` (a list
or tuple reduces over several axes), ``keepdim``, a scalar ``y``.  Where the
reference's result differs from torch's operator of the same name, the
reference's is kept: ``median`` averages the two middle values, ``mean``
of integers is float32, ``histogram`` counts are int64.
"""

from __future__ import annotations

import builtins
from typing import Optional

import torch

from ..framework.dtype import convert_dtype, default_float_dtype
from ._op_utils import binary_op, ensure_tensor, nondiff, unary_op
from .tensor import apply_op

__all__ = ["abs", "ceil", "floor", "round", "trunc", "frac", "exp", "expm1", "log", "log2",
           "log10", "log1p", "sqrt", "rsqrt", "sin", "cos", "tan", "asin", "acos", "atan",
           "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfinv", "sigmoid",
           "reciprocal", "sign", "neg", "square", "digamma", "lgamma", "angle", "conj",
           "real", "imag", "deg2rad", "rad2deg", "logit", "add", "subtract", "multiply",
           "divide", "floor_divide", "mod", "remainder", "floor_mod", "pow", "maximum",
           "minimum", "fmax", "fmin", "atan2", "logaddexp", "hypot", "copysign",
           "heaviside", "nextafter", "gcd", "lcm", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "bitwise_left_shift", "bitwise_right_shift",
           "scale", "increment", "lerp", "clip", "nan_to_num", "stanh", "multiplex", "sum",
           "mean", "prod", "max", "min", "amax", "amin", "nansum", "nanmean", "all", "any",
           "logsumexp", "count_nonzero", "cumsum", "cumprod", "cummax", "cummin", "trace",
           "diagonal", "matmul", "mm", "dot", "bmm", "inner", "outer", "kron", "addmm",
           "matmul_int8", "isnan", "isinf", "isfinite", "isclose", "allclose", "equal_all",
           "std", "var", "median", "quantile", "histogram"]

# ---------------------------------------------------------------------------
# unary elementwise
# ---------------------------------------------------------------------------
abs = unary_op("abs", torch.abs)
ceil = unary_op("ceil", torch.ceil)
floor = unary_op("floor", torch.floor)
round = unary_op("round", torch.round)
trunc = unary_op("trunc", torch.trunc)
frac = unary_op("frac", lambda v: v - torch.trunc(v))
exp = unary_op("exp", torch.exp)
expm1 = unary_op("expm1", torch.expm1)
log = unary_op("log", torch.log)
log2 = unary_op("log2", torch.log2)
log10 = unary_op("log10", torch.log10)
log1p = unary_op("log1p", torch.log1p)
sqrt = unary_op("sqrt", torch.sqrt)
rsqrt = unary_op("rsqrt", torch.rsqrt)
sin = unary_op("sin", torch.sin)
cos = unary_op("cos", torch.cos)
tan = unary_op("tan", torch.tan)
asin = unary_op("asin", torch.asin)
acos = unary_op("acos", torch.acos)
atan = unary_op("atan", torch.atan)
sinh = unary_op("sinh", torch.sinh)
cosh = unary_op("cosh", torch.cosh)
tanh = unary_op("tanh", torch.tanh)
asinh = unary_op("asinh", torch.asinh)
acosh = unary_op("acosh", torch.acosh)
atanh = unary_op("atanh", torch.atanh)
erf = unary_op("erf", torch.erf)
erfinv = unary_op("erfinv", torch.erfinv)
sigmoid = unary_op("sigmoid", torch.sigmoid)
reciprocal = unary_op("reciprocal", lambda v: 1.0 / v)
sign = unary_op("sign", torch.sign)
neg = unary_op("neg", torch.neg)
square = unary_op("square", torch.square)
digamma = unary_op("digamma", torch.digamma)
lgamma = unary_op("lgamma", torch.lgamma)
angle = unary_op("angle", torch.angle)
conj = unary_op("conj", lambda v: torch.conj(v).resolve_conj())
real = unary_op("real", lambda v: torch.real(v) if v.is_complex() else v)
imag = unary_op("imag", lambda v: torch.imag(v) if v.is_complex() else torch.zeros_like(v))
deg2rad = unary_op("deg2rad", torch.deg2rad)
rad2deg = unary_op("rad2deg", torch.rad2deg)


def logit(x, eps: Optional[float] = None, name=None):
    x = ensure_tensor(x)
    return apply_op("logit", lambda v: torch.logit(v, eps), (x,))


# ---------------------------------------------------------------------------
# binary elementwise
# ---------------------------------------------------------------------------
def _same_dtype(fn):
    def g(a, b):
        dt = torch.result_type(a, b)
        return fn(a.to(dt), b.to(dt))

    return g


add = binary_op("add", torch.add)
subtract = binary_op("subtract", torch.subtract)
multiply = binary_op("multiply", torch.multiply)
divide = binary_op("divide", torch.true_divide)
floor_divide = binary_op("floor_divide", torch.floor_divide)
mod = binary_op("mod", torch.remainder)
remainder = mod
floor_mod = mod
pow = binary_op("pow", torch.pow)
maximum = binary_op("maximum", _same_dtype(torch.maximum))
minimum = binary_op("minimum", _same_dtype(torch.minimum))
fmax = binary_op("fmax", _same_dtype(torch.fmax))
fmin = binary_op("fmin", _same_dtype(torch.fmin))
atan2 = binary_op("atan2", torch.atan2)
logaddexp = binary_op("logaddexp", _same_dtype(torch.logaddexp))
hypot = binary_op("hypot", _same_dtype(torch.hypot))
copysign = binary_op("copysign", torch.copysign)
heaviside = binary_op("heaviside", _same_dtype(torch.heaviside))
nextafter = binary_op("nextafter", _same_dtype(torch.nextafter), differentiable=False)
gcd = nondiff("gcd", torch.gcd)
lcm = nondiff("lcm", torch.lcm)

bitwise_and = nondiff("bitwise_and", torch.bitwise_and)
bitwise_or = nondiff("bitwise_or", torch.bitwise_or)
bitwise_xor = nondiff("bitwise_xor", torch.bitwise_xor)
bitwise_not = nondiff("bitwise_not", torch.bitwise_not)
bitwise_left_shift = nondiff("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = nondiff("bitwise_right_shift", torch.bitwise_right_shift)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    """``x * scale + bias`` (or ``(x + bias) * scale``)."""
    x = ensure_tensor(x)

    def fn(v):
        if bias_after_scale:
            return v * scale + bias
        return (v + bias) * scale

    return apply_op("scale", fn, (x,))


def increment(x, value=1.0, name=None):
    """``x += value`` in place; returns ``x``."""
    x = ensure_tensor(x)
    return x.add_(value)


def lerp(x, y, weight, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply_op("lerp", lambda a, b: a + weight * (b - a), (x, y))


def clip(x, min=None, max=None, name=None):
    x = ensure_tensor(x)
    return apply_op("clip", lambda v: torch.clamp(v, min, max), (x,))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    x = ensure_tensor(x)
    return apply_op("nan_to_num",
                    lambda v: torch.nan_to_num(v, nan=nan, posinf=posinf, neginf=neginf), (x,))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    x = ensure_tensor(x)
    return apply_op("stanh", lambda v: scale_b * torch.tanh(scale_a * v), (x,))


def multiplex(inputs, index, name=None):
    """Row i of the result is row i of ``inputs[index[i]]``."""
    ts = [ensure_tensor(t) for t in inputs]
    idx = ensure_tensor(index).reshape(-1).long()

    def fn(*vals):
        stacked = torch.stack(vals, 0)
        return stacked[idx.to(stacked.device), torch.arange(stacked.shape[1],
                                                             device=stacked.device)]

    return apply_op("multiplex", fn, tuple(ts))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        return tuple(int(a) for a in axis.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(v: torch.Tensor, axis) -> tuple:
    """``axis`` as a tuple of non-negative dims; all dims for None."""
    ax = _norm_axis(axis)
    if ax is None:
        return tuple(range(v.dim()))
    ax = ax if isinstance(ax, tuple) else (ax,)
    return tuple(a % builtins.max(v.dim(), 1) for a in ax)


def _over_dims(fn, v: torch.Tensor, axis, keepdim: bool):
    """``fn(v, dim, keepdim)`` over each dim of ``axis`` in turn, for the
    torch reductions that take one dim."""
    dims = _dims(v, axis)
    if v.dim() == 0:
        return v.clone()
    for d in sorted(dims, reverse=True):
        v = fn(v, d, keepdim)
    return v


def _reduce(name, fn, differentiable=True):
    def op(x, axis=None, keepdim=False, name_=None, dtype=None):
        x = ensure_tensor(x)

        def f(v):
            out = fn(v, _dims(v, axis), keepdim)
            if dtype is not None:
                out = out.to(convert_dtype(dtype))
            return out

        if differentiable:
            return apply_op(name, f, (x,))
        with torch.no_grad():
            return f(x)

    op.__name__ = name
    op.__qualname__ = name
    return op


def _float(v):
    return v if v.is_floating_point() or v.is_complex() else v.to(default_float_dtype())


sum = _reduce("sum", lambda v, d, k: torch.sum(v, d, keepdim=k) if d else v.clone())
mean = _reduce("mean", lambda v, d, k: torch.mean(_float(v), d, keepdim=k) if d
               else _float(v).clone())
prod = _reduce("prod", lambda v, d, k: _over_dims(
    lambda t, i, kk: torch.prod(t, i, keepdim=kk), v, d, k))
max = _reduce("max", lambda v, d, k: torch.amax(v, d, keepdim=k) if d else v.clone())
min = _reduce("min", lambda v, d, k: torch.amin(v, d, keepdim=k) if d else v.clone())
amax = _reduce("amax", lambda v, d, k: torch.amax(v, d, keepdim=k) if d else v.clone())
amin = _reduce("amin", lambda v, d, k: torch.amin(v, d, keepdim=k) if d else v.clone())
nansum = _reduce("nansum", lambda v, d, k: torch.nansum(v, d, keepdim=k) if d else v.clone())
nanmean = _reduce("nanmean", lambda v, d, k: torch.nanmean(_float(v), d, keepdim=k) if d
                  else _float(v).clone())
all = _reduce("all", lambda v, d, k: torch.all(v.bool(), d, keepdim=k) if d else v.bool(),
              differentiable=False)
any = _reduce("any", lambda v, d, k: torch.any(v.bool(), d, keepdim=k) if d else v.bool(),
              differentiable=False)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return apply_op("logsumexp", lambda v: torch.logsumexp(v, _dims(v, axis), keepdim=keepdim),
                    (x,))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    with torch.no_grad():
        return (x != 0).sum(_dims(x, axis), keepdim=keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    x = ensure_tensor(x)
    dt = None if dtype is None else convert_dtype(dtype)

    def fn(v):
        if axis is None:
            return torch.cumsum(v.reshape(-1), 0, dtype=dt)
        return torch.cumsum(v, int(axis), dtype=dt)

    return apply_op("cumsum", fn, (x,))


def cumprod(x, dim=None, dtype=None, name=None):
    x = ensure_tensor(x)
    dt = None if dtype is None else convert_dtype(dtype)

    def fn(v):
        if dim is None:
            return torch.cumprod(v.reshape(-1), 0, dtype=dt)
        return torch.cumprod(v, int(dim), dtype=dt)

    return apply_op("cumprod", fn, (x,))


def _cum_extreme(x, axis, is_max):
    x = ensure_tensor(x)
    v = x.reshape(-1) if axis is None else x
    ax = 0 if axis is None else int(axis)
    values, indices = (torch.cummax if is_max else torch.cummin)(v, ax)
    return values, indices


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, is_max=True)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, is_max=False)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    x = ensure_tensor(x)
    return apply_op("trace", lambda v: torch.diagonal(v, offset, axis1, axis2).sum(-1), (x,))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    x = ensure_tensor(x)
    return apply_op("diagonal", lambda v: torch.diagonal(v, offset, axis1, axis2), (x,))


# ---------------------------------------------------------------------------
# matrix products (also exposed via linalg)
# ---------------------------------------------------------------------------
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y`` (either transposed first); under ``amp.auto_cast`` both in
    the amp dtype ("matmul")."""
    from ..amp import maybe_autocast_tensors

    x, y = maybe_autocast_tensors("matmul", ensure_tensor(x), ensure_tensor(y))

    def fn(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply_op("matmul", fn, (x, y))


mm = matmul


def dot(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply_op("dot", lambda a, b: torch.sum(a * b, -1), (x, y))


def bmm(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply_op("bmm", torch.matmul, (x, y))


def inner(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply_op("inner", torch.inner, (x, y))


def outer(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply_op("outer", lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)), (x, y))


def kron(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply_op("kron", torch.kron, (x, y))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    input, x, y = ensure_tensor(input), ensure_tensor(x), ensure_tensor(y)
    return apply_op("addmm", lambda i, a, b: beta * i + alpha * (a @ b), (input, x, y))


def matmul_int8(x, y, **kw):
    return matmul(x, y, **kw)


# ---------------------------------------------------------------------------
# float checks / comparisons that return bool tensors
# ---------------------------------------------------------------------------
isnan = nondiff("isnan", torch.isnan)
isinf = nondiff("isinf", torch.isinf)
isfinite = nondiff("isfinite", torch.isfinite)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    dt = torch.result_type(x, y)
    return torch.isclose(x.detach().to(dt), y.detach().to(dt), rtol, atol, equal_nan)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return isclose(x, y, rtol, atol, equal_nan).all()


def equal_all(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return torch.tensor(x.shape == y.shape and bool(torch.equal(x, y)), device=x.device)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = ensure_tensor(x)
    return apply_op("std", lambda v: torch.std(v, _dims(v, axis), correction=int(unbiased),
                                               keepdim=keepdim), (x,))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = ensure_tensor(x)
    return apply_op("var", lambda v: torch.var(v, _dims(v, axis), correction=int(unbiased),
                                               keepdim=keepdim), (x,))


def _quantile(v, q, axis, keepdim, interpolation="linear"):
    """``torch.quantile`` over the dims of ``axis`` (moved last and merged)."""
    dims = _dims(v, axis)
    keep = [d for d in range(v.dim()) if d not in dims]
    flat = v.permute(*keep, *dims).reshape(*[v.shape[d] for d in keep], -1)
    # torch's quantile takes f32 and f64 only: a half input is widened, and
    # the result rounded back
    wide = flat if flat.dtype in (torch.float32, torch.float64) else flat.float()
    out = torch.quantile(wide, q.to(wide.dtype) if isinstance(q, torch.Tensor) else q, dim=-1,
                         interpolation=interpolation).to(flat.dtype)
    if keepdim:
        shape = [1 if d in dims else v.shape[d] for d in range(v.dim())]
        out = out.reshape(*out.shape[:out.dim() - len(keep)], *shape)
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    x = ensure_tensor(x)
    return apply_op("median", lambda v: _quantile(v, 0.5, axis, keepdim), (x,))


def quantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    x = ensure_tensor(x)
    qv = q if isinstance(q, torch.Tensor) else torch.as_tensor(q, dtype=x.dtype,
                                                              device=x.device)
    return apply_op("quantile",
                    lambda v: _quantile(v, qv.to(v.device, v.dtype), axis, keepdim,
                                        interpolation), (x,))


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts (int64) of ``bins`` equal bins over [min, max] (the data's
    range when both are 0)."""
    v = ensure_tensor(input).detach().float()
    lo, hi = (float(v.min()), float(v.max())) if min == 0 and max == 0 else (min, max)
    return torch.histc(v, bins=bins, min=lo, max=hi).to(torch.int64)
