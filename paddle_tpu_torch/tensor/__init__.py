"""The tensor functions and the tensor's methods (port of the reference's
``tensor/__init__.py``).

``Tensor`` is ``torch.Tensor`` (see :mod:`.tensor`).  Its arithmetic dunders
are torch's own.  The reference attaches its functions as tensor methods
through a method table; the port attaches those whose name ``torch.Tensor``
lacks (``pad``, ``scale``, ``concat``, ``take_along_axis``, ...) and those
torch keeps only as removed stubs (``solve``, ``eig``); the other names
torch has keep torch's meaning (``METHOD_DEPARTURES`` in
``tests/test_torch_signatures.py``).  ``backward`` also takes the
reference's ``grad_tensor=``."""

from __future__ import annotations

import torch

from . import creation, linalg, logic, manipulation, math, random, search
from .tensor import Tensor, apply_op, is_tensor, to_tensor, unwrap, wrap  # noqa: F401
from ._op_utils import binary_op, ensure_tensor, nondiff, unary_op  # noqa: F401
from ..framework.dtype import canonical_dtype, default_float_dtype  # noqa: F401
from ..framework.random import next_key  # noqa: F401

from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401

__all__ = sorted({"creation", "linalg", "logic", "manipulation", "math", "random", "search",
                  "Tensor", "apply_op", "is_tensor", "to_tensor", "unwrap", "wrap",
                  "ensure_tensor", "einsum", "binary_op", "nondiff", "unary_op",
                  "canonical_dtype", "default_float_dtype", "next_key"}
                 | {n for m in (creation, math, manipulation, linalg, logic, search, random)
                    for n in m.__all__})

# the reference's method table (tensor/__init__.py:65-107)
METHODS = frozenset({
    # math
    "abs", "ceil", "floor", "round", "trunc", "frac", "exp", "expm1", "log", "log2",
    "log10", "log1p", "sqrt", "rsqrt", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfinv", "sigmoid",
    "reciprocal", "sign", "neg", "square", "digamma", "lgamma", "logit", "deg2rad",
    "rad2deg", "conj", "angle",
    "add", "subtract", "multiply", "divide", "floor_divide", "mod", "remainder", "pow",
    "maximum", "minimum", "fmax", "fmin", "atan2", "logaddexp", "hypot",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "scale", "lerp", "clip", "nan_to_num", "stanh", "increment",
    "sum", "mean", "prod", "max", "min", "amax", "amin", "nansum", "nanmean", "all",
    "any", "logsumexp", "count_nonzero", "cumsum", "cumprod", "cummax", "cummin",
    "trace", "diagonal", "matmul", "mm", "dot", "bmm", "inner", "outer", "kron",
    "addmm", "isnan", "isinf", "isfinite", "isclose", "allclose", "equal_all",
    "std", "var", "median", "quantile", "histogram",
    # manipulation
    "reshape", "reshape_", "flatten", "transpose", "moveaxis", "swapaxes", "squeeze",
    "squeeze_", "unsqueeze", "unsqueeze_", "concat", "split", "chunk", "unbind",
    "unstack", "tile", "expand", "expand_as", "broadcast_to", "flip", "rot90", "roll",
    "gather", "gather_nd", "scatter", "scatter_", "scatter_nd_add", "index_select",
    "index_sample", "index_add", "index_put", "take_along_axis", "put_along_axis",
    "masked_select", "masked_fill", "strided_slice", "repeat_interleave", "pad",
    "unique", "unique_consecutive", "as_strided", "view", "tensordot", "crop",
    # logic
    "equal", "not_equal", "greater_than", "greater_equal", "less_than", "less_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not", "is_empty",
    # search
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode", "where",
    "nonzero", "searchsorted", "bucketize", "index_fill", "masked_scatter", "isin",
    # linalg
    "norm", "cholesky", "qr", "svd", "inv", "pinv", "solve", "triangular_solve",
    "det", "slogdet", "eig", "eigh", "eigvals", "eigvalsh", "matrix_power",
    "matrix_rank", "cond", "cov", "corrcoef",
    # creation-ish
    "tril", "triu", "diag", "diagflat", "diag_embed", "zeros_like", "ones_like",
    "full_like",
    # random
    "uniform_", "normal_", "bernoulli_", "exponential_", "multinomial",
})

_MODULES = (math, manipulation, logic, search, linalg, creation, random)

# names torch.Tensor still defines only as stubs that raise "removed" (since
# torch 1.9): the port's functions take their place, as in the reference
TORCH_REMOVED = frozenset({"solve", "eig"})

# the table's names torch.Tensor has of its own, which keep torch's meaning
TORCH_METHODS = frozenset(n for n in METHODS if n in dir(torch.Tensor)
                          and n not in TORCH_REMOVED)

_torch_backward = torch.Tensor.backward


def _backward(self, gradient=None, retain_graph=None, create_graph=False, inputs=None,
              *, grad_tensor=None):
    """torch's ``backward``, also under the reference's name of its first
    parameter (``backward(grad_tensor=None, retain_graph=False)``)."""
    if grad_tensor is not None:
        if gradient is not None:
            raise TypeError("backward() takes gradient or grad_tensor, not both")
        gradient = grad_tensor
    return _torch_backward(self, gradient, retain_graph, create_graph, inputs)


def _attach_methods() -> None:
    for name in sorted(METHODS - TORCH_METHODS):
        for mod in _MODULES:
            fn = getattr(mod, name, None)
            if fn is not None:
                setattr(torch.Tensor, name, fn)
                break
    torch.Tensor.backward = _backward


_attach_methods()
