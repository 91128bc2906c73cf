"""Linear algebra (port of the reference's ``tensor/linalg.py``):
``torch.linalg`` under the reference's signatures (cuSOLVER and cuBLAS on
the card).  torch's decompositions take f32 and f64 only, so a half input
is computed in f32 and its results rounded back, as XLA does for the
reference."""

from __future__ import annotations

import numpy as np
import torch

from ._op_utils import ensure_tensor
from .math import bmm, dot, matmul  # noqa: F401 (the reference's paddle.linalg.matmul)
from .tensor import apply_op

__all__ = ["norm", "vector_norm", "matrix_norm", "cholesky", "cholesky_solve", "qr", "svd",
           "svdvals", "pca_lowrank", "inv", "pinv", "solve", "triangular_solve", "lstsq",
           "det", "slogdet", "eig", "eigh", "eigvals", "eigvalsh", "matrix_power",
           "matrix_rank", "cond", "cov", "corrcoef", "multi_dot", "histogramdd", "matmul",
           "dot", "bmm"]


def _wide(fn):
    """``fn`` over f32 copies of half inputs, its results in the inputs'
    dtype."""
    def g(*vs):
        half = [v.dtype for v in vs if v.dtype in (torch.bfloat16, torch.float16)]
        if not half:
            return fn(*vs)
        out = fn(*[v.float() if v.dtype == half[0] else v for v in vs])
        if isinstance(out, tuple):
            return tuple(o.to(half[0]) if o.is_floating_point() else o for o in out)
        return out.to(half[0]) if out.is_floating_point() else out

    return g


def _ax(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _all(v):
    return tuple(range(v.dim()))


def norm(x, p=None, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)

    def fn(v):
        ax = _ax(axis)
        if p is None or p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(torch.square(v)))
            return torch.linalg.norm(v, None, ax, keepdim)
        if p in (float("inf"), "inf"):
            return torch.amax(torch.abs(v), _all(v) if ax is None else ax, keepdim)
        if p in (float("-inf"), "-inf"):
            return torch.amin(torch.abs(v), _all(v) if ax is None else ax, keepdim)
        if ax is None:
            return torch.sum(torch.abs(v) ** p) ** (1.0 / p)
        return torch.linalg.norm(v, p, ax, keepdim)

    return apply_op("norm", _wide(fn), (x,))


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    x = ensure_tensor(x)
    return apply_op("matrix_norm",
                    lambda v: torch.linalg.matrix_norm(v, p, tuple(axis), keepdim), (x,))


def cholesky(x, upper=False, name=None):
    x = ensure_tensor(x)
    return apply_op("cholesky", _wide(lambda v: torch.linalg.cholesky(v, upper=upper)),
                    (x,))


def cholesky_solve(x, y, upper=False, name=None):
    """The solution z of (L L^T) z = x, ``y`` being L (or U = L^T when
    ``upper``)."""
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply_op("cholesky_solve", _wide(lambda b, f: torch.cholesky_solve(b, f, upper)),
                    (x, y))


def qr(x, mode="reduced", name=None):
    x = ensure_tensor(x)
    return apply_op("qr", _wide(lambda v: torch.linalg.qr(v, mode)), (x,), multi_out=True)


def svd(x, full_matrices=False, name=None):
    x = ensure_tensor(x)
    return apply_op("svd", _wide(lambda v: torch.linalg.svd(v, full_matrices)), (x,),
                    multi_out=True)


def svdvals(x, name=None):
    x = ensure_tensor(x)
    return apply_op("svdvals", _wide(torch.linalg.svdvals), (x,))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    x = ensure_tensor(x)
    v = x
    qq = q or min(6, *v.shape[-2:])
    if center:
        v = v - v.mean(-2, keepdim=True)
    u, s, vh = torch.linalg.svd(v, full_matrices=False)
    return u[..., :qq], s[..., :qq], vh.transpose(-1, -2)[..., :qq]


def inv(x, name=None):
    x = ensure_tensor(x)
    return apply_op("inv", _wide(torch.linalg.inv), (x,))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    x = ensure_tensor(x)
    return apply_op("pinv", _wide(lambda v: torch.linalg.pinv(v, rtol=rcond,
                                                              hermitian=hermitian)),
                    (x,))


def solve(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    return apply_op("solve", _wide(torch.linalg.solve), (x, y))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)

    def fn(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up, unitriangular=unitriangular)

    return apply_op("triangular_solve", _wide(fn), (x, y))


def lstsq(x, y, rcond=None, driver=None, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    out = torch.linalg.lstsq(x, y, rcond=rcond, driver=driver)
    return out.solution, out.residuals, out.rank, out.singular_values


def det(x, name=None):
    x = ensure_tensor(x)
    return apply_op("det", _wide(torch.linalg.det), (x,))


def slogdet(x, name=None):
    """[sign, log|det|] stacked on a new first axis."""
    x = ensure_tensor(x)
    return apply_op("slogdet", _wide(lambda v: torch.stack(tuple(torch.linalg.slogdet(v)), 0)),
                    (x,))


def eig(x, name=None):
    x = ensure_tensor(x)
    return tuple(torch.linalg.eig(x.detach()))


def eigh(x, UPLO="L", name=None):
    x = ensure_tensor(x)
    return apply_op("eigh", _wide(lambda a: torch.linalg.eigh(a, UPLO)), (x,), multi_out=True)


def eigvals(x, name=None):
    return torch.linalg.eigvals(ensure_tensor(x).detach())


def eigvalsh(x, UPLO="L", name=None):
    x = ensure_tensor(x)
    return apply_op("eigvalsh", _wide(lambda v: torch.linalg.eigvalsh(v, UPLO)), (x,))


def matrix_power(x, n, name=None):
    x = ensure_tensor(x)
    return apply_op("matrix_power", _wide(lambda v: torch.linalg.matrix_power(v, n)), (x,))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    x = ensure_tensor(x)
    return torch.linalg.matrix_rank(x.detach(), rtol=tol, hermitian=hermitian)


def cond(x, p=None, name=None):
    x = ensure_tensor(x)
    return torch.linalg.cond(x.detach(), p)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = ensure_tensor(x)
    fw = None if fweights is None else ensure_tensor(fweights).to(x.device)
    aw = None if aweights is None else ensure_tensor(aweights).to(x.device)
    return apply_op("cov", _wide(lambda v: torch.cov(v if rowvar else v.T,
                                                     correction=int(ddof), fweights=fw,
                                                     aweights=aw)), (x,))


def corrcoef(x, rowvar=True, name=None):
    x = ensure_tensor(x)
    return apply_op("corrcoef", _wide(lambda v: torch.corrcoef(v if rowvar else v.T)), (x,))


def multi_dot(x, name=None):
    ts = [ensure_tensor(t) for t in x]
    return apply_op("multi_dot", _wide(lambda *vs: torch.linalg.multi_dot(list(vs))),
                    tuple(ts))


def histogramdd(x, bins=10, ranges=None, density=False, weights=None, name=None):
    """numpy's ``histogramdd`` on the host; the counts and the edges on
    ``x``'s device."""
    x = ensure_tensor(x)
    w = None if weights is None else ensure_tensor(weights).detach().cpu().numpy()
    h, e = np.histogramdd(x.detach().cpu().numpy(), bins=bins, range=ranges, density=density,
                          weights=w)
    return (torch.as_tensor(h, device=x.device),
            [torch.as_tensor(i, device=x.device) for i in e])
