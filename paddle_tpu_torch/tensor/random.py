"""Random draws (port of the reference's ``tensor/random.py``).

A draw takes the generator of the device it draws on: the innermost
``framework.random.key_scope``'s, else the device's global generator
(which ``paddle.seed`` seeds).  ``seed=`` of ``uniform`` and ``gaussian``
draws from a generator of its own seeded with it.  A new tensor is made on
the default device; ``*_like`` and the in-place draws on their argument's.
JAX's and torch's bits differ: a seed fixes the port's draws, and tests
hold the laws (ROADMAP §C).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..framework.dtype import canonical_dtype, convert_dtype, default_float_dtype  # noqa: F401
from ..framework.random import generator_for, next_key  # noqa: F401
from ._op_utils import ensure_tensor
from .creation import _shape

__all__ = ["rand", "randn", "uniform", "uniform_", "normal", "normal_", "gaussian",
           "standard_normal", "randint", "randint_like", "randperm", "bernoulli",
           "bernoulli_", "poisson", "multinomial", "exponential_", "binomial", "rand_like",
           "randn_like"]


def _dt(dtype, default):
    return default if dtype is None else convert_dtype(dtype)


def _gen(device, seed=0):
    if seed:
        return torch.Generator(device).manual_seed(int(seed))
    return generator_for(device)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def rand(shape, dtype=None, name=None):
    dev = resolve_device()
    return torch.rand(_shape(shape), dtype=_dt(dtype, default_float_dtype()), device=dev,
                      generator=_gen(dev))


def randn(shape, dtype=None, name=None):
    dev = resolve_device()
    return torch.randn(_shape(shape), dtype=_dt(dtype, default_float_dtype()), device=dev,
                       generator=_gen(dev))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = resolve_device()
    out = torch.empty(_shape(shape), dtype=_dt(dtype, default_float_dtype()), device=dev)
    return out.uniform_(_scalar(min), _scalar(max), generator=_gen(dev, seed))


@torch.no_grad()
def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    return x.uniform_(_scalar(min), _scalar(max), generator=_gen(x.device, seed))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        m = torch.as_tensor(mean, dtype=ref.dtype, device=ref.device)
        s = torch.as_tensor(std, dtype=ref.dtype, device=ref.device)
        m, s = torch.broadcast_tensors(m, s)
        return torch.normal(m, s, generator=_gen(ref.device))
    return randn(shape) * std + mean


@torch.no_grad()
def normal_(x, mean=0.0, std=1.0, name=None):
    return x.normal_(mean, std, generator=_gen(x.device))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = resolve_device()
    out = torch.empty(_shape(shape), dtype=_dt(dtype, default_float_dtype()), device=dev)
    return out.normal_(mean, std, generator=_gen(dev, seed))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = resolve_device()
    return torch.randint(int(low), int(high), _shape(shape), dtype=_dt(dtype, torch.int64),
                         device=dev, generator=_gen(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = ensure_tensor(x)
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), tuple(x.shape), dtype=_dt(dtype, x.dtype),
                         device=x.device, generator=_gen(x.device))


def randperm(n, dtype=None, name=None):
    dev = resolve_device()
    return torch.randperm(int(n), dtype=_dt(dtype, torch.int64), device=dev,
                          generator=_gen(dev))


def bernoulli(x, name=None):
    x = ensure_tensor(x)
    return torch.bernoulli(x.detach(), generator=_gen(x.device))


@torch.no_grad()
def bernoulli_(x, p=0.5, name=None):
    return x.bernoulli_(p, generator=_gen(x.device))


def poisson(x, name=None):
    x = ensure_tensor(x)
    return torch.poisson(x.detach(), generator=_gen(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    x = ensure_tensor(x)
    return torch.multinomial(x.detach(), num_samples, replacement, generator=_gen(x.device))


@torch.no_grad()
def exponential_(x, lam=1.0, name=None):
    return x.exponential_(lam, generator=_gen(x.device))


def binomial(count, prob, name=None):
    c, p = ensure_tensor(count), ensure_tensor(prob)
    dt = p.dtype if p.is_floating_point() else default_float_dtype()
    return torch.binomial(c.detach().to(dt), p.detach().to(dt), generator=_gen(p.device))


def rand_like(x, dtype=None, name=None):
    x = ensure_tensor(x)
    return torch.rand(tuple(x.shape), dtype=_dt(dtype, x.dtype), device=x.device,
                      generator=_gen(x.device))


def randn_like(x, dtype=None, name=None):
    x = ensure_tensor(x)
    return torch.randn(tuple(x.shape), dtype=_dt(dtype, x.dtype), device=x.device,
                       generator=_gen(x.device))
