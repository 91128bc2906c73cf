"""Dropout of the port (``nn.functional``'s dropout family, attention
dropout, RReLU) against the JAX package's, on the CPU.

JAX's and torch's random bits differ, so the parity cases hand both
packages the same numpy masks (:class:`FedMasks`): ``jax.random.bernoulli``
and ``jax.random.uniform`` are patched for the reference, the port's one
seam (``framework.random._keep_mask`` / ``_uniform``) for the port, and
both must ask for the same sequence of shapes and keep probabilities.
Forwards and gradients are held within the rows of ``tests/op_test.py``
(f32 attention within the attention rows of ``test_torch_train.py``), and
the upscale against the reference's compiled step bit for bit.  The laws
hold the port's own draws: the keep share within binomial bounds, the
1/(1 − p) scale, p = 0 and 1, eval, reproducibility under ``seed``,
``Generator`` and ``key_scope``, SELU moments under ``alpha_dropout``, and
no host read of a tensor while masks are drawn.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.random import key_scope as jkey_scope
from paddle_tpu.tensor.tensor import Tensor as JTensor

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.framework import random as R

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)        # tests/op_test.py, float32
BF16 = dict(rtol=2e-2, atol=2e-2)       # tests/op_test.py, bfloat16
F32_GRAD = dict(rtol=2e-5, atol=1e-6)   # elementwise grads: the forward row
ATTN = dict(rtol=1e-4, atol=1e-5)       # attention reductions (test_torch_train.py)
ATTN_BWD = dict(rtol=1e-4, atol=1e-4)   # attention grads (test_torch_train.py)
BF16_GRAD = dict(rtol=4e-2, atol=4e-2)  # tests/op_test.py, bfloat16 grads
DTYPES = {"float32": (F32, F32_GRAD), "bfloat16": (BF16, BF16_GRAD)}


class FedMasks:
    """Both packages' draws answered from one numpy stream: the i-th mask
    either package asks for is ``default_rng([seed, i]).random(shape) <
    keep`` (the i-th uniform draw ``low + (high - low) * random(shape)``),
    and each package's (kind, shape, parameter) requests are recorded in
    order.  ``rewind()`` starts both counts again: the reference's
    ``TrainStep`` draws once, while its step is traced, so its masks are
    constants of the compiled step, and the port is fed the same masks on
    every step.  With ``period`` n, draw i takes mask i mod n (a compiled
    reference that traces its function twice draws each mask twice)."""

    def __init__(self, monkeypatch, seed=0, uniform=False, period=None):
        self.seed, self.period = seed, period
        self.ref, self.port = [], []
        self._next = {"ref": 0, "port": 0}
        self._cache = {}
        monkeypatch.setattr(jax.random, "bernoulli", self._ref_bernoulli)
        monkeypatch.setattr(R, "_keep_mask", self._port_keep)
        monkeypatch.setattr(R, "_uniform", self._port_uniform)
        if uniform:   # jax.random.uniform also draws initial weights: patch it after building
            monkeypatch.setattr(jax.random, "uniform", self._ref_uniform)

    def rewind(self):
        self._next = {"ref": 0, "port": 0}

    def _draw(self, who, kind, shape, a, b=None):
        shape = tuple(int(s) for s in shape)
        i = self._next[who]
        self._next[who] += 1
        if self.period:
            i %= self.period
        (self.ref if who == "ref" else self.port).append((kind, shape, round(float(a), 12)))
        key = (i, kind, shape, a, b)
        if key not in self._cache:
            u = np.random.default_rng([self.seed, i]).random(shape)
            self._cache[key] = u < a if kind == "mask" else \
                (a + (b - a) * u).astype(np.float32)
        return self._cache[key]

    def _ref_bernoulli(self, key, p=0.5, shape=None):
        return jnp.asarray(self._draw("ref", "mask", shape, p))

    def _ref_uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(self._draw("ref", "uniform", shape, minval, maxval))

    def _port_keep(self, shape, keep_prob, device, generator=None):
        return torch.from_numpy(self._draw("port", "mask", shape, keep_prob)).to(device)

    def _port_uniform(self, shape, low, high, device, generator=None):
        return torch.from_numpy(self._draw("port", "uniform", shape, low, high)).to(device)

    def check_same_draws(self, n=None):
        assert self.port == self.ref, (self.port, self.ref)
        if n is not None:
            assert len(self.ref) == n, self.ref


@pytest.fixture
def fed(monkeypatch):
    return FedMasks(monkeypatch)


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x._value.astype(jnp.float32))


def _pair_inputs(arrays, dtype):
    """The arrays as leaves of both packages in ``dtype``."""
    ts, js = [], []
    for a in arrays:
        t = torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
        j = paddle.to_tensor(np.asarray(jnp.asarray(a).astype(getattr(jnp, dtype))))
        j.stop_gradient = False
        ts.append(t)
        js.append(j)
    return ts, js


def _check(fed, port_fn, ref_fn, arrays, dtype, tol=None, grad_tol=None, draws=1):
    """Forward and the gradients of sum(out * cot) through both packages
    with the same masks; the draws asked for are the same."""
    row, grow = DTYPES[dtype]
    ts, js = _pair_inputs(arrays, dtype)
    got, want = port_fn(*ts), ref_fn(*js)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), **(tol or row))
    cot = np.cos(np.arange(int(np.prod(got.shape)), dtype=np.float32)).reshape(got.shape)
    (got.float() * torch.from_numpy(cot)).sum().backward()
    (want.astype("float32") * paddle.to_tensor(cot)).sum().backward()
    for t, j in zip(ts, js):
        np.testing.assert_allclose(_f32(t.grad), _f32(j.grad), **(grad_tol or grow))
    fed.check_same_draws(draws)


# ---------------------------------------------------------------------------
# parity with fed masks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("axis", [None, 1, [0, 2]], ids=["all", "1", "0-2"])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_matches_reference(fed, mode, axis, dtype):
    x = _np(1, 4, 6, 10)
    _check(fed, lambda t: F.dropout(t, 0.3, axis=axis, mode=mode),
           lambda j: JF.dropout(j, 0.3, axis=axis, mode=mode), [x], dtype)
    shape = (4, 6, 10) if axis is None else (1, 6, 1) if axis == 1 else (4, 1, 10)
    assert fed.port == [("mask", shape, 0.7)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p", [0.1, 0.3, 0.5])
def test_upscale_is_the_compiled_reference_bit_for_bit(fed, p, dtype):
    """The reference's step is compiled: XLA turns its f32 division by
    1 − p into a product with the reciprocal, and keeps the bf16 one."""
    x = _np(2, 64, 129)

    def ref(v):
        with jkey_scope(jax.random.PRNGKey(0)):
            return JF.dropout(JTensor(v), p)._value

    want = jax.jit(ref)(jnp.asarray(x).astype(getattr(jnp, dtype)))
    got = F.dropout(torch.from_numpy(x).to(getattr(torch, dtype)), p)
    np.testing.assert_array_equal(_f32(got), np.asarray(want.astype(jnp.float32)))
    fed.check_same_draws(1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fn,fmt,shape", [
    ("dropout2d", "NCHW", (2, 5, 3, 4)), ("dropout2d", "NHWC", (2, 3, 4, 5)),
    ("dropout3d", "NCDHW", (2, 5, 2, 3, 4)), ("dropout3d", "NDHWC", (2, 2, 3, 4, 5))])
def test_channel_dropouts_match_reference(fed, fn, fmt, shape, dtype):
    x = _np(3, *shape)
    _check(fed, lambda t: getattr(F, fn)(t, 0.4, data_format=fmt),
           lambda j: getattr(JF, fn)(j, 0.4, data_format=fmt), [x], dtype)
    kept = [1] * len(shape)
    c = 1 if fmt.startswith("NC") else len(shape) - 1
    kept[0], kept[c] = shape[0], shape[c]
    assert fed.port[0][1] == tuple(kept)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_alpha_dropout_matches_reference(fed, dtype):
    _check(fed, lambda t: F.alpha_dropout(t, 0.2), lambda j: JF.alpha_dropout(j, 0.2),
           [_np(4, 6, 33)], dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rrelu_training_matches_reference(monkeypatch, dtype):
    fed = FedMasks(monkeypatch, seed=5, uniform=True)
    _check(fed, lambda t: F.rrelu(t, 0.1, 0.3), lambda j: JF.rrelu(j, 0.1, 0.3),
           [_np(5, 7, 19)], dtype)
    assert fed.port == [("uniform", (7, 19), 0.1)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["plain", "masked", "causal", "gqa"])
def test_sdpa_with_dropout_matches_reference(fed, case, dtype):
    b, s, h, d = 2, 12, 4, 8
    hkv = 2 if case == "gqa" else h
    arrays = [_np(6, b, s, h, d), _np(7, b, s, hkv, d), _np(8, b, s, hkv, d)]
    mask = None
    if case == "masked":
        m = np.zeros((b, 1, 1, s), np.float32)
        m[1, ..., 8:] = np.finfo(np.float32).min
        mask = m
    causal = case == "causal"

    def port(q, k, v):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=None if mask is None else torch.from_numpy(mask),
            dropout_p=0.2, is_causal=causal)

    def ref(q, k, v):
        return JF.scaled_dot_product_attention(
            q, k, v, attn_mask=None if mask is None else paddle.to_tensor(mask),
            dropout_p=0.2, is_causal=causal)

    tol = (ATTN, ATTN_BWD) if dtype == "float32" else (BF16, BF16_GRAD)
    _check(fed, port, ref, arrays, dtype, *tol)
    assert fed.port == [("mask", (b, h, s, s), 0.8)]


def test_sdpa_dropout_outside_training_is_the_flash_path(fed):
    q = torch.from_numpy(_np(9, 1, 8, 2, 8))
    out = F.scaled_dot_product_attention(q, q, q, dropout_p=0.5, training=False)
    want = F.scaled_dot_product_attention(q, q, q)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert fed.port == []


@pytest.mark.parametrize("name,args,kw", [
    ("Dropout", (0.3,), {}), ("Dropout", (0.3, 1), {}),
    ("Dropout", (0.3,), dict(mode="downscale_in_infer")),
    ("Dropout2D", (0.4,), {}), ("Dropout2D", (0.4, "NHWC"), {}),
    ("Dropout3D", (0.4,), {}), ("AlphaDropout", (0.2,), {}), ("RReLU", (0.1, 0.3), {})])
def test_dropout_layers_match_reference_in_both_modes(monkeypatch, name, args, kw):
    fed = FedMasks(monkeypatch, seed=6, uniform=True)
    shape = (2, 3, 4, 5, 6) if name == "Dropout3D" else (2, 3, 4, 5)
    x = _np(10, *shape)
    layer, jlayer = getattr(nn, name)(*args, **kw), getattr(jnn, name)(*args, **kw)
    np.testing.assert_allclose(_f32(layer(torch.from_numpy(x))),
                               _f32(jlayer(paddle.to_tensor(x))), **F32)
    fed.check_same_draws(1)
    layer.eval()
    jlayer.eval()
    np.testing.assert_allclose(_f32(layer(torch.from_numpy(x))),
                               _f32(jlayer(paddle.to_tensor(x))), **F32)
    fed.check_same_draws(1)


# ---------------------------------------------------------------------------
# laws of the port's own draws
# ---------------------------------------------------------------------------
def _binomial_ok(n_kept, n, keep, sigmas=6.0):
    return abs(n_kept - n * keep) <= sigmas * math.sqrt(n * keep * (1 - keep))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_share_and_scale(p):
    ptt.seed(11)
    x = torch.ones(1000, 1000)
    out = F.dropout(x, p)
    kept = out != 0
    assert _binomial_ok(int(kept.sum()), x.numel(), 1 - p)
    assert torch.equal(out[kept], torch.full((int(kept.sum()),), 1.0) * (1.0 / (1 - p)))
    # attention: uniform probabilities 1/256 over one-hot values, so each
    # output element is its probability times 1/(1 - p), or 0
    v = torch.eye(256)[None, :, None, :].expand(16, 256, 1, 256).contiguous()
    q = torch.zeros(16, 256, 1, 256)
    out = F.scaled_dot_product_attention(q, q, v, dropout_p=p)
    kept = out != 0
    assert _binomial_ok(int(kept.sum()), out.numel(), 1 - p)
    torch.testing.assert_close(out[kept], torch.full((int(kept.sum()),), 1 / 256 / (1 - p)))


def test_keep_mask_law_on_the_seam():
    for keep in (0.9, 0.5):
        m = R._keep_mask((1000, 1000), keep, torch.device("cpu"))
        assert m.dtype == torch.bool and _binomial_ok(int(m.sum()), m.numel(), keep)
    u = R._uniform((1000, 1000), 0.125, 1 / 3, torch.device("cpu"))
    assert u.dtype == torch.float32 and float(u.min()) >= 0.125 and float(u.max()) < 1 / 3
    assert abs(float(u.mean()) - (0.125 + 1 / 3) / 2) < 1e-3


def test_p_zero_one_and_eval():
    x = torch.from_numpy(_np(12, 5, 7))
    assert F.dropout(x, 0.0) is x and F.dropout(x, 0.5, training=False) is x
    torch.testing.assert_close(F.dropout(x, 0.25, training=False, mode="downscale_in_infer"),
                               x * 0.75)
    assert torch.equal(F.dropout(x, 1.0), torch.zeros_like(x))
    for fn in (F.dropout2d, F.dropout3d, F.alpha_dropout):
        assert fn(x, 0.0) is x and fn(x, 0.5, training=False) is x
    torch.testing.assert_close(F.rrelu(x, 0.1, 0.3, training=False),
                               torch.where(x >= 0, x, 0.2 * x))
    with pytest.raises(ValueError):
        F.rrelu(x, 0.5, 0.2)


def test_axis_masks_are_constant_off_their_axes():
    ptt.seed(13)
    out = F.dropout(torch.ones(8, 16, 32), 0.5, axis=1)
    assert torch.equal(out, out[:1, :, :1].expand_as(out))
    out = F.dropout2d(torch.ones(4, 6, 5, 5), 0.5)
    assert torch.equal(out, out[:, :, :1, :1].expand_as(out))
    out = F.dropout2d(torch.ones(4, 5, 5, 6), 0.5, data_format="NHWC")
    assert torch.equal(out, out[:, :1, :1, :].expand_as(out))


def test_seed_generator_and_key_scope_reproduce():
    x = torch.ones(64, 64)
    ptt.seed(21)
    a, b = F.dropout(x, 0.5), F.dropout(x, 0.5)
    ptt.seed(21)
    assert torch.equal(F.dropout(x, 0.5), a) and torch.equal(F.dropout(x, 0.5), b)
    assert not torch.equal(a, b)
    with R.key_scope(R.Generator(3)):
        c, d = F.dropout(x, 0.5), F.rrelu(-x)
    with R.key_scope(R.Generator(3)):
        assert torch.equal(F.dropout(x, 0.5), c) and torch.equal(F.rrelu(-x), d)
    with R.key_scope(torch.Generator().manual_seed(4)):
        e = F.dropout(x, 0.5)
    with R.key_scope(torch.Generator().manual_seed(4)):
        assert torch.equal(F.dropout(x, 0.5), e)
    with R.key_scope(7):
        f = F.scaled_dot_product_attention(x[None, :, None, :8], x[None, :, None, :8],
                                           x[None, :, None, :8], dropout_p=0.5)
    with R.key_scope(7):
        assert torch.equal(F.scaled_dot_product_attention(
            x[None, :, None, :8], x[None, :, None, :8], x[None, :, None, :8],
            dropout_p=0.5), f)


def test_fast_dropout_rng_flag_swaps_nothing():
    x = torch.ones(32, 32)
    masks = []
    for on in (True, False):
        ptt.framework.set_flags({"fast_dropout_rng": on})
        ptt.seed(5)
        masks.append(F.dropout(x, 0.5))
    ptt.framework.set_flags({"fast_dropout_rng": True})
    assert torch.equal(*masks)


def test_draws_take_no_fork_and_read_nothing_back(monkeypatch):
    """No mask draw forks a generator (``next_key`` reads a seed back to
    the host) or reads a tensor on the host: on the card either is a sync."""
    reads = []
    for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, _n=name, **k: (reads.append(_n),
                                                                      _o(self, *a, **k))[1])
    monkeypatch.setattr(R, "_fork", lambda *a: reads.append("fork"))
    x = torch.from_numpy(_np(14, 2, 8, 2, 8))
    F.dropout(x, 0.1)
    F.dropout2d(x, 0.1)
    F.alpha_dropout(x, 0.1)
    F.rrelu(x)
    F.scaled_dot_product_attention(x, x, x, dropout_p=0.1)
    assert reads == []


def test_alpha_dropout_keeps_selu_moments():
    ptt.seed(17)
    x = torch.randn(1000, 1000, generator=torch.Generator().manual_seed(1))
    for p in (0.1, 0.5):
        out = F.alpha_dropout(x, p)
        assert abs(float(out.mean())) < 0.01 and abs(float(out.var()) - 1.0) < 0.02
