"""The port's convolution, pooling, norm and image functionals (ROADMAP
A3b) against the JAX package's, on the CPU, forward and gradients: the same seeded numpy inputs go through both, and the port's
autograd gradients of a random cotangent are held against the JAX tape's.

Where the JAX package's own function cannot run on JAX 0.9 (its
transposed convolutions pass ``transpose_kernel``, which
``lax.conv_general_dilated`` no longer takes, and its pools concatenate a
string padding to a list), the port is held against the reference's
formula written with ``jax.lax`` directly.  Tolerances are the rows of
``tests/op_test.py``: f32 for values, the f32 gradient row for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as F
from test_torch_dropout import FedMasks

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)     # tests/op_test.py, float32
GRAD = dict(rtol=5e-3, atol=1e-4)    # tests/op_test.py, float32 gradients


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check(port_fn, ref_fn, arrays, grad=True, tol=F32):
    """``port_fn`` on torch tensors and ``ref_fn`` on the JAX package's
    tensors of ``arrays``: equal outputs, and (``grad``) equal gradients of
    each input under one random cotangent."""
    ts = [torch.from_numpy(a).requires_grad_(grad) for a in arrays]
    js = [paddle.to_tensor(a, stop_gradient=not grad) for a in arrays]
    got, want = port_fn(*ts), ref_fn(*js)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()), **tol)
    if not grad:
        return
    cot = _np(99, *got.shape)
    (got * torch.from_numpy(cot)).sum().backward()
    (want * paddle.to_tensor(cot)).sum().backward()
    for i, (t, j) in enumerate(zip(ts, js)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.numpy()), **GRAD,
                                   err_msg=f"grad of input {i}")


def _check_jnp(port_fn, ref_fn, arrays, tol=F32):
    """As :func:`_check`, against a ``jax.numpy`` function (``jax.vjp``)."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = port_fn(*ts)
    want, vjp = jax.vjp(ref_fn, *[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    cot = _np(99, *got.shape)
    (got * torch.from_numpy(cot)).sum().backward()
    for i, (t, g) in enumerate(zip(ts, vjp(jnp.asarray(cot)))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD,
                                   err_msg=f"grad of input {i}")


def _nhwc(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------
CONV2D = [  # padding, stride, dilation, groups, data_format
    (0, 1, 1, 1, "NCHW"),
    (1, 2, 1, 2, "NCHW"),
    ([1, 2], 1, 2, 1, "NCHW"),
    ([(1, 0), (2, 1)], 2, 1, 1, "NCHW"),
    ([0, 1, 2, 0], 3, 1, 2, "NCHW"),
    ("SAME", 1, 1, 1, "NCHW"),
    ("SAME", 2, 1, 2, "NCHW"),
    ("SAME", 2, 2, 1, "NHWC"),
    ("VALID", 2, 1, 1, "NCHW"),
    (1, 2, 1, 2, "NHWC"),
    ([(0, 1), (1, 0)], 2, 1, 1, "NHWC"),
    (3, 2, 1, 1, "NCHW:NHWC"),
    ("SAME", 2, 1, 2, "NCHW:NHWC"),
]


@pytest.mark.parametrize("padding, stride, dilation, groups, fmt", CONV2D)
def test_conv2d(padding, stride, dilation, groups, fmt):
    x = _np(0, 2, 4, 9, 11)
    if fmt == "NHWC":
        x = _nhwc(x)
    w, b = _np(1, 6, 4 // groups, 3, 3), _np(2, 6)
    args = (stride, padding, dilation, groups, fmt)
    _check(lambda *t: F.conv2d(*t, *args), lambda *t: JF.conv2d(*t, *args), [x, w, b])


@pytest.mark.parametrize("nd, padding, fmt", [(1, 1, "NCL"), (1, "SAME", "NLC"),
                                              (1, [(2, 0)], "NCL"), (3, 1, "NCDHW"),
                                              (3, "SAME", "NDHWC"), (3, [1, 0, 1], "NCDHW")])
def test_conv1d_conv3d(nd, padding, fmt):
    spatial = (9,) if nd == 1 else (5, 6, 7)
    x = _np(3, 2, 4, *spatial)
    if not fmt.startswith("NC"):
        x = _nhwc(x)
    w, b = _np(4, 6, 2, *(3,) * nd), _np(5, 6)
    port = {1: F.conv1d, 3: F.conv3d}[nd]
    ref = {1: JF.conv1d, 3: JF.conv3d}[nd]
    args = (2, padding, 1, 2, fmt)
    _check(lambda *t: port(*t, *args), lambda *t: ref(*t, *args), [x, w, b])


def _ref_transpose(nd, stride, padding, output_padding, dilation, groups, fmt):
    """The reference's ``_convnd_transpose`` (a convolution of the input
    dilated by ``stride`` with the kernel flipped and its in and out roles
    swapped, padded by d·(k−1) − p and ``output_padding`` high) in
    ``jax.lax``, with the kernel transposed by hand."""
    strides, dil = (stride,) * nd, (dilation,) * nd
    sp = "DHW"[-nd:]
    spec = ("NC" + sp) if fmt.startswith("NC") else ("N" + sp + "C")

    def fn(v, w, b):
        cin, og, ks = w.shape[0], w.shape[1], w.shape[2:]
        wg = w.reshape((groups, cin // groups, og) + ks).swapaxes(1, 2)
        wf = jnp.flip(wg.reshape((groups * og, cin // groups) + ks), tuple(range(2, 2 + nd)))
        if isinstance(padding, str):
            pad = padding
        else:
            pad = JF._conv_padding(padding, nd)
            opad = JF._tuple_n(output_padding, nd)
            pad = [(dil[i] * (ks[i] - 1) - pad[i][0], dil[i] * (ks[i] - 1) - pad[i][1] + opad[i])
                   for i in range(nd)]
        out = jax.lax.conv_general_dilated(v, wf, (1,) * nd, pad, lhs_dilation=strides,
                                           rhs_dilation=dil,
                                           dimension_numbers=(spec, "OI" + sp, spec),
                                           feature_group_count=groups)
        shape = [1] * out.ndim
        shape[1 if fmt.startswith("NC") else -1] = b.size
        return out + b.reshape(shape)

    return fn


TRANSPOSE = [  # nd, stride, padding, output_padding, dilation, groups, data_format
    (2, 1, 0, 0, 1, 1, "NCHW"),
    (2, 2, 1, 1, 1, 2, "NCHW"),
    (2, 2, [1, 2], [1, 0], 2, 1, "NCHW"),
    (2, 3, [(1, 0), (0, 2)], 0, 1, 1, "NHWC"),
    (2, 2, 0, 3, 1, 1, "NCHW"),
    (2, 1, "SAME", 0, 2, 2, "NCHW"),
    (2, 1, "VALID", 0, 1, 1, "NHWC"),
    (1, 2, 1, 1, 1, 2, "NCL"),
    (3, 2, 1, 1, 1, 1, "NCDHW"),
]


@pytest.mark.parametrize("nd, stride, padding, opad, dilation, groups, fmt", TRANSPOSE)
def test_conv_transpose(nd, stride, padding, opad, dilation, groups, fmt):
    spatial = {1: (7,), 2: (5, 6), 3: (3, 4, 5)}[nd]
    x = _np(6, 2, 4, *spatial)
    if not fmt.startswith("NC"):
        x = _nhwc(x)
    w, b = _np(7, 4, 3, *(3,) * nd), _np(8, 3 * groups)
    port = {1: F.conv1d_transpose, 2: F.conv2d_transpose, 3: F.conv3d_transpose}[nd]
    _check_jnp(lambda v, ww, bb: port(v, ww, bb, stride, padding, opad, groups, dilation,
                                      None, fmt),
               _ref_transpose(nd, stride, padding, opad, dilation, groups, fmt), [x, w, b])


def test_conv_transpose_matches_torch_where_torch_takes_it():
    """The reference formula above is torch's transpose where torch takes
    the arguments (equal padding, output_padding < stride)."""
    x, w, b = _np(9, 2, 4, 5, 6), _np(10, 4, 3, 3, 3), _np(11, 6)
    got = F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             2, 1, 1, 2, 1)
    want = torch.nn.functional.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                                                torch.from_numpy(b), 2, 1, 1, 2, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    with pytest.raises(ValueError, match="stride > 1"):
        F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w), None, 2, "SAME")


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
POOLS = [  # kernel, stride, padding, ceil_mode, data_format
    (3, 2, 1, False, "NCHW"),
    (3, 2, 1, True, "NCHW"),
    (2, 2, 0, True, "NCHW"),
    (3, 3, [0, 1], True, "NCHW"),
    (4, 3, 2, True, "NHWC"),
    ([2, 3], [2, 1], [(1, 0), (0, 2)], False, "NCHW"),
    (3, 2, [1, 1], True, "NHWC"),
]


@pytest.mark.parametrize("kernel, stride, padding, ceil_mode, fmt", POOLS)
@pytest.mark.parametrize("kind", ["max", "avg_exclusive", "avg_inclusive"])
def test_pool2d(kind, kernel, stride, padding, ceil_mode, fmt):
    x = _np(12, 2, 3, 9, 11)
    if fmt == "NHWC":
        x = _nhwc(x)
    if kind == "max":
        kw = dict(ceil_mode=ceil_mode, data_format=fmt)
        _check(lambda t: F.max_pool2d(t, kernel, stride, padding, **kw),
               lambda t: JF.max_pool2d(t, kernel, stride, padding, **kw), [x])
        return
    kw = dict(ceil_mode=ceil_mode, exclusive=kind == "avg_exclusive", data_format=fmt)
    _check(lambda t: F.avg_pool2d(t, kernel, stride, padding, **kw),
           lambda t: JF.avg_pool2d(t, kernel, stride, padding, **kw), [x])


@pytest.mark.parametrize("nd, kind", [(1, "max"), (1, "avg"), (3, "max"), (3, "avg")])
def test_pool1d_pool3d(nd, kind):
    x = _np(13, 2, 3, *((10,) if nd == 1 else (5, 6, 7)))
    port = getattr(F, f"{kind}_pool{nd}d")
    ref = getattr(JF, f"{kind}_pool{nd}d")
    kw = dict(ceil_mode=True) if kind == "max" else dict(ceil_mode=True, exclusive=False)
    _check(lambda t: port(t, 3, 2, 1, **kw), lambda t: ref(t, 3, 2, 1, **kw), [x])


@pytest.mark.parametrize("kind", ["max", "avg_exclusive", "avg_inclusive"])
def test_pool_same_padding_against_reduce_window(kind):
    """String padding: XLA's "SAME" pairs (the reference's own ``_pool``
    cannot join a string to its pad list on JAX 0.9)."""
    x = _np(14, 2, 3, 9, 10)
    window, strides = (1, 1, 3, 3), (1, 1, 2, 2)
    if kind == "max":
        _check_jnp(lambda t: F.max_pool2d(t, 3, 2, "SAME"),
                   lambda v: jax.lax.reduce_window(v, -jnp.inf, jax.lax.max, window, strides,
                                                   "SAME"), [x])
        return

    def ref(v):
        total = jax.lax.reduce_window(v, 0.0, jax.lax.add, window, strides, "SAME")
        if kind == "avg_inclusive":
            return total / 9
        return total / jax.lax.reduce_window(jnp.ones_like(v), 0.0, jax.lax.add, window,
                                             strides, "SAME")

    _check_jnp(lambda t: F.avg_pool2d(t, 3, 2, "SAME", exclusive=kind == "avg_exclusive"),
               ref, [x])


@pytest.mark.parametrize("size", [(3, 4), (None, 5), 1, (4, 11), (2, None), (3, 2)])
@pytest.mark.parametrize("kind", ["avg", "max"])
def test_adaptive_pool2d(kind, size):
    x = _np(15, 2, 3, 9, 11)
    port, ref = getattr(F, f"adaptive_{kind}_pool2d"), getattr(JF, f"adaptive_{kind}_pool2d")
    _check(lambda t: port(t, size), lambda t: ref(t, size), [x])


@pytest.mark.parametrize("nd, kind, size", [(1, "avg", 4), (1, "max", 3), (3, "avg", (2, None, 3)),
                                            (3, "max", (4, 2, 3))])
def test_adaptive_pool1d_pool3d(nd, kind, size):
    x = _np(16, 2, 3, *((10,) if nd == 1 else (5, 6, 7)))
    port = getattr(F, f"adaptive_{kind}_pool{nd}d")
    ref = getattr(JF, f"adaptive_{kind}_pool{nd}d")
    _check(lambda t: port(t, size), lambda t: ref(t, size), [x])


def test_adaptive_avg_pool_nhwc_and_return_mask():
    x = _nhwc(_np(17, 2, 3, 9, 11))
    _check(lambda t: F.adaptive_avg_pool2d(t, (2, 3), "NHWC"),
           lambda t: JF.adaptive_avg_pool2d(t, (2, 3), "NHWC"), [x])
    for fn in (F.max_pool2d, JF.max_pool2d):
        with pytest.raises(NotImplementedError, match="return_mask"):
            fn(paddle.to_tensor(x) if fn is JF.max_pool2d else torch.from_numpy(x), 2,
               return_mask=True)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_training_steps_update_running_buffers(fmt):
    """Three training steps: each output and the grads of x, weight and
    bias against the reference's, and the running buffers after each step
    by paddle's rule r = m·r + (1 − m)·batch with the biased variance."""
    c = 4
    rm, rv = np.zeros(c, np.float32), np.ones(c, np.float32)
    t_rm, t_rv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    j_rm, j_rv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    for step in range(3):
        x = 1.5 * _np(20 + step, 3, c, 5, 6) + step
        if fmt == "NHWC":
            x = _nhwc(x)
        w, b = _np(30, c), _np(31, c)
        _check(lambda *t: F.batch_norm(t[0], t_rm, t_rv, t[1], t[2], training=True,
                                       momentum=0.8, data_format=fmt),
               lambda *t: JF.batch_norm(t[0], j_rm, j_rv, t[1], t[2], training=True,
                                        momentum=0.8, data_format=fmt), [x, w, b])
        np.testing.assert_allclose(t_rm.numpy(), np.asarray(j_rm.numpy()), **F32)
        np.testing.assert_allclose(t_rv.numpy(), np.asarray(j_rv.numpy()), **F32)
    axes = (0, 2, 3) if fmt == "NCHW" else (0, 1, 2)
    assert not np.allclose(t_rv.numpy(), x.var(axis=axes, ddof=1))


@pytest.mark.parametrize("case", ["eval", "global_stats", "no_affine"])
def test_batch_norm_with_running_statistics(case):
    x, w, b = _np(40, 3, 4, 5, 6), _np(41, 4), _np(42, 4)
    rm, rv = _np(43, 4), np.abs(_np(44, 4)) + 0.5
    training = case == "global_stats"
    kw = dict(training=training, use_global_stats=True if training else None, epsilon=1e-3)
    args = [x] if case == "no_affine" else [x, w, b]

    def port(*t):
        return F.batch_norm(t[0], torch.from_numpy(rm), torch.from_numpy(rv), *t[1:], **kw)

    def ref(*t):
        return JF.batch_norm(t[0], paddle.to_tensor(rm), paddle.to_tensor(rv), *t[1:], **kw)

    _check(port, ref, args)


def test_batch_norm_bf16_rounds_once():
    x, w, b = _np(45, 3, 4, 5, 6), _np(46, 4), _np(47, 4)
    rm, rv = _np(48, 4), np.abs(_np(49, 4)) + 0.5
    got = F.batch_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(rm),
                       torch.from_numpy(rv), torch.from_numpy(w), torch.from_numpy(b))
    want = JF.batch_norm(paddle.to_tensor(x).astype("bfloat16"), paddle.to_tensor(rm),
                         paddle.to_tensor(rv), paddle.to_tensor(w), paddle.to_tensor(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype("float32").numpy()),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", ["group_norm", "group_norm_no_affine", "instance_norm",
                                  "instance_norm_3d", "normalize", "normalize_p1",
                                  "lrn_3", "lrn_4"])
def test_image_norms(case):
    x = _np(50, 2, 6, 5, 4) if case != "instance_norm_3d" else _np(50, 2, 6, 3, 4, 5)
    w, b = _np(51, 6), _np(52, 6)
    if case == "group_norm":
        _check(lambda *t: F.group_norm(t[0], 3, 1e-5, t[1], t[2]),
               lambda *t: JF.group_norm(t[0], 3, 1e-5, t[1], t[2]), [x, w, b])
    elif case == "group_norm_no_affine":
        _check(lambda t: F.group_norm(t, 2), lambda t: JF.group_norm(t, 2), [x])
    elif case.startswith("instance_norm"):
        _check(lambda *t: F.instance_norm(t[0], weight=t[1], bias=t[2]),
               lambda *t: JF.instance_norm(t[0], weight=t[1], bias=t[2]), [x, w, b])
    elif case.startswith("normalize"):
        p = 1 if case == "normalize_p1" else 2
        _check(lambda t: F.normalize(t, p, 2), lambda t: JF.normalize(t, p, 2), [x])
    else:
        size = int(case[-1])
        _check(lambda t: F.local_response_norm(t, size, 1e-2, 0.75, 2.0),
               lambda t: JF.local_response_norm(t, size, 1e-2, 0.75, 2.0), [x])


def test_group_norm_nhwc_raises_as_reference():
    x = _np(53, 2, 4, 4, 6)
    for fn, arr in ((F.group_norm, torch.from_numpy(x)), (JF.group_norm, paddle.to_tensor(x))):
        with pytest.raises(NotImplementedError, match="NHWC"):
            fn(arr, 2, data_format="NHWC")


# ---------------------------------------------------------------------------
# interpolate and the image functionals
# ---------------------------------------------------------------------------
INTERP = [(mode, ac, am) for mode in ("nearest", "bilinear", "bicubic", "area")
          for ac, am in ((False, 0), (True, 0), (False, 1)) if not (ac and mode == "bicubic")]


@pytest.mark.parametrize("size", [(5, 7), (17, 23), (9, 20)], ids=["down", "up", "mixed"])
@pytest.mark.parametrize("mode, align_corners, align_mode", INTERP)
def test_interpolate_2d(mode, align_corners, align_mode, size):
    x = _np(60, 2, 3, 9, 11)
    kw = dict(mode=mode, align_corners=align_corners, align_mode=align_mode)
    _check(lambda t: F.interpolate(t, size, **kw), lambda t: JF.interpolate(t, size, **kw), [x])


@pytest.mark.parametrize("mode, shape, size", [("linear", (2, 3, 9), (5,)),
                                               ("linear", (2, 3, 5), (12,)),
                                               ("trilinear", (2, 2, 4, 5, 6), (3, 7, 4)),
                                               ("nearest", (2, 2, 4, 5, 6), (7, 3, 6))])
def test_interpolate_1d_3d(mode, shape, size):
    x = _np(61, *shape)
    fmt = {3: "NCL", 5: "NCDHW"}[len(shape)]
    _check(lambda t: F.interpolate(t, size, mode=mode, data_format=fmt),
           lambda t: JF.interpolate(t, size, mode=mode, data_format=fmt), [x])


def test_interpolate_scale_factor_nhwc_and_bicubic_align_corners():
    x = _nhwc(_np(62, 2, 3, 6, 7))
    for mode in ("bilinear", "nearest"):
        _check(lambda t: F.upsample(t, scale_factor=1.5, mode=mode, data_format="NHWC"),
               lambda t: JF.upsample(t, scale_factor=1.5, mode=mode, data_format="NHWC"), [x])
    with pytest.raises(NotImplementedError, match="align_corners"):
        F.interpolate(torch.from_numpy(x), (3, 3), mode="bicubic", align_corners=True)


PAD = [([1, 2], "constant"), ([1, 2, 3, 1], "reflect"), ([0, 0, 1, 0, 1, 2, 3, 1], "replicate"),
       ([2, 1, 0, 3], "circular"), ([1, 0, 0, 2], "constant")]


@pytest.mark.parametrize("pads, mode", PAD)
def test_pad(pads, mode):
    x = _np(63, 2, 3, 5, 6)
    _check(lambda t: F.pad(t, pads, mode=mode, value=0.5),
           lambda t: JF.pad(t, pads, mode=mode, value=0.5), [x])


SHUFFLES = {
    "pixel_shuffle": ((2, 8, 3, 4), lambda m, t: m.pixel_shuffle(t, 2)),
    "pixel_unshuffle": ((2, 3, 4, 6), lambda m, t: m.pixel_unshuffle(t, 2)),
    "pixel_unshuffle_nhwc": ((2, 4, 6, 3), lambda m, t: m.pixel_unshuffle(t, 2, "NHWC")),
    "channel_shuffle": ((2, 6, 3, 4), lambda m, t: m.channel_shuffle(t, 3)),
    "channel_shuffle_nhwc": ((2, 3, 4, 6), lambda m, t: m.channel_shuffle(t, 2, "NHWC")),
    "unfold": ((2, 3, 7, 8), lambda m, t: m.unfold(t, [2, 3], [1, 2], 1, [2, 1])),
    "unfold_int": ((2, 3, 7, 8), lambda m, t: m.unfold(t, 3, 2, [1, 0])),
    "zeropad2d": ((2, 3, 4, 5), lambda m, t: m.zeropad2d(t, [1, 0, 2, 3])),
    "zeropad2d_nhwc": ((2, 4, 5, 3), lambda m, t: m.zeropad2d(t, 1, "NHWC")),
}


@pytest.mark.parametrize("name", sorted(SHUFFLES))
def test_image_functionals(name):
    shape, call = SHUFFLES[name]
    _check(lambda t: call(F, t), lambda t: call(JF, t), [_np(64, *shape)])


def test_bilinear_functional():
    _check(F.bilinear, JF.bilinear, [_np(65, 3, 4), _np(66, 3, 5), _np(67, 6, 4, 5),
                                     _np(68, 1, 6)])


@pytest.mark.parametrize("fn", ["dropout2d", "dropout3d", "alpha_dropout"])
def test_image_dropouts(fn, monkeypatch):
    """Identity at p = 0 and in eval; in training, with the same masks fed
    to both packages, the JAX package's values and gradients."""
    x = torch.from_numpy(_np(69, 2, 3, 4, 5, 6))
    port = getattr(F, fn)
    assert port(x, 0.5, training=False) is x and port(x, 0.0) is x
    fed = FedMasks(monkeypatch, seed=69)
    a = _np(69, 2, 3, 4, 5) if fn == "dropout2d" else _np(69, 2, 3, 4, 5, 6)
    _check(lambda t: port(t, 0.5), lambda j: getattr(JF, fn)(j, 0.5), [a])
    fed.check_same_draws()
