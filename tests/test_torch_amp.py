"""The port's mixed precision (``amp/__init__.py``) against the JAX
package's, on the CPU: ``auto_cast`` O1 at each of the reference's cast
sites (``F.linear``, the forward convolutions, SDPA, ``paddle.matmul``,
the ring linears of ``mp_layers`` and ``sequence_parallel``, a custom white
list through the op funnel) with the same output dtypes and values, the
black list, the decorator form, nesting and the fp16 -> bf16 mapping under
``use_bf16_default``; ``AmpScaler`` and ``GradScaler`` step for step
against the reference (scaling, skipping on inf, halving, the floor of 1,
growth, ``state_dict``), one host synchronisation an unscale, the
already-unscaled guard, ``attach_health_guard`` (A7), and
``decorate(save_dtype=)``.

Tolerances: ``tests/op_test.py``'s bf16 row for values computed in bf16,
its f32 row for f32 ones.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.flags import flag_guard as jax_flag_guard
from paddle_tpu.tensor.tensor import Tensor as JTensor

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.distributed.meta_parallel import mp_layers as tmp
from paddle_tpu_torch.distributed.meta_parallel import sequence_parallel as tsp

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)     # tests/op_test.py, float32
BF16 = dict(rtol=2e-2, atol=2e-2)    # tests/op_test.py, bfloat16


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


# site: (port call, reference call) on the same numpy inputs
def _sites():
    rng = _rng(1)
    x, w, b = _arr(rng, 3, 8), _arr(rng, 8, 5), _arr(rng, 5)
    img, k, kb = _arr(rng, 2, 4, 9, 9), _arr(rng, 6, 4, 3, 3), _arr(rng, 6)
    q, kk, v = (_arr(rng, 2, 16, 2, 8) for _ in range(3))
    a, c = _arr(rng, 2, 4, 6), _arr(rng, 2, 6, 3)
    t = torch.from_numpy
    j = paddle.to_tensor
    return {
        "linear": (lambda: F.linear(t(x), t(w), t(b)), lambda: JF.linear(j(x), j(w), j(b))),
        "conv2d": (lambda: F.conv2d(t(img), t(k), t(kb), padding=1),
                   lambda: JF.conv2d(j(img), j(k), j(kb), padding=1)),
        "conv1d": (lambda: F.conv1d(t(img[:, :, 0]), t(k[:, :, 0]), None, stride=2),
                   lambda: JF.conv1d(j(img[:, :, 0]), j(k[:, :, 0]), None, stride=2)),
        "sdpa": (lambda: F.scaled_dot_product_attention(t(q), t(kk), t(v), is_causal=True),
                 lambda: JF.scaled_dot_product_attention(j(q), j(kk), j(v), is_causal=True)),
        "matmul": (lambda: ptt.matmul(t(a), t(c)), lambda: paddle.matmul(j(a), j(c))),
        "matmul_transposed": (lambda: ptt.matmul(t(a), t(a), transpose_y=True),
                              lambda: paddle.matmul(j(a), j(a), transpose_y=True)),
        "exp_unlisted": (lambda: ptt.exp(t(x)), lambda: paddle.exp(j(x))),
    }


def _both(site, **cast):
    port, ref = _sites()[site]
    with amp.auto_cast(**cast):
        got = port()
    with paddle.amp.auto_cast(**cast):
        want = ref()
    return got, want


@pytest.mark.parametrize("site", list(_sites()))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_o1_cast_sites_match_the_reference(site, dtype):
    """Under auto_cast the white-listed sites compute in the amp dtype (fp16
    is bf16 under ``use_bf16_default``, on by default in both) and the
    others in their inputs' dtype, as in the reference."""
    got, want = _both(site, dtype=dtype)
    assert _dtype_name(got) == _dtype_name(want), site
    expect = "float32" if site == "exp_unlisted" else "bfloat16"
    assert _dtype_name(got) == expect
    tol = F32 if expect == "float32" else BF16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype("float32").numpy()),
                               **tol)


@pytest.mark.parametrize("site,black", [("linear", "linear"), ("conv2d", "conv"),
                                        ("sdpa", "sdpa"), ("matmul", "matmul")])
def test_black_list_keeps_f32(site, black):
    got, want = _both(site, custom_black_list={black})
    assert _dtype_name(got) == _dtype_name(want) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("op", ["exp", "add"])
def test_custom_white_list_through_the_funnel(op):
    rng = _rng(2)
    x, y = _arr(rng, 4, 5), _arr(rng, 4, 5)
    port = (lambda: ptt.exp(torch.from_numpy(x))) if op == "exp" else \
        (lambda: ptt.add(torch.from_numpy(x), torch.from_numpy(y)))
    ref = (lambda: paddle.exp(paddle.to_tensor(x))) if op == "exp" else \
        (lambda: paddle.add(paddle.to_tensor(x), paddle.to_tensor(y)))
    with amp.auto_cast(custom_white_list={op}):
        got = port()
    with paddle.amp.auto_cast(custom_white_list={op}):
        want = ref()
    assert _dtype_name(got) == _dtype_name(want) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype("float32").numpy()),
                               **BF16)
    with amp.auto_cast(custom_white_list={op}, custom_black_list={op}):
        assert port().dtype == torch.float32


def test_decorator_nesting_and_state():
    rng = _rng(3)
    x, w = torch.from_numpy(_arr(rng, 2, 4)), torch.from_numpy(_arr(rng, 4, 3))

    @amp.auto_cast(level="O1", dtype="bfloat16")
    def f(a, b):
        assert amp.is_auto_cast_enabled() and amp.get_amp_level() == "O1"
        return F.linear(a, b)

    assert f(x, w).dtype == torch.bfloat16
    assert not amp.is_auto_cast_enabled() and amp.get_amp_dtype() is None
    assert amp.get_amp_level() == "O0"
    with amp.amp_guard():
        assert F.linear(x, w).dtype == torch.bfloat16
        with amp.auto_cast(enable=False):
            assert F.linear(x, w).dtype == torch.float32
            assert amp.amp_dtype_if_enabled("linear") is None
        assert amp.get_amp_dtype() == torch.bfloat16
    assert amp.amp_guard is amp.auto_cast
    # the transposed convolutions are not cast, as in the reference
    with amp.auto_cast():
        out = F.conv2d_transpose(torch.ones(1, 2, 4, 4), torch.ones(2, 3, 3, 3))
    assert out.dtype == torch.float32


@pytest.mark.parametrize("flag", [True, False])
def test_fp16_maps_to_bf16_under_the_flag(flag):
    with ptt.flag_guard(use_bf16_default=flag), jax_flag_guard(use_bf16_default=flag):
        with amp.auto_cast(dtype="float16"):
            got = amp.get_amp_dtype()
        with paddle.amp.auto_cast(dtype="float16"):
            want = paddle.amp.get_amp_dtype()
    assert str(got).replace("torch.", "") == str(jnp.dtype(want))
    assert got == (torch.bfloat16 if flag else torch.float16)


def _tp_group(monkeypatch, mp=2):
    monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", "1")
    monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP_MIN_ROWS", "1")
    members = np.empty(mp, dtype=object)
    members[:] = [torch.device("cpu")] * mp
    mesh = topology.Mesh(members.reshape((1, 1, 1, 1, mp)), topology._HYBRID_AXES)
    return topology.HybridCommunicateGroup(mesh=mesh)


@pytest.mark.parametrize("kind", ["column", "row", "column_sp", "row_sp"])
def test_ring_linears_cast_as_the_reference(kind, monkeypatch):
    """The ring linears of ``mp_layers`` and ``sequence_parallel`` cast their
    input, weight and bias under O1 ("linear"), as the reference's
    ``_overlap_linear``/``_overlap_linear_seq``: the ring's output is bf16
    and equals the fused path's (and F.linear's) under O1."""
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(_tp_group(monkeypatch))
    try:
        make = {"column": lambda: tmp.ColumnParallelLinear(16, 32, gather_output=True),
                "row": lambda: tmp.RowParallelLinear(16, 32),
                "column_sp": lambda: tsp.ColumnSequenceParallelLinear(16, 32,
                                                                      gather_output=True),
                "row_sp": lambda: tsp.RowSequenceParallelLinear(16, 32)}[kind]
        layer = make()
        with torch.no_grad():
            layer.bias.copy_(torch.from_numpy(_arr(_rng(4), 32)))
        x = torch.from_numpy(_arr(_rng(5), 2, 8, 16))
        calls = []
        for mod, name in ((tmp, "all_gather_matmul"), (tmp, "matmul_reduce_scatter"),
                          (tsp, "all_gather_matmul_seq"), (tsp, "matmul_reduce_scatter_seq")):
            orig = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k:
                                calls.append(_n) or _o(*a, **k))
        with torch.no_grad(), amp.auto_cast():
            ring = layer(x)
        assert calls, "the ring did not run"
        monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", "0")
        with torch.no_grad(), amp.auto_cast():
            fused = layer(x)
            plain = F.linear(x, layer.weight, layer.bias)
    finally:
        topology.set_hybrid_communicate_group(saved)
    assert ring.dtype == fused.dtype == plain.dtype == torch.bfloat16
    np.testing.assert_allclose(ring.float().numpy(), plain.float().numpy(), **BF16)
    np.testing.assert_allclose(fused.float().numpy(), plain.float().numpy(), **BF16)


# ---------------------------------------------------------------------------
# the scalers
# ---------------------------------------------------------------------------
def _scaler_run(cls_name, kw, plan, method="step"):
    """Both packages' scalers driving SGD over two parameters; ``plan`` is a
    list of steps, each "ok" or "inf" (one gradient element set to inf).
    Returns per step (scale, parameters) for each package."""
    rng = _rng(6)
    values = [_arr(rng, 3, 4), _arr(rng, 5)]
    pparams = [torch.nn.Parameter(torch.tensor(v)) for v in values]
    jparams = [JTensor(jnp.asarray(v), stop_gradient=False) for v in values]
    popt = ptt.optimizer.SGD(0.1, parameters=pparams)
    jopt = paddle.optimizer.SGD(0.1, parameters=jparams)
    ps, js = getattr(amp, cls_name)(**kw), getattr(paddle.amp, cls_name)(**kw)
    out = []
    for i, what in enumerate(plan):
        grads = [_arr(rng, *v.shape) * ps.get_loss_scaling() for v in values]
        if what == "inf":
            grads[1][2] = np.inf
        for p, g in zip(pparams, grads):
            p.grad = torch.tensor(g)
        for p, g in zip(jparams, grads):
            p._grad = JTensor(jnp.asarray(g))
        if method == "step":
            ps.step(popt)
            js.step(jopt)
            ps.update()
            js.update()
        else:
            ps.minimize(popt)
            js.minimize(jopt)
        out.append(((ps.get_loss_scaling(), [p.detach().numpy().copy() for p in pparams]),
                    (js.get_loss_scaling(), [np.asarray(p._value) for p in jparams])))
    return ps, js, out


@pytest.mark.parametrize("cls_name,kw,plan", [
    ("AmpScaler", {}, ["ok", "inf", "ok", "ok"]),
    ("GradScaler", {}, ["ok", "ok", "inf", "inf", "ok"]),
    ("GradScaler", dict(init_loss_scaling=2.0, incr_every_n_steps=2), ["ok", "ok", "ok", "ok"]),
    ("GradScaler", dict(init_loss_scaling=2.0, decr_every_n_nan_or_inf=1),
     ["inf", "inf", "inf", "ok"]),
    ("AmpScaler", dict(init_loss_scaling=8.0, decr_every_n_nan_or_inf=2, incr_every_n_steps=3),
     ["inf", "ok", "inf", "inf", "ok", "ok", "ok"]),
    ("GradScaler", dict(use_dynamic_loss_scaling=False, init_loss_scaling=4.0),
     ["ok", "inf", "ok"]),
], ids=["amp_default", "grad_default", "growth", "floor", "decr_every_2", "static"])
@pytest.mark.parametrize("method", ["step", "minimize"])
def test_scalers_step_for_step(cls_name, kw, plan, method):
    ps, js, out = _scaler_run(cls_name, kw, plan, method)
    for i, ((pscale, pvals), (jscale, jvals)) in enumerate(out):
        assert pscale == jscale, f"step {i}: scale {pscale} against {jscale}"
        for a, b in zip(pvals, jvals):
            np.testing.assert_allclose(a, b, **F32, err_msg=f"step {i}")
    assert ps.state_dict() == js.state_dict()
    assert ps.get_loss_scaling() >= 1.0       # the floor of a shrinking scale


def test_scaler_defaults_state_dict_and_guards():
    assert amp.AmpScaler().get_loss_scaling() == 2.0 ** 15
    assert amp.GradScaler().get_loss_scaling() == 2.0 ** 16
    assert amp.AmpScaler()._incr_every_n_steps == 1000
    assert amp.GradScaler()._incr_every_n_steps == 2000
    s = amp.GradScaler(init_loss_scaling=2.0, incr_every_n_steps=3)
    s._good_steps, s._bad_steps = 2, 0
    t = amp.GradScaler()
    t.load_state_dict(s.state_dict())
    assert t.state_dict()["scale"] == 2.0 and t._good_steps == 2
    assert amp.GradScaler.set_state_dict is amp.GradScaler.load_state_dict
    with pytest.raises(NotImplementedError, match="A7"):
        s.attach_health_guard(object())
    # scale() of a disabled scaler is the loss itself
    loss = torch.tensor(3.0)
    assert amp.GradScaler(enable=False).scale(loss) is loss
    # unscale_ then step: the gradients are unscaled once
    p = torch.nn.Parameter(torch.zeros(2))
    opt = ptt.optimizer.SGD(1.0, parameters=[p])
    s = amp.GradScaler(init_loss_scaling=4.0)
    p.grad = torch.full((2,), 8.0)
    s.unscale_(opt)
    s.unscale_(opt)
    assert torch.equal(p.grad, torch.full((2,), 2.0))
    s.step(opt)
    assert torch.equal(p.detach(), torch.full((2,), -2.0))


def test_unscale_reads_every_gradient_in_one_host_sync():
    """``_fused_unscale``'s contract: one synchronisation for the whole
    parameter list, counted by a spy on the tensor's host reads."""
    params = [torch.nn.Parameter(torch.ones(3)) for _ in range(12)]
    for i, p in enumerate(params):
        p.grad = torch.full((3,), float(i))
    opt = ptt.optimizer.SGD(0.1, parameters=params)
    scaler = amp.GradScaler()
    names = ("item", "__bool__", "__float__", "__int__", "tolist")
    saved = {n: torch.Tensor.__dict__.get(n) for n in names}
    count = [0]

    def spy(name):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *a, **k):
            count[0] += 1
            return orig(self, *a, **k)
        return wrapper

    for n in names:
        setattr(torch.Tensor, n, spy(n))
    try:
        scaler.unscale_(opt)
    finally:
        for n, v in saved.items():
            if v is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, v)
    assert count[0] == 1
    assert not scaler._found_inf
    assert math.isclose(float(params[5].grad[0]), 5.0 / 2 ** 16, rel_tol=1e-7)


def test_decorate_accepts_save_dtype():
    """``save_dtype`` is accepted and has no effect, as in the reference."""
    a, b = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    b.load_state_dict(a.state_dict())
    opt = ptt.optimizer.Momentum(0.1, parameters=a.parameters())
    ma, oa = amp.decorate(a, opt, level="O2", save_dtype="float32")
    mb = amp.decorate(b, level="O2")
    assert oa._multi_precision
    for (ka, va), (kb, vb) in zip(ma.state_dict().items(), mb.state_dict().items()):
        assert ka == kb and va.dtype == vb.dtype == torch.bfloat16 and torch.equal(va, vb)
