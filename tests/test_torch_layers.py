"""The port's ``nn.Layer`` tree against the JAX package's, on the CPU: the
``Layer`` API (names, order, state dicts, hooks, modes, casts, both
``named_parameters`` spellings), ``ParamAttr`` and the initializers
(deterministic ones bit for bit, random ones by their law), the
containers, every activation and loss (over the reductions), and the
transformer layers with and without a mask and a cache, pre- and
post-norm, with the reference's weights carried across.  Tolerances are
the f32 row of ``tests/op_test.py``.
"""

import copy
import math
import re
from collections import OrderedDict

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn import initializer as JI

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.initializer import _fans
from paddle_tpu_torch.optimizer import AdamW
from test_torch_dropout import FedMasks

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)    # tests/op_test.py, float32
ATTN = dict(rtol=1e-4, atol=1e-5)   # attention reductions (test_torch_train.py)


@pytest.fixture(autouse=True)
def _on_cpu():
    """Layers are built on the default device: the CPU here."""
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return paddle.to_tensor(np.asarray(a))


def _close(got, want, tol=F32):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if hasattr(want, "numpy") else np.asarray(want)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def _carry(jlayer, tlayer):
    load_numpy_state_dict(tlayer, {k: np.asarray(v.numpy())
                                   for k, v in jlayer.state_dict().items()})
    return tlayer


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------
def _nested(pkg):
    return pkg.Sequential(
        ("embed", pkg.Linear(4, 8)),
        ("act", pkg.ReLU()),
        ("blocks", pkg.LayerList([pkg.Linear(8, 8), pkg.LayerNorm(8)])),
        ("heads", pkg.LayerDict({"a": pkg.Linear(8, 2), "b": pkg.Linear(8, 3, bias_attr=False)})))


def test_names_order_and_state_dict_keys_match_reference():
    jm, tm = _nested(jnn), _nested(nn)
    assert [n for n, _ in tm.named_parameters()] == [n for n, _ in jm.named_parameters()]
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [n for n, _ in tm.named_sublayers()] == [n for n, _ in jm.named_sublayers()]
    assert [n for n, _ in tm.named_sublayers(include_self=True)] == \
        [n for n, _ in jm.named_sublayers(include_self=True)]
    assert len(tm.sublayers()) == len(jm.sublayers())
    assert [type(c).__name__ for c in tm.children()] == \
        [type(c).__name__ for c in jm.children()]
    prefixed = list(tm.state_dict(structured_name_prefix="m."))
    assert prefixed == list(jm.state_dict(structured_name_prefix="m."))
    assert list(tm.state_dict(include_sublayers=False)) == \
        list(jm.state_dict(include_sublayers=False)) == []
    x = _np(1, 2, 4)
    _carry(jm, tm)
    _close(tm.heads["a"](tm.blocks[1](tm.blocks[0](tm.act(tm.embed(_t(x)))))),
           jm.heads["a"](jm.blocks[1](jm.blocks[0](jm.act(jm.embed(_j(x)))))))


def test_both_named_parameters_spellings():
    m = _nested(nn)
    paddle_style = [n for n, _ in m.named_parameters("p", False)]
    torch_style = [n for n, _ in m.named_parameters(prefix="p", recurse=False)]
    assert paddle_style == torch_style == []
    deep = [n for n, _ in m.named_parameters(prefix="p", include_sublayers=True)]
    assert deep == [n for n, _ in m.named_parameters("p", recurse=True)] \
        == ["p." + n for n, _ in torch.nn.Module.named_parameters(m)]
    assert isinstance(m.parameters(), list) and isinstance(m.buffers(), list)
    assert len(m.parameters()) == len(list(torch.nn.Module.parameters(m))) == 9
    assert m.blocks[0].parameters(include_sublayers=False) == \
        m.blocks[0].parameters(recurse=False)
    # torch's own callers: an optimizer, state_dict recursion from a torch parent
    torch.optim.SGD(m.parameters(), lr=0.1)
    outer = torch.nn.Sequential(m)
    assert list(outer.state_dict()) == ["0." + k for k in m.state_dict()]


def test_full_name_counts_per_scope():
    a, b = nn.Linear(2, 2), nn.Linear(2, 2)
    na, nb = int(a.full_name().split("_")[-1]), int(b.full_name().split("_")[-1])
    assert re.fullmatch(r"linear_\d+", a.full_name()) and nb == na + 1
    assert nn.Layer(name_scope="block").full_name().startswith("block_")
    assert jnn.Linear(2, 2).full_name().startswith("linear_")


def test_create_parameter_with_param_attr():
    layer = nn.Layer()
    attr = nn.ParamAttr(name="w", initializer=I.Constant(0.5), learning_rate=0.1,
                        trainable=False, need_clip=False, regularizer="l2-later")
    p = layer.create_parameter([2, 3], attr=attr)
    jp = jnn.Layer().create_parameter([2, 3], attr=jnn.ParamAttr(
        name="w", initializer=JI.Constant(0.5), learning_rate=0.1, trainable=False,
        need_clip=False))
    np.testing.assert_array_equal(p.detach().numpy(), jp.numpy())
    assert p.requires_grad is (not jp.stop_gradient) is False
    assert p.optimize_attr == jp.optimize_attr == {"learning_rate": 0.1}
    assert p.need_clip is jp.need_clip is False and p.param_name == "w"
    assert p.regularizer == "l2-later"
    bias = layer.create_parameter([3], is_bias=True)
    assert not bias.any() and bias.requires_grad
    w = layer.create_parameter([64, 32])  # XavierNormal by default
    assert abs(float(w.std()) - math.sqrt(2 / 96)) < 0.02
    with pytest.raises(ValueError, match="attr=False"):
        layer.create_parameter([2], attr=False)
    assert layer.create_parameter([2], attr="name_only").param_name == "name_only"
    assert float(layer.create_parameter([2], attr=I.Constant(3.0))[0]) == 3.0


def test_learning_rate_multiplier_and_need_clip_are_read():
    """The optimizer scales a parameter's step by its ParamAttr learning
    rate, and the global-norm clip leaves ``need_clip=False`` out, as the
    reference's do."""
    lin = nn.Linear(3, 2, weight_attr=nn.ParamAttr(learning_rate=0.0),
                    bias_attr=nn.ParamAttr(need_clip=False))
    w0, b0 = lin.weight.detach().clone(), lin.bias.detach().clone()
    opt = AdamW(0.1, parameters=lin.parameters(), grad_clip=nn.ClipGradByGlobalNorm(1e-6))
    lin(torch.ones(4, 3)).sum().backward()
    opt.step()
    assert torch.equal(lin.weight.detach(), w0)
    # the unclipped bias moves by AdamW's full first step (lr times the sign)
    torch.testing.assert_close(lin.bias.detach(), b0 - 0.1 * 1.0 - 0.1 * 0.01 * b0,
                               rtol=1e-4, atol=1e-4)


def test_attrs_on_layers_and_frozen_weights():
    lin = nn.Linear(4, 3, weight_attr=I.Assign(np.arange(12, dtype=np.float32).reshape(4, 3)),
                    bias_attr=nn.ParamAttr(initializer=I.Constant(0.25), trainable=False))
    jlin = jnn.Linear(4, 3, weight_attr=JI.Assign(np.arange(12, dtype=np.float32).reshape(4, 3)),
                      bias_attr=jnn.ParamAttr(initializer=JI.Constant(0.25), trainable=False))
    x = _np(2, 5, 4)
    _close(lin(_t(x)), jlin(_j(x)))
    assert not lin.bias.requires_grad
    emb = nn.Embedding(6, 4, weight_attr=I.Normal(0.0, 0.5), padding_idx=1)
    assert not emb.weight[1].any()
    ln = nn.LayerNorm(4, weight_attr=False, bias_attr=I.Constant(0.5))
    assert ln.weight is None and float(ln.bias[0]) == 0.5
    with pytest.raises(ValueError, match="attr=False"):
        nn.RMSNorm(4, weight_attr=False)
    cell = nn.GRUCell(3, 2, weight_ih_attr=I.Constant(0.1))
    assert cell.weight_ih.eq(0.1).all()
    assert isinstance(cell, nn.Layer) and isinstance(nn.Linear(1, 1), nn.Layer)


def test_buffers_and_tensor_attributes():
    layer = nn.Layer()
    layer.register_buffer("kept", torch.ones(2))
    layer.register_buffer("scratch", torch.zeros(3), persistable=False)
    layer.register_buffer("torch_style", torch.zeros(1), persistent=False)
    layer.plain = torch.full((2,), 7.0)   # the reference keeps it as a buffer
    layer.add_parameter("p", torch.nn.Parameter(torch.ones(1)))
    layer.add_parameter("q", torch.ones(2, requires_grad=True))
    assert [n for n, _ in layer.named_buffers()] == ["kept", "scratch", "torch_style", "plain"]
    assert list(layer.state_dict()) == ["p", "q", "kept"]
    jl = jnn.Layer()
    jl.register_buffer("kept", paddle.to_tensor(np.ones(2, np.float32)))
    jl.register_buffer("scratch", paddle.to_tensor(np.zeros(3, np.float32)), persistable=False)
    assert list(jl.state_dict()) == ["kept"]
    with pytest.raises(TypeError):
        layer.add_parameter("bad", [1.0])
    with pytest.raises(TypeError):
        layer.add_sublayer("bad", object())
    assert layer.add_sublayer("child", nn.Identity()) is layer.child


def test_set_state_dict_missing_unexpected_and_casts():
    jm, tm = _nested(jnn), _nested(nn)
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    arrays.pop("embed.bias")
    arrays["extra"] = np.zeros(1, np.float32)
    missing, unexpected = tm.set_state_dict(arrays)
    jmiss, junexp = jm.set_state_dict(arrays)
    assert (missing, unexpected) == (jmiss, junexp) == (["embed.bias"], ["extra"])
    np.testing.assert_array_equal(tm.embed.weight.detach().numpy(), arrays["embed.weight"])
    tm.to(dtype="bfloat16")
    tm.set_dict({"embed.weight": arrays["embed.weight"]})
    assert tm.embed.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.load_dict({"embed.weight": np.zeros((2, 2), np.float32)})


def test_train_eval_to_astype_and_dtypes():
    m = _nested(nn)
    m.register_buffer("steps", torch.zeros(1, dtype=torch.int64))
    assert m.training and all(s.training for s in m.sublayers())
    assert m.eval() is m and not any(s.training for s in m.sublayers(include_self=True))
    m.train()
    assert all(s.training for s in m.sublayers(include_self=True))
    assert m.to(dtype="bfloat16") is m and m.embed.weight.dtype == torch.bfloat16
    assert m.steps.dtype == torch.int64 and m.blocks[1]._dtype == torch.bfloat16
    m.astype("float32")
    assert m.embed.weight.dtype == torch.float32
    assert m.half().embed.weight.dtype == torch.float16
    assert m.bfloat16().embed.weight.dtype == torch.bfloat16
    assert m.float().embed.weight.dtype == torch.float32
    m.to(torch.bfloat16)
    assert m.heads["a"].weight.dtype == torch.bfloat16
    m.to("cpu", "float32", blocking=True)
    assert m.heads["a"].weight.dtype == torch.float32 and m.embed._device.type == "cpu"
    ptt.set_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            m.to("gpu")


def test_forward_hooks_and_removal():
    for pkg, tensor in ((jnn, _j), (nn, _t)):
        lin = pkg.Linear(2, 2)
        calls = []
        pre = lin.register_forward_pre_hook(lambda layer, inputs: (inputs[0] * 0,))
        post = lin.register_forward_post_hook(
            lambda layer, inputs, out: calls.append(len(inputs)) or out + 1.0)
        got = np.asarray(lin(tensor(np.ones((1, 2), np.float32))).numpy()
                         if pkg is jnn else lin(tensor(np.ones((1, 2), np.float32))).detach())
        bias = np.asarray(lin.bias.numpy() if pkg is jnn else lin.bias.detach())
        np.testing.assert_allclose(got, bias[None] + 1.0)
        pre.remove()
        post.remove()
        lin(tensor(np.ones((1, 2), np.float32)))
        assert calls == [1]


def test_apply_clear_gradients_and_deepcopy():
    m = _nested(nn)
    seen = []
    m.apply(lambda layer: seen.append(type(layer).__name__))
    assert seen[-1] == "Sequential" and seen.count("Linear") == 4
    m.heads["a"](torch.ones(1, 8)).sum().backward()
    assert m.heads["a"].weight.grad is not None
    m.clear_gradients()
    assert all(p.grad is None for p in m.parameters())
    lin = nn.Linear(2, 2, weight_attr=nn.ParamAttr(learning_rate=0.5, need_clip=False))
    dup = copy.deepcopy(lin)
    assert dup.weight is not lin.weight and torch.equal(dup.weight, lin.weight)
    assert dup.weight.optimize_attr == {"learning_rate": 0.5} and not dup.weight.need_clip
    assert dup.full_name() == lin.full_name()


def test_seed_fixes_the_draws():
    from paddle_tpu_torch.framework import random as prandom

    prandom.seed(5)
    a = nn.Linear(4, 4).weight.detach().clone()
    prandom.seed(5)
    b = nn.Linear(4, 4).weight.detach().clone()
    assert torch.equal(a, b)
    g = torch.Generator().manual_seed(9)
    c = nn.Linear(4, 4, generator=g).weight
    g.manual_seed(9)
    assert torch.equal(c, nn.Linear(4, 4, generator=g).weight)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (8, 4, 3, 3), (6, 2, 5)])
def test_fans_match_reference(shape):
    assert _fans(shape) == JI._fans(shape)


@pytest.mark.parametrize("name,param", [("sigmoid", None), ("linear", None), ("conv2d", None),
                                        ("tanh", None), ("relu", None), ("leaky_relu", None),
                                        ("leaky_relu", 0.2), ("selu", None), ("other", None)])
def test_calculate_gain_matches_reference(name, param):
    assert I.calculate_gain(name, param) == JI.calculate_gain(name, param)


DETERMINISTIC = {
    "constant": (lambda m: m.Constant(0.3), (3, 4)),
    "assign": (lambda m: m.Assign(np.arange(6, dtype=np.float32).reshape(2, 3) / 7), (2, 3)),
    "dirac": (lambda m: m.Dirac(), (4, 2, 3, 3)),
    "dirac_groups": (lambda m: m.Dirac(groups=2), (6, 3, 3)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_initializers_bit_for_bit(name, dtype):
    make, shape = DETERMINISTIC[name]
    got = make(I)(shape, getattr(torch, dtype))
    want = np.asarray(make(JI)(shape, dtype, None).astype("float32"))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_assign_checks_shape():
    with pytest.raises(ValueError, match="shape mismatch"):
        I.Assign(np.zeros((2, 2)))((3,), torch.float32)


N = 200_000


def _moments(t):
    t = t.double().flatten()
    return float(t.mean()), float(t.std())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normal_and_uniform_laws(dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    mean, std = _moments(I.Normal(1.0, 2.0)((N,), dt, g))
    assert abs(mean - 1.0) < 5 * 2.0 / math.sqrt(N) + 0.01 and abs(std - 2.0) < 0.02
    u = I.Uniform(-0.5, 1.5)((N,), dt, g)
    assert float(u.min()) >= -0.5 and float(u.max()) <= 1.5
    mean, std = _moments(u)
    assert abs(mean - 0.5) < 0.01 and abs(std - 2 / math.sqrt(12)) < 0.01


def test_truncated_normal_law():
    g = torch.Generator().manual_seed(1)
    t = I.TruncatedNormal(0.5, 2.0, a=-2.0, b=1.0)((N,), torch.float32, g)
    assert float(t.min()) >= 0.5 - 4.0 and float(t.max()) <= 0.5 + 2.0
    # the standard normal cut at [-2, 1]: its mean and standard deviation
    phi = lambda z: math.exp(-z * z / 2) / math.sqrt(2 * math.pi)  # noqa: E731
    cdf = lambda z: 0.5 * (1 + math.erf(z / math.sqrt(2)))  # noqa: E731
    z = cdf(1.0) - cdf(-2.0)
    m = (phi(-2.0) - phi(1.0)) / z
    s = math.sqrt(1 + (-2.0 * phi(-2.0) - 1.0 * phi(1.0)) / z - m * m)
    mean, std = _moments(t)
    assert abs(mean - (0.5 + 2 * m)) < 0.01 and abs(std - 2 * s) < 0.01
    jt = np.asarray(JI.TruncatedNormal(0.5, 2.0, a=-2.0, b=1.0)(
        (N,), "float32", __import__("jax").random.PRNGKey(0)))
    assert abs(jt.mean() - mean) < 0.02 and abs(jt.std() - std) < 0.02


FAN_LAWS = {  # initializer, law: ("normal", std) or ("uniform", limit), from the fans
    "xavier_normal": (lambda m: m.XavierNormal(), lambda fi, fo: ("normal", math.sqrt(2 / (fi + fo)))),
    "xavier_uniform": (lambda m: m.XavierUniform(gain=2.0),
                       lambda fi, fo: ("uniform", 2.0 * math.sqrt(6 / (fi + fo)))),
    "xavier_given_fans": (lambda m: m.XavierNormal(fan_in=10, fan_out=30),
                          lambda fi, fo: ("normal", math.sqrt(2 / 40))),
    "kaiming_normal": (lambda m: m.KaimingNormal(), lambda fi, fo: ("normal", math.sqrt(2 / fi))),
    "kaiming_uniform": (lambda m: m.KaimingUniform(negative_slope=0.1, nonlinearity="leaky_relu"),
                        lambda fi, fo: ("uniform", math.sqrt(2 / 1.01) * math.sqrt(3 / fi))),
    "kaiming_tanh": (lambda m: m.KaimingNormal(nonlinearity="tanh"),
                     lambda fi, fo: ("normal", 5 / 3 / math.sqrt(fi))),
}


@pytest.mark.parametrize("shape", [(400, 300), (64, 32, 3, 3)])
@pytest.mark.parametrize("name", sorted(FAN_LAWS))
def test_fan_initializer_laws(name, shape):
    make, law = FAN_LAWS[name]
    fi, fo = _fans(shape)
    kind, scale = law(fi, fo)
    w = make(I)(shape, torch.float32, torch.Generator().manual_seed(2))
    jw = np.asarray(make(JI)(shape, "float32", __import__("jax").random.PRNGKey(2)))
    for sample in (w.numpy(), jw):
        if kind == "normal":
            assert abs(sample.std() - scale) < 0.02 * scale
        else:
            assert np.abs(sample).max() <= scale and abs(sample.std() - scale / math.sqrt(3)) \
                < 0.02 * scale


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 2, 2)])
def test_orthogonal_law(shape):
    w = I.Orthogonal(gain=1.5)(shape, torch.float32, torch.Generator().manual_seed(3))
    rows, cols = shape[0], int(np.prod(shape[1:]))
    m = w.reshape(rows, cols).double() / 1.5
    gram = m.T @ m if rows >= cols else m @ m.T
    torch.testing.assert_close(gram, torch.eye(min(rows, cols), dtype=torch.float64),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        I.Orthogonal()((3,), torch.float32)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------
def test_sequential_forms_and_indexing():
    a, b, c = nn.Linear(3, 4), nn.ReLU(), nn.Linear(4, 2)
    s = nn.Sequential(a, b, c)
    assert list(s._modules) == ["0", "1", "2"] and s[0] is a and s[-1] is c and len(s) == 3
    assert isinstance(s[1:], nn.Sequential) and len(s[1:]) == 2 and list(s) == [a, b, c]
    named = nn.Sequential(OrderedDict([("x", a), ("y", c)]))
    assert list(named._modules) == ["x", "y"]
    pairs = nn.Sequential(("x", a), ("y", b))
    assert list(pairs._modules) == ["x", "y"]
    js = jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(), jnn.Linear(4, 2))
    _carry(js, s)
    x = _np(3, 5, 3)
    _close(s(_t(x)), js(_j(x)))


def test_layer_list_and_dict_and_parameter_list():
    ll = nn.LayerList([nn.Linear(2, 2)])
    ll.append(nn.ReLU()).extend([nn.Identity()])
    ll.insert(1, nn.Tanh())
    assert [type(x).__name__ for x in ll] == ["Linear", "Tanh", "ReLU", "Identity"]
    assert list(ll._modules) == ["0", "1", "2", "3"] and len(ll[1:3]) == 2
    ll[3] = nn.Sigmoid()
    assert type(ll[-1]).__name__ == "Sigmoid"
    jl = jnn.LayerList([jnn.Linear(2, 2)])
    jl.append(jnn.ReLU()).extend([jnn.Identity()])
    jl.insert(1, jnn.Tanh())
    assert [type(x).__name__ for x in jl][:3] == [type(x).__name__ for x in ll][:3]
    ld = nn.LayerDict({"a": nn.Linear(2, 2)})
    ld["b"] = nn.ReLU()
    ld.update([("c", nn.Tanh())])
    assert list(ld.keys()) == ["a", "b", "c"] and "b" in ld and len(ld) == 3
    assert type(ld.pop("b")).__name__ == "ReLU" and list(ld) == ["a", "c"]
    del ld["c"]
    assert list(ld.items())[0][0] == "a"
    ld.clear()
    assert len(ld) == 0
    pl = nn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and pl[1].shape == (3,) and [n for n, _ in pl.named_parameters()] \
        == ["0", "1"] and len(list(iter(pl))) == 2


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
ACTS = [  # functional, keyword arguments
    ("relu", {}), ("relu6", {}), ("sigmoid", {}), ("tanh", {}), ("softplus", {}),
    ("softsign", {}), ("silu", {}), ("log_sigmoid", {}), ("swish", {}), ("mish", {}),
    ("hardswish", {}), ("hardsigmoid", {}), ("hardtanh", {}),
    ("hardtanh", dict(min=-0.5, max=0.7)), ("elu", {}), ("elu", dict(alpha=0.5)),
    ("selu", {}), ("celu", dict(alpha=1.5)), ("tanhshrink", {}),
    ("leaky_relu", dict(negative_slope=0.2)), ("hardshrink", dict(threshold=0.3)),
    ("softshrink", dict(threshold=0.4)), ("thresholded_relu", dict(threshold=0.5, value=0.1)),
    ("softmax", dict(axis=1)), ("log_softmax", {}), ("glu", {}), ("glu", dict(axis=1)),
    ("maxout", dict(groups=2)), ("maxout", dict(groups=3, axis=-1)), ("gelu", {}),
    ("gelu", dict(approximate=True)), ("rrelu", dict(training=False)),
    ("rrelu", dict(lower=0.1, upper=0.3, training=False)),
]


@pytest.mark.parametrize("name,kw", ACTS, ids=[f"{n}-{'-'.join(map(str, k.values()))}"
                                               for n, k in ACTS])
def test_activation_functional_matches_reference(name, kw):
    x = _np(4, 3, 4, 6, scale=2.0)
    _close(getattr(F, name)(_t(x), **kw), getattr(JF, name)(_j(x), **kw))


def test_prelu_functional_and_rrelu_training(monkeypatch):
    x = _np(5, 2, 3, 4)
    for w in (np.array([0.2], np.float32), np.array([0.1, 0.2, 0.3], np.float32)):
        _close(F.prelu(_t(x), _t(w)), JF.prelu(_j(x), _j(w)))
    w4 = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    _close(F.prelu(_t(x), _t(w4), data_format="NHWC"), JF.prelu(_j(x), _j(w4), data_format="NHWC"))
    fed = FedMasks(monkeypatch, seed=5, uniform=True)   # the same slopes to both
    _close(F.rrelu(_t(x)), JF.rrelu(_j(x)))
    fed.check_same_draws(1)
    with pytest.raises(ValueError):
        F.rrelu(_t(x), 0.5, 0.2, training=False)


LAYER_ACTS = [  # layer, positional arguments
    ("ReLU", ()), ("ReLU6", ()), ("GELU", (True,)), ("SiLU", ()), ("Swish", ()), ("Mish", ()),
    ("Sigmoid", ()), ("Tanh", ()), ("Softmax", (1,)), ("LogSoftmax", (-1,)),
    ("LeakyReLU", (0.3,)), ("ELU", (0.7,)), ("SELU", ()), ("CELU", (0.8,)), ("Hardswish", ()),
    ("Hardsigmoid", ()), ("Hardtanh", (-0.4, 0.6)), ("Hardshrink", (0.2,)),
    ("Softshrink", (0.3,)), ("Softplus", ()), ("Softsign", ()), ("Tanhshrink", ()),
    ("ThresholdedReLU", (0.4, 0.05)), ("Maxout", (2, 1)), ("GLU", (1,)), ("LogSigmoid", ()),
    ("Silu", ()), ("Softmax2D", ()),
]


@pytest.mark.parametrize("name,args", LAYER_ACTS, ids=[n for n, _ in LAYER_ACTS])
def test_activation_layer_matches_reference(name, args):
    x = _np(6, 2, 4, 3, 2, scale=2.0)
    _close(getattr(nn, name)(*args)(_t(x)), getattr(jnn, name)(*args)(_j(x)))


def test_prelu_and_rrelu_layers(monkeypatch):
    x = _np(7, 2, 4, 3)
    _close(_carry(jnn.PReLU(4, 0.1), nn.PReLU(4, 0.1))(_t(x)), jnn.PReLU(4, 0.1)(_j(x)))
    assert nn.PReLU(3, 0.2).weight.eq(0.2).all()
    r, jr = nn.RReLU(0.1, 0.3).eval(), jnn.RReLU(0.1, 0.3)
    jr.eval()
    _close(r(_t(x)), jr(_j(x)))
    fed = FedMasks(monkeypatch, seed=7, uniform=True)
    jr.train()
    _close(r.train()(_t(x)), jr(_j(x)))
    fed.check_same_draws(1)
    with pytest.raises(ValueError, match="3-D or 4-D"):
        nn.Softmax2D()(_t(x[0, 0]))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _probs(seed, *shape):
    p = np.random.default_rng(seed).random(shape).astype(np.float32)
    return np.clip(p, 0.05, 0.95)


def _logp(seed, n, c):
    x = _np(seed, n, c)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _pm1(seed, *shape):
    return np.where(np.random.default_rng(seed).random(shape) > 0.5, 1.0, -1.0).astype(np.float32)


W5 = np.array([0.5, 1.0, 2.0, 1.5, 0.7], np.float32)
LOSSES = {  # name: (layer, constructor kwargs, inputs)
    "ce_hard": ("CrossEntropyLoss", {}, lambda: (_np(1, 6, 5), np.array([0, 4, 2, -100, 1, 3]))),
    "ce_label_axis": ("CrossEntropyLoss", dict(axis=1),
                      lambda: (_np(2, 2, 5, 3), np.array([[[0, 1, 4]], [[2, 3, 0]]]))),
    "ce_weight": ("CrossEntropyLoss", dict(weight="W5"),
                  lambda: (_np(3, 6, 5), np.array([0, 4, 2, -100, 1, 3]))),
    "ce_soft": ("CrossEntropyLoss", dict(soft_label=True),
                lambda: (_np(4, 4, 5), np.random.default_rng(5).dirichlet(np.ones(5), 4)
                         .astype(np.float32))),
    "ce_smooth": ("CrossEntropyLoss", dict(label_smoothing=0.1),
                  lambda: (_np(6, 6, 5), np.array([0, 4, 2, 3, 1, 3]))),
    "ce_probs": ("CrossEntropyLoss", dict(use_softmax=False),
                 lambda: (np.random.default_rng(7).dirichlet(np.ones(5), 4).astype(np.float32),
                          np.array([1, 0, 4, 2]))),
    "mse": ("MSELoss", {}, lambda: (_np(8, 3, 4), _np(9, 3, 4))),
    "l1": ("L1Loss", {}, lambda: (_np(10, 3, 4), _np(11, 3, 4))),
    "smooth_l1": ("SmoothL1Loss", dict(delta=0.5), lambda: (_np(12, 3, 4), _np(13, 3, 4))),
    "nll": ("NLLLoss", {}, lambda: (_logp(14, 6, 5), np.array([0, 4, 2, -100, 1, 3]))),
    "nll_weight": ("NLLLoss", dict(weight="W5", ignore_index=2),
                   lambda: (_logp(15, 6, 5), np.array([0, 4, 2, 2, 1, 3]))),
    "bce": ("BCELoss", {}, lambda: (_probs(16, 3, 4), _probs(17, 3, 4).round())),
    "bce_weight": ("BCELoss", dict(weight="W4"), lambda: (_probs(18, 3, 4), _probs(19, 3, 4))),
    "bce_logits": ("BCEWithLogitsLoss", dict(pos_weight="W4"),
                   lambda: (_np(20, 3, 4, scale=3.0), _probs(21, 3, 4).round())),
    "kl": ("KLDivLoss", {}, lambda: (_logp(22, 3, 5), _probs(23, 3, 5))),
    "kl_log_target": ("KLDivLoss", dict(log_target=True),
                      lambda: (_logp(24, 3, 5), _logp(25, 3, 5))),
    "margin_ranking": ("MarginRankingLoss", dict(margin=0.2),
                       lambda: (_np(26, 6), _np(27, 6), _pm1(28, 6))),
    "cosine_embedding": ("CosineEmbeddingLoss", dict(margin=0.1),
                         lambda: (_np(29, 4, 6), _np(30, 4, 6), _pm1(31, 4))),
    "gaussian_nll": ("GaussianNLLLoss", {},
                     lambda: (_np(32, 3, 4), _np(33, 3, 4), _probs(34, 3, 4))),
    "gaussian_nll_full": ("GaussianNLLLoss", dict(full=True),
                          lambda: (_np(35, 3, 4), _np(36, 3, 4), _probs(37, 3, 4))),
    "poisson_nll": ("PoissonNLLLoss", {}, lambda: (_np(38, 3, 4), _probs(39, 3, 4) * 4)),
    "poisson_nll_rate_full": ("PoissonNLLLoss", dict(log_input=False, full=True),
                              lambda: (_probs(40, 3, 4) * 3, np.floor(_probs(41, 3, 4) * 5))),
    "hinge_embedding": ("HingeEmbeddingLoss", dict(margin=0.5),
                        lambda: (_np(42, 3, 4), _pm1(43, 3, 4))),
    "soft_margin": ("SoftMarginLoss", {}, lambda: (_np(44, 3, 4), _pm1(45, 3, 4))),
    "multi_label_soft_margin": ("MultiLabelSoftMarginLoss", dict(weight="W4"),
                                lambda: (_np(46, 3, 4), _probs(47, 3, 4).round())),
    "multi_margin": ("MultiMarginLoss", {}, lambda: (_np(48, 4, 5), np.array([0, 4, 2, 1]))),
    "multi_margin_p2_weight": ("MultiMarginLoss", dict(p=2, margin=0.5, weight="W5"),
                               lambda: (_np(49, 4, 5), np.array([3, 1, 2, 0]))),
    "triplet": ("TripletMarginLoss", {}, lambda: (_np(50, 4, 6), _np(51, 4, 6), _np(52, 4, 6))),
    "triplet_swap_p1": ("TripletMarginLoss", dict(p=1.0, swap=True, margin=0.5),
                        lambda: (_np(53, 4, 6), _np(54, 4, 6), _np(55, 4, 6))),
    "triplet_distance": ("TripletMarginWithDistanceLoss", dict(distance_function="l1"),
                         lambda: (_np(56, 4, 6), _np(57, 4, 6), _np(58, 4, 6))),
    "triplet_distance_default": ("TripletMarginWithDistanceLoss", dict(swap=True),
                                 lambda: (_np(59, 4, 6), _np(60, 4, 6), _np(61, 4, 6))),
}
CONST = {"W5": W5, "W4": np.array([0.5, 1.0, 2.0, 1.5], np.float32)}


def _kw(kw, wrap):
    out = {}
    for k, v in kw.items():
        if v in CONST:
            v = wrap(CONST[v])
        elif v == "l1":
            v = lambda a, b: (a - b).abs().sum(-1)  # noqa: E731
        out[k] = v
    return out


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_reference(name, reduction):
    layer, kw, inputs = LOSSES[name]
    args = inputs()
    got = getattr(nn, layer)(reduction=reduction, **_kw(kw, _t))(*map(_t, args))
    want = getattr(jnn, layer)(reduction=reduction, **_kw(kw, _j))(*map(_j, args))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_kl_batchmean_and_loss_buffers():
    a, b = _logp(62, 3, 5), _probs(63, 3, 5)
    _close(nn.KLDivLoss("batchmean")(_t(a), _t(b)), jnn.KLDivLoss("batchmean")(_j(a), _j(b)))
    ce = nn.CrossEntropyLoss(weight=_t(W5))
    assert "weight" in dict(ce.named_buffers()) and not ce.state_dict()


CTC = {  # input lengths, label lengths
    "full": ([12, 12, 12], [4, 4, 4]),
    "ragged": ([12, 9, 7], [4, 2, 3]),
    "zero_length_label": ([12, 10, 8], [4, 0, 2]),
}


@pytest.mark.parametrize("norm_by_times", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CTC))
def test_ctc_loss_matches_reference(case, reduction, norm_by_times):
    in_len, lab_len = (np.array(v, np.int64) for v in CTC[case])
    logits = _np(64, 12, 3, 6, scale=2.0)
    labels = np.random.default_rng(65).integers(1, 6, (3, 4))
    got = nn.CTCLoss(blank=0, reduction=reduction)(_t(logits), _t(labels), _t(in_len),
                                                   _t(lab_len), norm_by_times)
    want = jnn.CTCLoss(blank=0, reduction=reduction)(_j(logits), _j(labels), _j(in_len),
                                                     _j(lab_len), norm_by_times)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))


def test_pairwise_distance_and_cosine_similarity():
    x, y = _np(66, 4, 6), _np(67, 4, 6)
    for p, keep in ((2.0, False), (1.0, True), (3.0, False)):
        _close(nn.PairwiseDistance(p, keepdim=keep)(_t(x), _t(y)),
               jnn.PairwiseDistance(p, keepdim=keep)(_j(x), _j(y)))
    for axis in (1, -1, 0):
        _close(nn.CosineSimilarity(axis)(_t(x), _t(y)), jnn.CosineSimilarity(axis)(_j(x), _j(y)))


def test_flatten_unflatten_identity():
    x = _np(68, 2, 3, 4, 5)
    assert tuple(nn.Flatten()(_t(x)).shape) == (2, 60)
    assert tuple(nn.Flatten(0, 1)(_t(x)).shape) == tuple(jnn.Flatten(0, 1)(_j(x)).shape)
    assert tuple(nn.Unflatten(-1, [5, 1])(_t(x)).shape) == \
        tuple(jnn.Unflatten(-1, [5, 1])(_j(x)).shape) == (2, 3, 4, 5, 1)
    assert nn.Identity(3, foo=1)(_t(x)) is not None


# ---------------------------------------------------------------------------
# transformer layers
# ---------------------------------------------------------------------------
D, HEADS, FF, B, S = 16, 4, 32, 2, 6


def _pad_mask(lengths, s):
    keep = np.arange(s)[None, :] < np.asarray(lengths)[:, None]
    return ((1.0 - keep)[:, None, None, :] * np.finfo(np.float32).min).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_multi_head_attention_matches_reference(kind, masked):
    paddle.seed(70)
    kdim = D if kind == "self" else 12
    jm = jnn.MultiHeadAttention(D, HEADS, kdim=kdim, vdim=kdim)
    tm = _carry(jm, nn.MultiHeadAttention(D, HEADS, kdim=kdim, vdim=kdim)).eval()
    jm.eval()
    q = _np(71, B, S, D)
    kv = q if kind == "self" else _np(72, B, S + 3, kdim)
    mask = _pad_mask([S, S - 2], kv.shape[1]) if masked else None
    got = tm(_t(q), _t(kv), _t(kv), None if mask is None else _t(mask))
    want = jm(_j(q), _j(kv), _j(kv), None if mask is None else _j(mask))
    _close(got, want, ATTN)


def test_multi_head_attention_caches():
    paddle.seed(73)
    jm = jnn.MultiHeadAttention(D, HEADS)
    tm = _carry(jm, nn.MultiHeadAttention(D, HEADS)).eval()
    jm.eval()
    x = _np(74, B, S, D)
    jc, tc = jm.gen_cache(_j(x)), tm.gen_cache(_t(x))
    assert tuple(tc.k.shape) == tuple(jc.k.shape) == (B, 0, HEADS, D // HEADS)
    for step in range(2):
        xs = x[:, step * 3:(step + 1) * 3]
        jout, jc = jm(_j(xs), cache=jc)
        tout, tc = tm(_t(xs), cache=tc)
        _close(tout, jout, ATTN)
        _close(tc.k, jc.k, F32)
        _close(tc.v, jc.v, F32)
    mem = _np(75, B, S + 2, D)
    js = jm.gen_cache(_j(mem), _j(mem), jnn.MultiHeadAttention.StaticCache)
    ts = tm.gen_cache(_t(mem), _t(mem), nn.MultiHeadAttention.StaticCache)
    _close(ts.k, js.k, F32)
    _close(tm(_t(x), cache=ts), jm(_j(x), cache=js), ATTN)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_matches_reference(normalize_before, masked, activation):
    paddle.seed(76)
    kw = dict(dropout=0.0, activation=activation, normalize_before=normalize_before)
    jm = jnn.TransformerEncoderLayer(D, HEADS, FF, **kw)
    tm = _carry(jm, nn.TransformerEncoderLayer(D, HEADS, FF, **kw))
    x = _np(77, B, S, D)
    mask = _pad_mask([S, 3], S) if masked else None
    got = tm(_t(x), None if mask is None else _t(mask))
    want = jm(_j(x), None if mask is None else _j(mask))
    _close(got, want, ATTN)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_with_norm_and_cache(normalize_before):
    paddle.seed(78)
    layer = jnn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.0,
                                        normalize_before=normalize_before)
    jm = jnn.TransformerEncoder(layer, 3, jnn.LayerNorm(D))
    tlayer = nn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.0,
                                        normalize_before=normalize_before)
    tm = _carry(jm, nn.TransformerEncoder(tlayer, 3, nn.LayerNorm(D)))
    assert list(tm.state_dict()) == list(jm.state_dict())
    x = _np(79, B, S, D)
    _close(tm(_t(x)), jm(_j(x)), ATTN)
    jout, jcache = jm(_j(x), cache=jm.gen_cache(_j(x)))
    tout, tcache = tm(_t(x), cache=tm.gen_cache(_t(x)))
    _close(tout, jout, ATTN)
    assert len(tcache) == len(jcache) == 3
    _close(tcache[2].v, jcache[2].v, ATTN)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_and_transformer_match_reference(normalize_before):
    paddle.seed(80)
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    jm = jnn.Transformer(D, HEADS, 2, 2, FF, **kw)
    tm = _carry(jm, nn.Transformer(D, HEADS, 2, 2, FF, **kw))
    src, tgt = _np(81, B, S, D), _np(82, B, S - 2, D)
    jmask = jnn.Transformer.generate_square_subsequent_mask(S - 2)
    tmask = nn.Transformer.generate_square_subsequent_mask(S - 2)
    np.testing.assert_array_equal(tmask.numpy(), jmask.numpy())
    mem_mask = _pad_mask([S, 4], S)
    got = tm(_t(src), _t(tgt), tgt_mask=tmask, memory_mask=_t(mem_mask))
    want = jm(_j(src), _j(tgt), tgt_mask=jmask, memory_mask=_j(mem_mask))
    _close(got, want, ATTN)
    jdec, tdec = jm.decoder.layers[0], tm.decoder.layers[0]
    mem = _np(83, B, S, D)
    _close(tdec(_t(tgt), _t(mem), tmask), jdec(_j(tgt), _j(mem), jmask), ATTN)


def test_transformer_dropout_in_training_raises_a9(monkeypatch):
    """Dropout 0.1 in training (no longer refused): the encoder and
    decoder layers (post- and pre-norm) and attention against the
    reference's with the same masks, drawn in the reference's order; eval
    draws none."""
    x, mem = _np(84, B, S, D), _np(85, B, S + 2, D)
    mask = _pad_mask([S, 3], S)
    for normalize_before in (False, True):
        paddle.seed(84)
        kw = dict(normalize_before=normalize_before)
        jenc, jdec = jnn.TransformerEncoderLayer(D, HEADS, FF, **kw), \
            jnn.TransformerDecoderLayer(D, HEADS, FF, **kw)
        enc = _carry(jenc, nn.TransformerEncoderLayer(D, HEADS, FF, **kw))
        dec = _carry(jdec, nn.TransformerDecoderLayer(D, HEADS, FF, **kw))
        fed = FedMasks(monkeypatch, seed=84)
        _close(enc(_t(x), _t(mask)), jenc(_j(x), _j(mask)), ATTN)
        # attention probabilities, dropout1, act_dropout, dropout2
        assert [shape for _, shape, _ in fed.port] == [(B, HEADS, S, S), (B, S, D),
                                                       (B, S, FF), (B, S, D)]
        _close(dec(_t(x), _t(mem)), jdec(_j(x), _j(mem)), ATTN)
        fed.check_same_draws(4 + 6)
    jattn = jnn.MultiHeadAttention(D, HEADS, dropout=0.1)
    attn = _carry(jattn, nn.MultiHeadAttention(D, HEADS, dropout=0.1))
    _close(attn(_t(x)), jattn(_j(x)), ATTN)
    fed.check_same_draws(11)
    enc.eval()
    assert tuple(enc(_t(x)).shape) == (B, S, D)
    fed.check_same_draws(11)


def test_layers_are_built_on_the_default_device():
    ptt.set_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            nn.TransformerEncoderLayer(D, HEADS, FF)
    assert nn.Linear(2, 2, device="cpu").weight.device.type == "cpu"
    assert nn.GRUCell(2, 2, generator=torch.Generator()).weight_ih.device.type == "cpu"
