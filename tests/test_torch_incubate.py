"""The rest of ``incubate`` in the port against the JAX package, on the
CPU: the fused functionals of ``incubate.nn.functional``, the fused layers
of ``incubate.nn`` with the JAX layers' weights carried across
(``convert.py``), and ``incubate.asp``.  Where a functional drops, both
packages are fed the same masks (``test_torch_dropout.FedMasks``) and
must ask for the same shapes.  Values and gradients within the f32 rows
of ``tests/op_test.py`` (attention within the attention rows of
``test_torch_train.py``), bf16 within its bf16 row; the ASP masks are
numpy in both packages and equal bit for bit.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jinc
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu.incubate import asp as jasp
import paddle_tpu.nn as jnn

import paddle_tpu_torch as ptt
import paddle_tpu_torch.incubate.nn as inc
import paddle_tpu_torch.incubate.nn.functional as IF
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.incubate import asp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import SGD, AdamW
from test_torch_dropout import FedMasks

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)        # tests/op_test.py, float32
GRAD = dict(rtol=5e-3, atol=1e-4)       # tests/op_test.py, float32 gradients
ATTN = dict(rtol=1e-4, atol=1e-5)       # attention reductions (test_torch_train.py)
ATTN_BWD = dict(rtol=1e-4, atol=1e-4)   # attention grads (test_torch_train.py)
BF16 = dict(rtol=2e-2, atol=2e-2)       # tests/op_test.py, bfloat16
B, S, E, HEADS, FF = 2, 8, 32, 4, 64


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)
    asp.ASPHelper.reset()
    jasp.ASPHelper.reset()


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _outs(v):
    return list(v) if isinstance(v, (tuple, list)) else [v]


def _check(port_fn, ref_fn, arrays, tol=F32, grad_tol=GRAD):
    """Outputs (each of a tuple; None where the reference gives None) and
    the gradients of every input under one cosine cotangent an output."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    js = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    got, want = _outs(port_fn(*ts)), _outs(ref_fn(*js))
    assert len(got) == len(want)
    loss, jloss = 0, 0
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w.numpy()), **tol)
        cot = np.cos(np.arange(g.numel(), dtype=np.float32)).reshape(g.shape)
        loss = loss + (g * torch.from_numpy(cot)).sum()
        jloss = jloss + (w * paddle.to_tensor(cot)).sum()
    loss.backward()
    jloss.backward()
    for i, (t, j) in enumerate(zip(ts, js)):
        if j.grad is None:
            assert t.grad is None or not t.grad.any(), i
            continue
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.numpy()), **grad_tol,
                                   err_msg=f"grad of input {i}")


# ---------------------------------------------------------------------------
# the functionals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, {"bias": 1}, {"residual": 1}, {"bias": 1, "residual": 1},
                                {"norm_bias": 1}], ids=str)
def test_fused_rms_norm(kw):
    arrays = [_np(1, 6, 32), 1 + _np(2, 32)]
    names = [k for k in ("bias", "residual", "norm_bias") if k in kw]
    shapes = {"bias": (32,), "residual": (6, 32), "norm_bias": (32,)}
    arrays += [_np(3 + i, *shapes[n]) for i, n in enumerate(names)]

    def call(fn):
        return lambda x, w, *rest: fn(x, w, epsilon=1e-6, **dict(zip(names, rest)))

    _check(call(IF.fused_rms_norm), call(JIF.fused_rms_norm), arrays)
    out = IF.fused_rms_norm(*[torch.from_numpy(a) for a in arrays[:2]],
                            residual=torch.from_numpy(arrays[0]))
    assert isinstance(out, tuple) and torch.equal(out[1], 2 * torch.from_numpy(arrays[0]))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("flag", [False, True])
def test_fused_layer_norm_residual_returns_out_and_pre(residual, flag):
    arrays = [_np(5, 6, 32), 1 + _np(6, 32), _np(7, 32), _np(8, 32)]
    if residual:
        arrays.append(_np(9, 6, 32))

    def call(fn):
        return lambda x, w, b, bias, *r: fn(x, w, b, 1e-5, bias=bias,
                                            residual=r[0] if r else None)

    with ptt.flag_guard(use_fused_layernorm=flag):
        _check(call(IF.fused_layer_norm), call(JIF.fused_layer_norm), arrays)


@pytest.mark.parametrize("case", ["q", "qk", "qkv", "tables", "positions"])
def test_fused_rotary_position_embedding(case):
    arrays = [_np(10, B, S, HEADS, 16)]
    if case in ("qk", "qkv"):
        arrays.append(_np(11, B, S, 2, 16))
    if case == "qkv":
        arrays.append(_np(12, B, S, 2, 16))
    kw, jkw = {}, {}
    if case == "tables":
        ang = _np(13, S, 16)
        kw = dict(sin=torch.from_numpy(np.sin(ang)), cos=torch.from_numpy(np.cos(ang)))
        jkw = dict(sin=paddle.to_tensor(np.sin(ang)), cos=paddle.to_tensor(np.cos(ang)))
    if case == "positions":
        pos = np.arange(S)[::-1].copy()
        kw, jkw = dict(position_ids=pos), dict(position_ids=pos)
    _check(lambda *t: IF.fused_rotary_position_embedding(*t, **kw),
           lambda *j: JIF.fused_rotary_position_embedding(*j, **jkw), arrays)
    with pytest.raises(NotImplementedError, match="neox"):
        IF.fused_rotary_position_embedding(torch.zeros(1, 2, 1, 4), use_neox_rotary_style=False)


@pytest.mark.parametrize("tx,ty,bias", [(False, False, True), (True, False, False),
                                        (False, True, True), (True, True, True)])
def test_fused_matmul_bias_and_linear(tx, ty, bias):
    x = _np(14, 3, 5, 4) if not tx else _np(14, 3, 4, 5)
    y = _np(15, 4, 6) if not ty else _np(15, 6, 4)
    arrays = [x, y] + ([_np(16, 6)] if bias else [])
    _check(lambda a, b, *c: IF.fused_matmul_bias(a, b, *c, transpose_x=tx, transpose_y=ty),
           lambda a, b, *c: JIF.fused_matmul_bias(a, b, *c, transpose_x=tx, transpose_y=ty),
           arrays)
    if not tx:
        _check(lambda a, b, *c: IF.fused_linear(a, b, *c, transpose_weight=ty),
               lambda a, b, *c: JIF.fused_linear(a, b, *c, transpose_weight=ty), arrays)


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "swish", "sigmoid", "tanh", "none",
                                 "identity"])
def test_fused_linear_activation(act):
    _check(lambda x, y, b: IF.fused_linear_activation(x, y, b, activation=act),
           lambda x, y, b: JIF.fused_linear_activation(x, y, b, activation=act),
           [_np(17, 3, 8), _np(18, 8, 6), _np(19, 6)])


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "sigmoid", "tanh", "swiglu",
                                 "silu_glu", "geglu", "gelu_glu"])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_bias_act(act, bias):
    arrays = [_np(20, 3, 8)] + ([_np(21, 8)] if bias else [])
    _check(lambda x, *b: IF.fused_bias_act(x, *b, act_method=act),
           lambda x, *b: JIF.fused_bias_act(x, *b, act_method=act), arrays)
    with pytest.raises(NotImplementedError, match="quantized"):
        IF.fused_bias_act(torch.zeros(2, 4), quant_scale=1.0)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_fused_dropout_add(monkeypatch, mode, training):
    fed = FedMasks(monkeypatch, seed=22)
    _check(lambda x, y: IF.fused_dropout_add(x, y, 0.3, training=training, mode=mode),
           lambda x, y: JIF.fused_dropout_add(x, y, 0.3, training=training, mode=mode),
           [_np(22, 4, 10), _np(23, 4, 10)])
    fed.check_same_draws(1 if training else 0)


@pytest.mark.parametrize("case", ["plain", "causal", "masked", "dropout", "eval"])
def test_fused_dot_product_attention(monkeypatch, case):
    fed = FedMasks(monkeypatch, seed=24)
    arrays = [_np(24 + i, B, S, HEADS, 8) for i in range(3)]
    mask = None
    if case == "masked":
        mask = np.zeros((B, 1, 1, S), np.float32)
        mask[1, ..., 5:] = np.finfo(np.float32).min
    kw = dict(is_causal=case == "causal", dropout_p=0.2 if case in ("dropout", "eval") else 0.0,
              training=case != "eval")
    _check(lambda *t: IF.fused_dot_product_attention(
               *t, attn_mask=None if mask is None else torch.from_numpy(mask), **kw),
           lambda *j: JIF.fused_dot_product_attention(
               *j, attn_mask=None if mask is None else paddle.to_tensor(mask), **kw),
           arrays, ATTN, ATTN_BWD)
    fed.check_same_draws(1 if case == "dropout" else 0)


def _mha_arrays(seed, transpose_qkv_wb=False):
    qkv = _np(seed, E, 3 * E) if transpose_qkv_wb else _np(seed, 3, HEADS, E // HEADS, E)
    return [_np(seed + 1, B, S, E), 0.2 * qkv, 0.2 * _np(seed + 2, E, E),
            _np(seed + 3, 3 * E) if transpose_qkv_wb else _np(seed + 3, 3, HEADS, E // HEADS),
            _np(seed + 4, E), 1 + _np(seed + 5, E), _np(seed + 6, E)]


@pytest.mark.parametrize("pre_ln,transpose,masked,drop", [
    (False, False, False, (0.0, 0.0)), (True, False, True, (0.1, 0.0)),
    (False, True, False, (0.1, 0.2)), (True, True, True, (0.0, 0.2))])
def test_fused_multi_head_attention(monkeypatch, pre_ln, transpose, masked, drop):
    fed = FedMasks(monkeypatch, seed=30)
    mask = None
    if masked:
        mask = np.zeros((B, 1, 1, S), np.float32)
        mask[0, ..., 6:] = np.finfo(np.float32).min
    dropout_rate, attn_dropout_rate = drop

    def call(fn, wrap):
        def f(x, qkv_w, lin_w, qkv_b, lin_b, ln_s, ln_b):
            ln = dict(pre_ln_scale=ln_s, pre_ln_bias=ln_b) if pre_ln else \
                dict(ln_scale=ln_s, ln_bias=ln_b)
            return fn(x, qkv_w, lin_w, pre_layer_norm=pre_ln, qkv_bias=qkv_b,
                      linear_bias=lin_b, attn_mask=None if mask is None else wrap(mask),
                      dropout_rate=dropout_rate, attn_dropout_rate=attn_dropout_rate,
                      num_heads=HEADS, transpose_qkv_wb=transpose, **ln)
        return f

    _check(call(IF.fused_multi_head_attention, torch.from_numpy),
           call(JIF.fused_multi_head_attention, paddle.to_tensor),
           _mha_arrays(31, transpose), ATTN, ATTN_BWD)
    fed.check_same_draws((dropout_rate > 0) + (attn_dropout_rate > 0))


@pytest.mark.parametrize("pre_ln,act,drop", [(False, "relu", (0.0, 0.0)),
                                             (True, "gelu", (0.1, 0.2)),
                                             (False, "gelu", (0.3, 0.1))])
def test_fused_feedforward(monkeypatch, pre_ln, act, drop):
    fed = FedMasks(monkeypatch, seed=40)
    arrays = [_np(41, B, S, E), 0.2 * _np(42, E, FF), 0.2 * _np(43, FF, E), _np(44, FF),
              _np(45, E), 1 + _np(46, E), _np(47, E)]

    def call(fn):
        def f(x, w1, w2, b1, b2, s, b):
            ln = dict(ln1_scale=s, ln1_bias=b) if pre_ln else dict(ln2_scale=s, ln2_bias=b)
            return fn(x, w1, w2, b1, b2, dropout1_rate=drop[0], dropout2_rate=drop[1],
                      activation=act, pre_layer_norm=pre_ln, **ln)
        return f

    _check(call(IF.fused_feedforward), call(JIF.fused_feedforward), arrays)
    fed.check_same_draws(sum(p > 0 for p in drop))


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def _carried(jlayer, tlayer):
    state = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    assert list(tlayer.state_dict()) == list(state)
    load_numpy_state_dict(tlayer, state)
    return tlayer


@pytest.mark.parametrize("transpose,bias", [(False, None), (True, None), (False, False)])
def test_fused_linear_layer(transpose, bias):
    paddle.seed(50)
    jl = jinc.FusedLinear(6, 5, bias_attr=bias, transpose_weight=transpose)
    tl = _carried(jl, inc.FusedLinear(6, 5, bias_attr=bias, transpose_weight=transpose))
    assert (tl.bias is None) == (bias is False)
    x = _np(51, 3, 6)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), **F32)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_fused_layers_train_as_the_reference(monkeypatch, normalize_before):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward`` (ERNIE's
    width cut to E): the reference's parameters and layouts, two TrainSteps
    with dropout on both against the JAX layers with the same masks."""
    paddle.seed(52)
    jattn = jinc.FusedMultiHeadAttention(E, HEADS, 0.1, 0.0, normalize_before=normalize_before)
    jffn = jinc.FusedFeedForward(E, FF, 0.1, normalize_before=normalize_before,
                                 activation="gelu")
    jm = jnn.Sequential(jattn, jffn)
    tm = _carried(jm, nn.Sequential(
        inc.FusedMultiHeadAttention(E, HEADS, 0.1, 0.0, normalize_before=normalize_before),
        inc.FusedFeedForward(E, FF, 0.1, normalize_before=normalize_before,
                             activation="gelu")))
    assert tuple(tm[0].qkv_weight.shape) == (3, HEADS, E // HEADS, E)
    fed = FedMasks(monkeypatch, seed=52)
    x, y = _np(53, B, S, E), _np(54, B, S, E)
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(jm, lambda m, a, b: ((m(a) - b) ** 2).mean(), jopt)
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))) for _ in range(2)]
    opt = AdamW(1e-3, parameters=tm.parameters())
    step = TrainStep(tm, lambda m, a, b: ((m(a) - b) ** 2).mean(), opt)
    tl = []
    for _ in range(2):
        fed.rewind()
        tl.append(float(step(torch.from_numpy(x), torch.from_numpy(y))))
    # attention output, FFN activation, FFN output; attn_dropout_rate 0 draws none
    assert fed.ref == [("mask", (B, S, E), 0.9), ("mask", (B, S, FF), 0.9),
                       ("mask", (B, S, E), 0.9)]
    assert fed.port == fed.ref * 2
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[name].numpy(), rtol=0,
                                   atol=2 * 1e-3 * 2, err_msg=name)
    tm.eval()
    jm.eval()
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               jm(paddle.to_tensor(x)).numpy(), **ATTN)
    with pytest.raises(NotImplementedError, match="need_weights"):
        inc.FusedMultiHeadAttention(E, HEADS, need_weights=True)


def test_fused_layers_bf16():
    paddle.seed(55)
    jattn = jinc.FusedMultiHeadAttention(E, HEADS, 0.0, 0.0)
    tattn = _carried(jattn, inc.FusedMultiHeadAttention(E, HEADS, 0.0, 0.0))
    x = _np(56, B, S, E)
    tattn.to(dtype="bfloat16")
    got = tattn(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = jattn(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(got.float().detach().numpy(), want, **BF16)


# ---------------------------------------------------------------------------
# asp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 16), (5, 10), (3, 4, 8), (6, 3)])
@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (4, 8)])
def test_asp_masks_equal_the_reference_bit_for_bit(shape, n, m):
    w = _np(60, *shape)
    for algo in ("mask_1d", "mask_2d_greedy", "mask_2d_best"):
        got = asp.create_mask(torch.from_numpy(w), algo, n, m)
        want = jasp.create_mask(w, algo, n, m)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    pruned = w * got
    assert asp.check_mask_1d(pruned, n, m) == jasp.check_mask_1d(pruned, n, m) is True
    assert asp.check_mask_1d(w, n, m) == jasp.check_mask_1d(w, n, m)
    assert asp.calculate_density(torch.from_numpy(pruned)) == jasp.calculate_density(pruned)
    with pytest.raises(ValueError, match="unknown"):
        asp.create_mask(w, "mask_3d")


def _asp_pair(seed):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tm = _carried(jm, nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4)))
    return jm, tm


def test_prune_model_and_excluded_layers_as_the_reference():
    jm, tm = _asp_pair(61)
    asp.set_excluded_layers(["2"])
    jasp.set_excluded_layers(["2"])
    masks, jmasks = asp.prune_model(tm), jasp.prune_model(jm)
    assert sorted(masks) == sorted(jmasks) == ["0"]
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), dict(jm.named_parameters())[name]
                                      .numpy())
    assert asp.calculate_density(tm[0].weight) == 0.5
    assert asp.calculate_density(tm[2].weight) == 1.0
    asp.reset_excluded_layers()
    assert asp.ASPHelper._excluded == []


@pytest.mark.parametrize("route", ["decorate", "train_step", "amp_o2"])
def test_pruned_zeros_survive_steps(route):
    """Three steps keep the 2:4 pattern: a ``decorate``-d eager optimizer,
    and ``jit.TrainStep`` (parameters and their f32 masters under O2); the
    f32 TrainStep's weights equal the reference's."""
    jm, tm = _asp_pair(62)
    asp.prune_model(tm)
    jasp.prune_model(jm)
    opt = AdamW(1e-2, parameters=tm.parameters())
    x, y = _np(63, 4, 8), _np(64, 4, 4)
    if route == "decorate":
        opt = asp.decorate(opt)
        assert asp.decorate(opt) is opt
        for _ in range(3):
            ((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean().backward()
            opt.step()
            opt.clear_grad()
    else:
        if route == "amp_o2":
            tm, opt = ptt.amp.decorate(tm, opt, level="O2", dtype="bfloat16")
        step = TrainStep(tm, lambda m, a, b: ((m(a) - b).float() ** 2).mean(), opt)
        for _ in range(3):
            step(torch.from_numpy(x), torch.from_numpy(y))
    for layer in (tm[0], tm[2]):
        assert asp.check_mask_1d(layer.weight) and asp.calculate_density(layer.weight) == 0.5
        mw = opt._master_weights.get(id(layer.weight))
        assert (mw is None) == (route != "amp_o2")
        if mw is not None:
            assert asp.check_mask_1d(mw) and torch.equal(mw.bfloat16(), layer.weight)
    if route == "train_step":
        jopt = paddle.optimizer.AdamW(1e-2, parameters=jm.parameters())
        jstep = paddle.jit.TrainStep(jm, lambda m, a, b: ((m(a) - b) ** 2).mean(), jopt)
        for _ in range(3):
            jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        jparams = dict(jm.named_parameters())
        for name, p in tm.named_parameters():
            got, want = p.detach().numpy(), jparams[name].numpy()
            np.testing.assert_array_equal(got == 0, want == 0, err_msg=name)
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * 1e-2 * 3, err_msg=name)


def test_asp_masks_drop_with_their_parameter():
    _, tm = _asp_pair(65)
    asp.prune_model(tm)
    assert len(asp.ASPHelper._masks) == 2
    del tm
    import gc
    gc.collect()
    assert asp.ASPHelper._masks == {}
    _, tm = _asp_pair(66)
    asp.prune_model(tm, with_mask=False)
    assert asp.ASPHelper._masks == {} and asp.calculate_density(tm[0].weight) == 0.5
    opt = asp.decorate(SGD(0.1, parameters=tm.parameters()))
    tm(torch.ones(1, 8)).sum().backward()
    opt.step()
    assert asp.calculate_density(tm[0].weight) > 0.5   # no mask kept: the step fills it


def test_incubate_names():
    """``incubate.distributed`` resolves (MoE is ported:
    tests/test_torch_moe.py holds it against the reference)."""
    import paddle_tpu_torch.incubate as pinc
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.incubate.distributed.utils import moe_utils

    assert pinc.asp is asp
    assert pinc.distributed.models.moe is moe and pinc.distributed.utils.moe_utils is moe_utils
