"""The functionals this slice adds to ``nn.functional`` and the gradient
clips, against the JAX package on the CPU: each functional's forward and
grads on the same inputs (the f32 row of ``tests/op_test.py``; its grad row
for grads), ``gumbel_softmax`` by its law (JAX's and torch's random bits
differ), the in-place activations (the tensor itself changed, autograd
through it), ``ClipGradByValue`` / ``ClipGradByNorm`` /
``ClipGradByGlobalNorm`` / ``clip_grad_norm_`` on the same gradients, and
an AdamW step with each clip against the reference's optimizer.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)        # tests/op_test.py, float32
GRAD = dict(rtol=5e-3, atol=1e-4)       # tests/op_test.py, float32 grads


@pytest.fixture(autouse=True)
def _on_cpu():
    paddle.set_device("cpu")
    yield
    paddle.set_device(None)


def r(*shape, lo=-1.0, hi=1.0, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    return (lo + (hi - lo) * rng.random(shape)).astype(np.float32)


def val(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype("float32").numpy())


LABELS4 = np.array([[1], [3], [0], [7]])
THETA = (np.array([[1.0, 0.2, 0.1], [-0.1, 0.9, 0.0]], np.float32)[None]
         + 0.1 * r(2, 2, 3, seed=5)).astype(np.float32)

# (label, fn(F, P, *tensors), float inputs (differentiated), other inputs)
CASES = [
    ("one_hot", lambda F, P, i: F.one_hot(i, 6), [], [np.array([0, 4, 2, 5])]),
    ("label_smooth", lambda F, P, x: F.label_smooth(F.softmax(x), epsilon=0.2), [r(4, 8)], []),
    ("label_smooth prior", lambda F, P, x, p: F.label_smooth(x, p, 0.1),
     [r(4, 8)], [r(1, 8, lo=0, hi=0.25)]),
    ("square_error_cost", lambda F, P, a, b: F.square_error_cost(a, b),
     [r(4, 8), r(4, 8, seed=1)], []),
    ("softmax_with_cross_entropy", lambda F, P, x, y: F.softmax_with_cross_entropy(x, y),
     [r(4, 8)], [LABELS4]),
    ("softmax_with_cross_entropy soft", lambda F, P, x, y: F.softmax_with_cross_entropy(
        x, F.softmax(y), soft_label=True, return_softmax=True)[0], [r(4, 8)],
     [r(4, 8, seed=3)]),
    ("softmax_with_cross_entropy axis 0", lambda F, P, x, y: F.softmax_with_cross_entropy(
        x, y, axis=0), [r(8, 3)], [np.array([[1, 0, 7]])]),
    ("sequence_mask", lambda F, P, n: F.sequence_mask(n, 6, "float32"), [],
     [np.array([[1, 3], [6, 0]])]),
    ("sequence_mask no maxlen", lambda F, P, n: F.sequence_mask(n), [], [np.array([1, 3, 4])]),
    ("log_loss", lambda F, P, p, y: F.log_loss(p, y),
     [r(4, 8, lo=0.1, hi=0.9)], [(np.arange(32).reshape(4, 8) % 2).astype(np.float32)]),
    ("dice_loss", lambda F, P, x, y: F.dice_loss(F.softmax(x), y), [r(4, 8)], [LABELS4]),
    ("npair_loss", lambda F, P, a, b, y: F.npair_loss(a, b, y, 0.01),
     [r(4, 8), r(4, 8, seed=2)], [np.array([0, 1, 0, 2])]),
    ("sigmoid_focal_loss", lambda F, P, x, y: F.sigmoid_focal_loss(x, y),
     [r(4, 8)], [(np.arange(32).reshape(4, 8) % 3 == 0).astype(np.float32)]),
    ("sigmoid_focal_loss mean normalizer", lambda F, P, x, y, n: F.sigmoid_focal_loss(
        x, y, n, 0.5, 1.5, "mean"), [r(4, 8)],
     [(np.arange(32).reshape(4, 8) % 3 == 0).astype(np.float32), np.array([3.0], np.float32)]),
    ("temporal_shift", lambda F, P, x: F.temporal_shift(x, 2, 0.25), [r(4, 8, 3, 3)], []),
    ("temporal_shift NHWC", lambda F, P, x: F.temporal_shift(x, 2, 0.125, "NHWC"),
     [r(4, 3, 3, 8)], []),
    ("affine_grid", lambda F, P, t: F.affine_grid(t, [2, 3, 5, 6]), [THETA], []),
    ("affine_grid corners off", lambda F, P, t: F.affine_grid(t, [2, 3, 4, 7], False),
     [THETA], []),
    ("grid_sample bilinear", lambda F, P, x, t: F.grid_sample(x, F.affine_grid(t, [2, 3, 5, 6])),
     [r(2, 3, 7, 9), THETA], []),
    ("grid_sample nearest border", lambda F, P, x, t: F.grid_sample(
        x, F.affine_grid(t * 1.3, [2, 3, 5, 6], False), "nearest", "border", False),
     [r(2, 3, 7, 9)], [THETA]),
    ("grid_sample zeros out of range", lambda F, P, x, t: F.grid_sample(
        x, F.affine_grid(t * 1.6, [2, 3, 5, 6])), [r(2, 3, 7, 9), THETA], []),
]

INPLACE = ["relu_", "elu_", "leaky_relu_", "hardtanh_", "thresholded_relu_", "softmax_",
           "tanh_"]


def _run(F_, P, fn, floats, others, grad):
    ts = [P.to_tensor(a) for a in floats]
    for t in ts:
        t.stop_gradient = not grad
    out = fn(F_, P, *ts, *[P.to_tensor(a) for a in others])
    return out, ts


@pytest.mark.parametrize("label,fn,floats,others", CASES, ids=[c[0] for c in CASES])
def test_functional_against_reference(label, fn, floats, others):
    got, _ = _run(F, paddle, fn, floats, others, False)
    want, _ = _run(JF, jpaddle, fn, floats, others, False)
    assert list(got.shape) == list(want.shape)
    np.testing.assert_allclose(val(got), val(want), **F32)
    if not floats:
        return
    out, ts = _run(F, paddle, fn, floats, others, True)
    jout, jts = _run(JF, jpaddle, fn, floats, others, True)
    w = np.cos(np.arange(int(np.prod(val(jout).shape)) or 1, dtype=np.float32)).reshape(
        val(jout).shape)
    (out * paddle.to_tensor(w)).sum().backward()
    (jout * jpaddle.to_tensor(w)).sum().backward()
    for t, jt in zip(ts, jts):
        np.testing.assert_allclose(val(t.grad), val(jt.grad), **GRAD)


@pytest.mark.parametrize("name", INPLACE)
def test_inplace_activation(name):
    x0 = r(3, 5) * 3
    want = val(getattr(JF, name[:-1])(jpaddle.to_tensor(x0)))
    x = paddle.to_tensor(x0)
    out = getattr(F, name)(x)
    assert out is x
    np.testing.assert_allclose(val(x), want, **F32)
    leaf = paddle.to_tensor(x0, stop_gradient=False)
    y = leaf * 1.0
    getattr(F, name)(y)
    (y * paddle.to_tensor(np.cos(np.arange(15, dtype=np.float32)).reshape(3, 5))).sum() \
        .backward()
    jleaf = jpaddle.to_tensor(x0, stop_gradient=False)
    jy = getattr(JF, name[:-1])(jleaf * 1.0)
    (jy * jpaddle.to_tensor(np.cos(np.arange(15, dtype=np.float32)).reshape(3, 5))).sum() \
        .backward()
    np.testing.assert_allclose(val(leaf.grad), val(jleaf.grad), **GRAD)
    with pytest.raises(RuntimeError):
        getattr(F, name)(paddle.to_tensor(x0, stop_gradient=False))


def test_gumbel_softmax_law():
    logits = np.linspace(-1.0, 1.5, 6).astype(np.float32)
    n = 40000
    x = paddle.to_tensor(np.broadcast_to(logits, (n, 6)).copy())
    paddle.seed(3)
    soft = F.gumbel_softmax(x, temperature=0.5)
    np.testing.assert_allclose(val(soft.sum(-1)), np.ones(n), rtol=1e-5)
    hard = F.gumbel_softmax(x, hard=True)
    assert bool(((hard > 0.5).sum(-1) == 1).all())
    probs = np.exp(logits) / np.exp(logits).sum()
    freq = val((hard > 0.5).float().mean(0))
    assert np.all(np.abs(freq - probs) <= 4 * np.sqrt(probs * (1 - probs) / n))
    ref = val(JF.gumbel_softmax(jpaddle.to_tensor(np.broadcast_to(logits, (n, 6)).copy()),
                                hard=True))
    assert np.all(np.abs(ref.mean(0) - freq) <= 6 * np.sqrt(probs * (1 - probs) / n))
    # the straight-through gradient is the soft sample's
    xl = paddle.to_tensor(logits[None], stop_gradient=False)
    F.gumbel_softmax(xl, hard=True)[0, 0].backward()
    assert xl.grad is not None and np.isfinite(val(xl.grad)).all()
    paddle.seed(9)
    a = F.gumbel_softmax(x[:4])
    paddle.seed(9)
    assert torch.equal(a, F.gumbel_softmax(x[:4]))


# ---------------------------------------------------------------------------
# clips
# ---------------------------------------------------------------------------
def _params_grads(P, need_clip=(True, True, False)):
    rng = np.random.default_rng(4)
    out = []
    for i, shape in enumerate(((3, 4), (5,), (2, 2))):
        p = P.to_tensor(rng.standard_normal(shape).astype(np.float32))
        p.need_clip = need_clip[i]
        g = P.to_tensor(rng.standard_normal(shape).astype(np.float32) * (i + 1))
        out.append((p, g))
    out.append((P.to_tensor(np.zeros(2, np.float32)), None))
    return out


@pytest.mark.parametrize("make", [
    lambda m: m.ClipGradByValue(0.5), lambda m: m.ClipGradByValue(0.5, -0.2),
    lambda m: m.ClipGradByNorm(1.0), lambda m: m.ClipGradByNorm(100.0),
    lambda m: m.ClipGradByGlobalNorm(1.0), lambda m: m.ClipGradByGlobalNorm(100.0)],
    ids=["value", "value min", "norm", "norm loose", "global", "global loose"])
def test_clip_against_reference(make):
    got = make(nn)(_params_grads(paddle))
    want = make(jnn)(_params_grads(jpaddle))
    assert isinstance(make(nn), nn.ClipGradBase)
    for (_, g), (_, w) in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(val(g), val(w), **F32)


def test_clip_keeps_bf16():
    p = paddle.to_tensor(np.ones(4, np.float32))
    g = paddle.to_tensor(np.full(4, 3.0, np.float32)).astype("bfloat16")
    for clip in (nn.ClipGradByValue(1.0), nn.ClipGradByNorm(1.0), nn.ClipGradByGlobalNorm(1.0)):
        (_, out), = clip([(p, g)])
        assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_(norm_type):
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal(s).astype(np.float32) * 3 for s in ((3, 4), (6,))]
    results = []
    for P, mod in ((paddle, nn), (jpaddle, jnn)):
        params = []
        for a in arrays:
            p = P.to_tensor(np.zeros_like(a), stop_gradient=False)
            (p * P.to_tensor(a)).sum().backward()
            params.append(p)
        total = mod.clip.clip_grad_norm_(params, 2.0, norm_type)
        results.append((val(total), [val(p.grad) for p in params]))
    (t, gs), (jt, jgs) = results
    np.testing.assert_allclose(t, jt, **F32)
    for g, jg in zip(gs, jgs):
        np.testing.assert_allclose(g, jg, **F32)
    assert float(nn.clip_grad_norm_([paddle.to_tensor([1.0])], 1.0)) == 0.0


@pytest.mark.parametrize("clip", ["ClipGradByValue", "ClipGradByNorm"])
def test_adamw_step_with_clip_against_reference(clip):
    """One AdamW step of a linear model with each per-tensor clip, through
    ``loss.backward(); opt.step(); opt.clear_grad()`` in both packages."""
    from paddle_tpu.optimizer import AdamW as JAdamW
    from paddle_tpu_torch.optimizer import AdamW

    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    x0 = rng.standard_normal((5, 4)).astype(np.float32)
    arg = 0.05 if clip == "ClipGradByValue" else 0.3
    out = []
    for P, mod, Opt in ((paddle, nn, AdamW), (jpaddle, jnn, JAdamW)):
        w = P.to_tensor(w0, stop_gradient=False)
        opt = Opt(1e-2, parameters=[w], grad_clip=getattr(mod, clip)(arg))
        for _ in range(2):
            loss = (P.matmul(P.to_tensor(x0), w) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        out.append(val(w))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5, atol=1e-6)


def test_clips_exported_where_the_reference_exports_them():
    import paddle_tpu_torch.jit as jit
    import paddle_tpu_torch.optimizer as optimizer

    for mod in (nn, optimizer, jit):
        for name in ("ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"):
            assert getattr(mod, name) is getattr(nn.clip, name)
    assert nn.clip_grad_norm_ is nn.clip.clip_grad_norm_


# ---------------------------------------------------------------------------
# ParamAttr on the model-parallel layers (one process: dp 4 x mp 2 on the CPU)
# ---------------------------------------------------------------------------
@pytest.fixture
def mp2(monkeypatch):
    from paddle_tpu.distributed import topology as jtopo
    from paddle_tpu_torch.distributed import topology

    monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", "0")
    saved = jtopo.get_hybrid_communicate_group(), topology.get_hybrid_communicate_group()
    jtopo.set_hybrid_communicate_group(jtopo.HybridCommunicateGroup(dp=4, mp=2))
    topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(
        mesh=topology.build_mesh(dp=4, mp=2, devices=["cpu"] * 8)))
    yield
    jtopo.set_hybrid_communicate_group(saved[0])
    topology.set_hybrid_communicate_group(saved[1])


W0 = np.arange(32, dtype=np.float32).reshape(4, 8) / 10


@pytest.mark.parametrize("layer,shape", [("ColumnParallelLinear", (4, 8)),
                                         ("RowParallelLinear", (4, 8)),
                                         ("VocabParallelEmbedding", (4, 8))])
@pytest.mark.parametrize("attr", ["constant", "assign", "initializer", "name", "trainable"])
def test_mp_layers_take_param_attr(mp2, layer, shape, attr):
    import paddle_tpu.distributed.meta_parallel as jmp
    import paddle_tpu.nn.initializer as JI
    import paddle_tpu_torch.distributed.meta_parallel as tmp
    import paddle_tpu_torch.nn.initializer as I

    def make(mod, P, init):
        return {"constant": P.ParamAttr(name="w_0", initializer=init.Constant(0.3),
                                        learning_rate=2.0, need_clip=False),
                "assign": P.ParamAttr(initializer=init.Assign(W0)),
                "initializer": init.Constant(-0.5),
                "name": "mp_w",
                "trainable": P.ParamAttr(initializer=init.Assign(W0), trainable=False)}[attr]

    got = getattr(tmp, layer)(*shape, make(tmp, nn, I))
    want = getattr(jmp, layer)(*shape, make(jmp, jnn, JI))
    if attr == "name":      # a name alone keeps each package's default draw
        with torch.no_grad():
            got.weight.copy_(torch.from_numpy(val(want.weight)))
    np.testing.assert_array_equal(val(got.weight), val(want.weight))
    assert got.weight.requires_grad == (not want.weight.stop_gradient)
    assert got.weight.need_clip == want.weight.need_clip
    assert got.weight.optimize_attr == want.weight.optimize_attr
    assert got.weight.param_name == {"constant": "w_0", "name": "mp_w"}.get(attr)
    assert got.weight.split_axis == want.weight.split_axis
    x = (np.arange(12).reshape(3, 4) % 4 if layer == "VocabParallelEmbedding"
         else np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32))
    if layer != "VocabParallelEmbedding":
        load = {k: np.asarray(v.numpy()) for k, v in want.state_dict().items()}
        got.bias.data.copy_(torch.from_numpy(load["bias"]))
    np.testing.assert_allclose(val(got(paddle.to_tensor(x))), val(want(jpaddle.to_tensor(x))),
                               **F32)


def test_mp_layers_refuse_a_missing_weight_and_draw_globally(mp2):
    import paddle_tpu_torch.distributed.meta_parallel as tmp

    with pytest.raises(ValueError, match="attr=False"):
        tmp.ColumnParallelLinear(4, 8, False)
    g = torch.Generator().manual_seed(3)
    col = tmp.ColumnParallelLinear(4, 8, nn.ParamAttr(initializer=nn.initializer.Normal(0, 2)),
                                   generator=g)
    want = torch.empty(4, 8).normal_(0, 2, generator=torch.Generator().manual_seed(3))
    assert torch.equal(col.weight.detach(), want)
    assert isinstance(col, nn.Layer) and col.full_name().startswith("columnparallellinear")
