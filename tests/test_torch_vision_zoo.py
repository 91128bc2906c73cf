"""The rest of the port's vision zoo (``vision/models``: LeNet, AlexNet,
VGG, SqueezeNet, MobileNet V1/V2/V3, ShuffleNetV2, DenseNet, GoogLeNet,
Inception v3), on the CPU: the published parameter counts of
``tests/test_vision_zoo.py``, the training-mode gradients of the
dropout-free models (LeNet, ShuffleNetV2, DenseNet) and their running
statistics against the JAX package's with its weights carried across,
NCHW against NHWC inside, GoogLeNet's three heads, features without a
head, the reference's argument errors, the default device and one AMP O2
step.  Each family's eval logits against the reference are in
``test_torch_vision_zoo_logits.py``.

Tolerances are the rows of ``tests/op_test.py``.  A training backward
through many batch norms that normalise by their own statistics magnifies
f32 rounding, so (as in ``test_torch_resnet.py``) each gradient of a model
with batch norms must lie no farther from the JAX package's than three
times its own f32 distance from the port's f64 run.
"""

import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import models as JM

import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.vision import models as M

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)     # tests/op_test.py, float32
GRAD = dict(rtol=5e-3, atol=1e-4)    # tests/op_test.py, float32 gradients


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _n_params(m):
    return sum(int(np.prod(p.shape)) for p in m.parameters())


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("ctor,expected", [
    (lambda: M.LeNet(), 61_610),
    (lambda: M.alexnet(), 61_100_840),
    (lambda: M.vgg16(), 138_357_544),
    (lambda: M.vgg11(batch_norm=True), 132_868_840),
    (lambda: M.mobilenet_v2(), 3_504_872),
    (lambda: M.squeezenet1_0(), 1_248_424),
    (lambda: M.squeezenet1_1(), 1_235_496),
    (lambda: M.densenet121(), 7_978_856),
    (lambda: M.densenet169(), 14_149_480),
    (lambda: M.shufflenet_v2_x1_0(), 2_278_604),
    (lambda: M.shufflenet_v2_x0_5(), 1_366_792),
    (lambda: M.mobilenet_v3_large(), 5_483_032),
    (lambda: M.mobilenet_v3_small(), 2_542_856),
    (lambda: M.inception_v3(), 23_834_568),
    (lambda: M.googlenet(), 11_535_736),
], ids=["lenet", "alexnet", "vgg16", "vgg11_bn", "mobilenet_v2", "squeezenet1_0",
        "squeezenet1_1", "densenet121", "densenet169", "shufflenet_v2_x1_0",
        "shufflenet_v2_x0_5", "mobilenet_v3_large", "mobilenet_v3_small", "inception_v3",
        "googlenet"])
def test_published_parameter_counts(ctor, expected):
    assert _n_params(ctor()) == expected


def test_mobilenet_v1_scale():
    full, half = _n_params(M.mobilenet_v1()), _n_params(M.mobilenet_v1(scale=0.5))
    assert 4_100_000 < full < 4_400_000
    assert half < full / 2.5


def _arrays(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _port_backward(model, x, cot, dtype):
    model.to(dtype=dtype).train()
    out = model(torch.from_numpy(x).to(dtype))
    (out * torch.from_numpy(cot).to(dtype)).sum().backward()
    return out, {k: p.grad.double().numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("name,kw,shape,has_norms", [
    ("LeNet", dict(num_classes=4), (4, 1, 28, 28), False),
    ("shufflenet_v2_x0_25", dict(num_classes=4), (2, 3, 64, 64), True),
    ("shufflenet_v2_swish", dict(num_classes=4), (2, 3, 64, 64), True),
    ("densenet121", dict(num_classes=4), (2, 3, 64, 64), True),
])
def test_training_grads_and_running_statistics(name, kw, shape, has_norms):
    """One training forward and backward of sum(logits * cot): the logits,
    every gradient and the running statistics against the reference's,
    within the f32 gradient row for LeNet, by the f64 spread for the models
    with batch norms (their last norms see few values at these sizes)."""
    paddle.seed(4)
    jm = getattr(JM, name)(**kw)
    weights = _arrays(jm)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    cot = rng.standard_normal((shape[0], kw["num_classes"])).astype(np.float32)
    jm.train()
    jout = jm(paddle.to_tensor(x))
    (jout * paddle.to_tensor(cot)).sum().backward()
    want = {k: np.asarray(p.grad.numpy()) for k, p in jm.named_parameters()}
    after = _arrays(jm)

    model = getattr(M, name)(**kw)
    load_numpy_state_dict(model, weights)
    exact_model = copy.deepcopy(model)
    out, grads = _port_backward(model, x, cot, torch.float32)
    assert set(grads) == set(want)
    got = {"logits": out.detach().numpy(), **{k: g for k, g in grads.items()},
           **{k: v.numpy() for k, v in model.state_dict().items()
              if k.endswith(("_mean", "_variance"))}}
    ref = {"logits": np.asarray(jout.numpy()), **want,
           **{k: after[k] for k in got if k.endswith(("_mean", "_variance"))}}
    if not has_norms:
        for k, w in ref.items():
            np.testing.assert_allclose(got[k], w, **GRAD, err_msg=k)
        return
    exact_out, exact = _port_backward(exact_model, x, cot, torch.float64)
    exact = {"logits": exact_out.detach().numpy(), **exact,
             **{k: v.numpy() for k, v in exact_model.state_dict().items()
                if k.endswith(("_mean", "_variance"))}}
    for k, w in ref.items():
        assert _rel(got[k], w) <= 3 * _rel(got[k], exact[k]) + 1e-6, k


@pytest.mark.parametrize("family,hw", [("alexnet", 224), ("vgg11", 64), ("mobilenet_v1", 64),
                                       ("mobilenet_v2", 64), ("squeezenet1_1", 64),
                                       ("squeezenet1_0", 64), ("densenet121", 64),
                                       ("shufflenet_v2_x0_5", 64), ("mobilenet_v3_small", 64),
                                       ("googlenet", 224), ("inception_v3", 96)])
def test_nhwc_matches_nchw(family, hw):
    """The internal layout does not change the function: NHWC inside gives
    NCHW's logits on the same weights and NCHW images."""
    a = getattr(M, family)(num_classes=4, data_format="NCHW",
                           generator=torch.Generator().manual_seed(3)).eval()
    b = getattr(M, family)(num_classes=4, data_format="NHWC").eval()
    b.load_state_dict(a.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, hw, hw)).astype(np.float32))
    with torch.no_grad():
        got, want = b(x), a(x)
    if family == "googlenet":
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_googlenet_heads_and_features_without_a_head():
    m = M.googlenet(num_classes=6).eval()
    with torch.no_grad():
        out, aux1, aux2 = m(torch.ones(1, 3, 224, 224))
    assert [tuple(t.shape) for t in (out, aux1, aux2)] == [(1, 6)] * 3
    body = M.mobilenet_v2(num_classes=0, with_pool=False, data_format="NHWC").eval()
    with torch.no_grad():
        assert tuple(body(torch.zeros(1, 3, 64, 64)).shape) == (1, 1280, 2, 2)
    feats = M.GoogLeNet(num_classes=0, with_pool=False, data_format="NHWC").eval()
    with torch.no_grad():
        f, none1, none2 = feats(torch.zeros(1, 3, 64, 64))
    assert tuple(f.shape) == (1, 1024, 1, 1) and none1 is None and none2 is None
    sq = M.squeezenet1_1(num_classes=0, data_format="NHWC").eval()
    with torch.no_grad():
        assert tuple(sq(torch.zeros(1, 3, 64, 64)).shape) == (1, 512, 1, 1)


def test_reference_argument_errors():
    for fn in (M.alexnet, M.vgg16, M.mobilenet_v2, M.squeezenet1_0, M.densenet121,
               M.googlenet, M.inception_v3, M.shufflenet_v2_x1_0, M.mobilenet_v3_large):
        with pytest.raises(NotImplementedError, match="zero egress"):
            fn(pretrained=True)
    with pytest.raises(ValueError, match="1.0.*1.1"):
        M.SqueezeNet(version="2.0")
    with pytest.raises(ValueError, match="supported layers"):
        M.DenseNet(layers=42)
    with pytest.raises(ValueError, match="not implemented"):
        M.ShuffleNetV2(scale=3.0)
    with pytest.raises(ValueError, match="unsupported activation"):
        M.ShuffleNetV2(act="gelu")
    with pytest.raises(ValueError, match="data_format"):
        M.alexnet(data_format="NCDHW")


def test_auto_layout_default_device_and_generator():
    from paddle_tpu_torch.incubate import autotune

    assert M.densenet121(num_classes=3).data_format == "NCHW"     # "auto" on the CPU
    assert M.vgg11(num_classes=3).data_format == "NCHW"
    autotune.set_config({"layout": {"data_format": "nhwc"}})
    try:
        assert M.mobilenet_v3_small(num_classes=3).data_format == "NHWC"
        assert M.vgg11(num_classes=3).data_format == "NHWC"
    finally:
        autotune.set_config({"layout": {"data_format": None}})
    a = M.squeezenet1_1(generator=torch.Generator().manual_seed(9))
    b = M.squeezenet1_1(generator=torch.Generator().manual_seed(9))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    ptt.set_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.LeNet()
    assert M.LeNet(device="cpu").fc[0].weight.device.type == "cpu"
    assert M.vgg11(num_classes=3, device="cpu").classifier[0].weight.device.type == "cpu"


@pytest.mark.parametrize("name,shape", [("LeNet", (4, 1, 28, 28)),
                                        ("shufflenet_v2_x0_25", (4, 3, 64, 64)),
                                        ("mobilenet_v3_small", (2, 3, 64, 64))])
def test_amp_o2_train_step(name, shape):
    """One bf16 O2 Momentum TrainStep: batch norms stay f32, a finite f32
    loss, the masters moved."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum

    model = getattr(M, name)(num_classes=4)      # mobilenet_v3_small trains its dropout
    opt = Momentum(0.01, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    norms = [m for m in model.modules() if isinstance(m, ptt.nn.BatchNorm2D)]
    assert all(m.weight.dtype == torch.float32 for m in norms)
    step = TrainStep(model, lambda m, x, y: F.cross_entropy(m(x), y).mean(), opt)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(shape).astype(np.float32))
    y = torch.arange(shape[0]) % 4
    loss = step(x, y)
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert len(opt._master_weights) == sum(p.dtype == torch.bfloat16 for p in model.parameters())
