"""The port's ResNet family (``vision/models/resnet.py``) against the JAX
package's, on the CPU: ``resnet50(num_classes=10)`` on a 2 x 3 x 64 x 64
batch with the JAX model's weights carried across, in eval and in train
(the running buffers after a training forward, every parameter's
gradient after one backward), with the port's internal layout NCHW and
NHWC; ``resnet18`` and ``resnext50_32x4d`` (grouped convolutions)
forward; the state dicts' names and shapes of four depths and widths,
and state dicts crossing both ways; AMP O2's f32 batch norms; and the
default device.

Tolerances are the rows of ``tests/op_test.py``: f32 for eval values,
the f32 gradient row for the logits and running buffers of a training
forward.  A training backward through fifty batch norms that normalise
by their own statistics magnifies f32 rounding: at the stem the
gradients reach 1e3, and either package's f32 gradients lie 1-3%
(relative L2) from the same port run in f64.  So each parameter's
gradient must lie no farther from the JAX package's than three times its
own f32 distance from the port's f64 run (the two packages' roundings
add).  A port formula that differed from the reference's would move the
f32 and f64 runs together, away from the JAX package's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision.models import resnet as jresnet

import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.vision.models import resnet

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)     # tests/op_test.py, float32
GRAD = dict(rtol=5e-3, atol=1e-4)    # tests/op_test.py, float32 gradients
SHAPE = (2, 3, 64, 64)


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _arrays(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def ref50():
    """The JAX ``resnet50(num_classes=10)``: its weights, its eval logits,
    then one training forward's logits, running buffers and every
    parameter's gradient of ``sum(logits * cot)``."""
    paddle.seed(0)
    jm = jresnet.resnet50(num_classes=10, data_format="NCHW")
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    cot = rng.standard_normal((SHAPE[0], 10)).astype(np.float32)
    weights = _arrays(jm)
    jm.eval()
    eval_logits = np.asarray(jm(paddle.to_tensor(x)).numpy())
    jm.train()
    out = jm(paddle.to_tensor(x))
    (out * paddle.to_tensor(cot)).sum().backward()
    return dict(jm=jm, x=x, cot=cot, weights=weights, eval_logits=eval_logits,
                train_logits=np.asarray(out.numpy()), after=_arrays(jm),
                grads={k: np.asarray(p.grad.numpy()) for k, p in jm.named_parameters()})


def _port50(ref, fmt):
    model = resnet.resnet50(num_classes=10, data_format=fmt)
    load_numpy_state_dict(model, ref["weights"])
    return model


def _train_backward(model, ref, dtype):
    model.to(dtype=dtype).train()
    out = model(torch.from_numpy(ref["x"]).to(dtype))
    (out * torch.from_numpy(ref["cot"]).to(dtype)).sum().backward()
    return out, {k: p.grad.double().numpy() for k, p in model.named_parameters()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet50_eval_logits(ref50, fmt):
    model = _port50(ref50, fmt).eval()
    assert model.data_format == fmt
    with torch.no_grad():
        got = model(torch.from_numpy(ref50["x"]))
    np.testing.assert_allclose(got.numpy(), ref50["eval_logits"], **F32)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet50_training_forward_buffers_and_grads(ref50, fmt):
    model = _port50(ref50, fmt)
    out, grads = _train_backward(model, ref50, torch.float32)
    np.testing.assert_allclose(out.detach().numpy(), ref50["train_logits"], **GRAD)
    after = model.state_dict()
    for name in [k for k in after if k.endswith(("_mean", "_variance"))]:
        np.testing.assert_allclose(after[name].numpy(), ref50["after"][name], **GRAD,
                                   err_msg=name)
    assert not np.allclose(after["bn1._mean"].numpy(), ref50["weights"]["bn1._mean"])
    _, exact = _train_backward(_port50(ref50, fmt), ref50, torch.float64)
    assert set(grads) == set(ref50["grads"])
    for name, want in ref50["grads"].items():
        assert _rel(grads[name], want) <= 3 * _rel(grads[name], exact[name]) + 1e-6, name


def test_state_dicts_cross_both_ways(ref50):
    """The port's weights go into a fresh JAX model and give the port's
    logits there; the JAX weights came the other way above."""
    model = resnet.resnet50(num_classes=10, data_format="NCHW",
                            generator=torch.Generator().manual_seed(3)).eval()
    jm = ref50["jm"]
    missing, unexpected = jm.set_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    assert not missing and not unexpected
    jm.eval()
    x = ref50["x"]
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(paddle.to_tensor(x)).numpy()), **F32)


@pytest.mark.parametrize("name", ["resnet18", "resnext50_32x4d"])
def test_other_depths_and_groups_forward(name):
    paddle.seed(6)
    jm = getattr(jresnet, name)(num_classes=7, data_format="NCHW")
    model = getattr(resnet, name)(num_classes=7, data_format="NHWC")
    load_numpy_state_dict(model, _arrays(jm))
    jm.eval()
    model.eval()
    x = np.random.default_rng(7).standard_normal((1, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(paddle.to_tensor(x)).numpy()), **F32)


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "wide_resnet50_2",
                                  "resnext50_32x4d"])
def test_state_dict_names_and_shapes(name):
    paddle.seed(8)
    want = {k: tuple(v.shape) for k, v in
            getattr(jresnet, name)(num_classes=10).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in getattr(resnet, name)(num_classes=10).state_dict().items()}
    assert list(got) == list(want) and got == want


def test_published_resnet50_and_features_without_head():
    model = resnet.resnet50()
    sd = model.state_dict()
    assert len(sd) == 267 and sd["bn1._mean"].dtype == torch.float32
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    body = resnet.resnet18(num_classes=0, with_pool=False, data_format="NHWC").eval()
    with torch.no_grad():
        feats = body(torch.ones(1, 3, 64, 64))
    assert tuple(feats.shape) == (1, 512, 2, 2)
    with pytest.raises(NotImplementedError, match="pretrained"):
        resnet.resnet18(pretrained=True)
    with pytest.raises(ValueError, match="data_format"):
        resnet.resnet18(data_format="NCDHW")


def test_amp_o2_keeps_batch_norms_in_f32():
    model = resnet.resnet18(num_classes=10)
    amp.decorate(model, level="O2", dtype="bfloat16")
    assert model.conv1.weight.dtype == model.fc.weight.dtype == torch.bfloat16
    for layer in (model.bn1, model.layer1[0].bn2, model.layer4[1].bn1):
        assert layer.weight.dtype == layer.bias.dtype == layer._mean.dtype == torch.float32
    model.eval()
    with torch.no_grad():
        out = model(torch.ones(2, 3, 32, 32))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
    group = ptt.nn.GroupNorm(2, 4)
    amp.decorate(ptt.nn.Sequential(group), level="O2")
    assert group.weight.dtype == torch.float32


def test_auto_layout_and_default_device():
    from paddle_tpu_torch.incubate import autotune

    assert resnet.resnet18(num_classes=3).data_format == "NCHW"   # "auto" on the CPU
    assert autotune.resolve_conv_data_format(device="cuda:0") == autotune.CARD_LAYOUT \
        if torch.cuda.is_available() else True
    autotune.set_config({"layout": {"data_format": "nhwc"}})
    try:
        assert resnet.resnet18(num_classes=3).data_format == "NHWC"
    finally:
        autotune.set_config({"layout": {"data_format": None}})
    ptt.set_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resnet.resnet50()
    assert resnet.resnet18(num_classes=3, device="cpu").fc.weight.device.type == "cpu"
