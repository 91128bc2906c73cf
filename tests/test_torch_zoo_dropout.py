"""The vision zoo's dropout in training (AlexNet, VGG, SqueezeNet,
MobileNet V2, MobileNet V3, GoogLeNet, Inception v3, DenseNet with
``dropout`` > 0) against the JAX package's, on the CPU, with its weights
carried across and both packages fed the same masks
(``test_torch_dropout.FedMasks``): one training forward, the masks asked
for in the same order and shapes, and the outputs held to the JAX
package's; for the models without batch norms also a backward of
sum(outputs * cot) and the gradients of the heads (the layers past the
last convolution, where the classifiers' masks act).  Within the f32
gradient row of ``tests/op_test.py`` for the models without batch norms,
and for the others no farther than three times their own f32 distance
from the port's f64 run (as ``test_torch_vision_zoo.py`` holds them:
batch norms over few values magnify rounding).  The models with batch
norms run the reference's compiled forward (``jit.to_static``), its
eager one taking minutes on the CPU; their training backward is held by
the port's bf16 step below and by ``test_torch_vision_zoo.py``'s
dropout-free training gradients.  The convolutions' gradients are left
to ``test_torch_conv.py``: through AlexNet's five layers at 224² the
JAX package's convolution backward parts from an f64 run by up to 4% of
the largest gradient while the port's stays within 1e-6, with dropout or
without.  Then one bf16 O2 ``TrainStep`` with real masks: a finite loss,
no master moved without a gradient, and nine in ten of the others moved.
"""

import copy
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import models as JM

import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as M
from test_torch_dropout import FedMasks

torch.set_num_threads(1)

GRAD = dict(rtol=5e-3, atol=1e-4)    # tests/op_test.py, float32 gradients
CLASSES = 4

FAMILIES = [  # name, constructor kwargs, input side, batch norms, masks a forward, backward
    ("alexnet", {}, 224, False, 2, True),
    ("vgg11", {}, 32, False, 2, True),
    ("squeezenet1_1", {}, 64, False, 1, True),
    ("mobilenet_v2", dict(scale=0.5), 64, True, 1, False),
    ("mobilenet_v3_small", dict(scale=0.5), 64, True, 1, False),
    ("googlenet", {}, 224, True, 3, False),
    ("inception_v3", {}, 96, True, 1, False),
    ("densenet121", dict(dropout=0.2), 32, True, 58, False),
]
HEAD = re.compile(r"(^|\.)(classifier|classifier_conv|fc|fc1|fc2|out)\.")


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _port_run(model, x, cots, dtype, fed, backward):
    fed.rewind()
    model.to(dtype=dtype).train()
    outs = _leaves(model(torch.from_numpy(x).to(dtype)))
    got = {f"out{i}": o.detach().double().numpy() for i, o in enumerate(outs)}
    if backward:
        sum((o * torch.from_numpy(c).to(dtype)).sum() for o, c in zip(outs, cots)).backward()
        got.update({k: p.grad.double().numpy() for k, p in model.named_parameters()
                    if HEAD.search(k)})
    return got


@pytest.mark.parametrize("name,kw,hw,has_norms,draws,backward", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_training_with_dropout_matches_reference(monkeypatch, name, kw, hw, has_norms, draws,
                                                 backward):
    paddle.seed(7)
    jm = getattr(JM, name)(num_classes=CLASSES, **kw)
    weights = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    model = getattr(M, name)(num_classes=CLASSES, **kw)
    load_numpy_state_dict(model, weights)
    exact = copy.deepcopy(model)
    fed = FedMasks(monkeypatch, seed=8, period=draws)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, hw, hw)).astype(np.float32)
    jm.train()
    # without a backward, the reference's compiled forward (`jit.to_static`):
    # its eager forward through these deep models takes minutes on the CPU
    jouts = _leaves((jm if backward else paddle.jit.to_static(jm))(paddle.to_tensor(x)))
    cots = [rng.standard_normal(tuple(o.shape)).astype(np.float32) for o in jouts]
    want = {f"out{i}": np.asarray(o.numpy()) for i, o in enumerate(jouts)}
    if backward:
        sum((o * paddle.to_tensor(c)).sum() for o, c in zip(jouts, cots)).backward()
        want.update({k: np.asarray(p.grad.numpy()) for k, p in jm.named_parameters()
                     if HEAD.search(k)})
    got = _port_run(model, x, cots, torch.float32, fed, backward)
    # the compiled reference traces its forward twice, drawing each mask twice
    assert len(fed.port) == draws and fed.ref == fed.port * (1 if backward else 2), fed.ref
    assert set(got) == set(want) and len(want) > len(jouts) * backward
    if not has_norms:
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, **GRAD, err_msg=k)
        return
    ref64 = _port_run(exact, x, cots, torch.float64, fed, backward)
    for k, w in want.items():
        assert _rel(got[k], w) <= 3 * _rel(got[k], ref64[k]) + 1e-6, k


@pytest.mark.parametrize("name,kw,hw", [("squeezenet1_1", {}, 64),
                                        ("mobilenet_v3_small", dict(scale=0.5), 32),
                                        ("densenet121", dict(dropout=0.2), 32)])
def test_bf16_o2_train_step_with_dropout(name, kw, hw):
    ptt.seed(3)
    model = getattr(M, name)(num_classes=CLASSES, **kw)
    opt = Momentum(0.01, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, lambda m, x, y: ptt.nn.functional.cross_entropy(m(x), y).mean(),
                     opt)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, hw, hw))
                         .astype(np.float32))
    params = [p for p in model.parameters() if p.requires_grad]
    before = [p.detach().float().clone() for p in params]
    loss = step(x, torch.arange(2) % CLASSES)
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    live = [p.grad is not None and bool(p.grad.any()) for p in params]
    moved = [not torch.equal(b, opt._master_weights.get(id(p), p).float())
             for b, p in zip(before, params)]
    # a step below half an f32 ulp of its master leaves it as it was
    assert not any(m and not lv for m, lv in zip(moved, live))
    assert sum(moved) >= 0.9 * sum(live) and sum(live) > len(params) // 2
