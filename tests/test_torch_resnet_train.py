"""ResNet training with the new optimizers (ladder row 1's step, at a tiny
size) against the JAX package, on the CPU: ``resnet18`` at batch 4 on 64²
images, ``TrainStep`` with ``Momentum`` (and Nesterov with L2 decay), two
steps on the JAX model's weights: both losses, every parameter and every
running statistic within the f32 gradient row of ``tests/op_test.py``;
then one AMP O2 bf16 step.

64², not 32²: at 32² the last stage's batch norms see 4 values a channel,
which magnifies f32 rounding past the row (two f32 runs of the same step
part by up to 2e-3 in the last weights); at 64² the worst element sits at
about 0.01 of the row.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.vision.models import resnet as jresnet

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet

torch.set_num_threads(1)

GRAD = dict(rtol=5e-3, atol=1e-4)    # tests/op_test.py, float32 gradients
BF16 = dict(rtol=2e-2, atol=2e-2)    # tests/op_test.py, bfloat16
SHAPE = (4, 3, 64, 64)


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batches(n=2):
    rng = np.random.default_rng(11)
    return [(rng.standard_normal(SHAPE).astype(np.float32),
             rng.integers(0, 10, SHAPE[0]).astype(np.int64)) for _ in range(n)]


def _jax_run(kw, batches, o2=False):
    paddle.seed(0)
    jm = jresnet.resnet18(num_classes=10, data_format="NCHW")
    weights = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    opt = paddle.optimizer.Momentum(parameters=jm.parameters(), **kw)
    if o2:
        jm, opt = paddle.amp.decorate(jm, opt, level="O2", dtype="bfloat16")
    step = paddle.jit.TrainStep(jm, lambda m, x, y: JF.cross_entropy(m(x), y).mean(), opt)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
              for x, y in batches]
    after = {k: np.asarray(v.astype("float32").numpy()) for k, v in jm.state_dict().items()}
    return weights, losses, after


def _port_run(model, kw, batches, dtype=torch.float32):
    opt = Momentum(parameters=model.parameters(), **kw)
    step = TrainStep(model, lambda m, x, y: F.cross_entropy(m(x), y).mean(), opt)
    losses = [float(step(torch.from_numpy(x).to(dtype), torch.from_numpy(y)))
              for x, y in batches]
    after = {k: v.double().numpy() for k, v in model.state_dict().items()
             if v.is_floating_point()}
    return losses, after, opt


@pytest.mark.parametrize("kw", [dict(learning_rate=0.01),
                                dict(learning_rate=0.01, momentum=0.8, use_nesterov=True,
                                     weight_decay=paddle.optimizer.L2Decay(1e-4))],
                         ids=["momentum", "nesterov_l2"])
def test_resnet18_momentum_train_steps(kw):
    batches = _batches()
    weights, want_losses, want = _jax_run(kw, batches)
    port_kw = dict(kw)
    if "weight_decay" in kw:
        port_kw["weight_decay"] = ptt.optimizer.L2Decay(kw["weight_decay"].coeff)
    model = resnet.resnet18(num_classes=10, data_format="NCHW")
    load_numpy_state_dict(model, weights)
    losses, got, _ = _port_run(model, port_kw, batches)
    np.testing.assert_allclose(losses, want_losses, **GRAD)
    assert set(got) <= set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], **GRAD, err_msg=k)
        assert not np.array_equal(g, weights[k]), f"{k} did not move"


def test_resnet18_amp_o2_step():
    """One bf16 O2 Momentum step: the loss within the bf16 row of the
    reference's bf16 step, f32 batch norms, f32 masters and velocities."""
    batches = _batches(1)
    weights, want_losses, _ = _jax_run(dict(learning_rate=0.01), batches, o2=True)
    model = resnet.resnet18(num_classes=10, data_format="NCHW")
    load_numpy_state_dict(model, weights)
    opt = Momentum(0.01, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, lambda m, x, y: F.cross_entropy(m(x), y).mean(), opt)
    x, y = batches[0]
    loss = step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), want_losses[0], **BF16)
    assert model.conv1.weight.dtype == torch.bfloat16
    assert model.bn1.weight.dtype == model.bn1._mean.dtype == torch.float32
    sd = opt.state_dict()
    masters = [k for k in sd if k.endswith(".master_weight")]
    velocities = [k for k in sd if k.endswith(".velocity")]
    assert len(velocities) == sum(p.requires_grad for p in model.parameters())
    assert len(masters) == sum(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(sd[k].dtype == torch.float32 for k in masters + velocities)
