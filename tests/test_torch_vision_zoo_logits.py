"""Each family of the port's vision zoo in eval against the JAX package's,
on the CPU, at the shapes of ``tests/test_vision_zoo.py``'s forward tests:
the JAX model's weights (and batch-norm statistics) carried across through
``convert.load_numpy_state_dict``, the state dicts' names and shapes equal,
the logits (GoogLeNet's three heads) within the f32 row of
``tests/op_test.py``; and the port's weights carried back into a JAX model.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import models as JM

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.vision import models as M

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)     # tests/op_test.py, float32


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _arrays(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _close(got, want):
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("name,kw,shape", [
    ("LeNet", dict(num_classes=10), (2, 1, 28, 28)),
    ("alexnet", dict(num_classes=7), (2, 3, 224, 224)),
    ("vgg11", dict(num_classes=5), (1, 3, 224, 224)),
    ("mobilenet_v2", dict(num_classes=6), (2, 3, 224, 224)),
    ("mobilenet_v1", dict(num_classes=6), (2, 3, 224, 224)),
    ("squeezenet1_1", dict(num_classes=9), (2, 3, 224, 224)),
    ("densenet121", dict(num_classes=8), (1, 3, 224, 224)),
    ("shufflenet_v2_x0_5", dict(num_classes=6), (2, 3, 224, 224)),
    ("mobilenet_v3_small", dict(num_classes=7), (2, 3, 224, 224)),
    ("inception_v3", dict(num_classes=5), (1, 3, 299, 299)),
    ("googlenet", dict(num_classes=6), (1, 3, 224, 224)),
])
def test_eval_logits_against_the_reference(name, kw, shape):
    paddle.seed(0)
    jm = getattr(JM, name)(**kw)
    # seeded batch-norm statistics, so that eval normalises by non-trivial ones
    rng = np.random.default_rng(1)
    weights = _arrays(jm)
    for k, v in weights.items():
        if k.endswith("_mean"):
            weights[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("_variance"):
            weights[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    jm.set_state_dict(weights)
    jm.eval()
    model = getattr(M, name)(**kw).eval()
    want_shapes = {k: v.shape for k, v in weights.items()}
    got_shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert list(got_shapes) == list(want_shapes) and got_shapes == want_shapes
    load_numpy_state_dict(model, weights)
    x = rng.standard_normal(shape).astype(np.float32)
    want = jm(paddle.to_tensor(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    if name == "googlenet":
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _close(g.numpy(), np.asarray(w.numpy()))
    else:
        assert tuple(got.shape) == (shape[0], kw["num_classes"])
        _close(got.numpy(), np.asarray(want.numpy()))


def test_port_weights_into_the_reference():
    """A state dict of the port's, through numpy, gives the port's logits in
    a fresh JAX model."""
    model = M.squeezenet1_1(num_classes=5, generator=torch.Generator().manual_seed(7)).eval()
    paddle.seed(1)
    jm = JM.squeezenet1_1(num_classes=5)
    missing, unexpected = jm.set_state_dict({k: v.numpy() for k, v in
                                             model.state_dict().items()})
    assert not missing and not unexpected
    jm.eval()
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(jm(paddle.to_tensor(x)).numpy()))
