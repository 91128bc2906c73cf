"""The port's image layers (ROADMAP A3b: ``nn/layer/conv.py``,
``pooling.py``, ``norm.py``'s batch, group, instance and local-response
norms, ``common.py``'s image layers) against the JAX package's, on the
CPU: each layer built in both packages with the reference's arguments and
the reference's parameters and buffers carried across, then outputs,
gradients and state dicts compared.  The transposed convolutions, which
the JAX package cannot run on JAX 0.9, are held against the reference's
formula (``tests/test_torch_conv.py``).  Tolerances are the rows of
``tests/op_test.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.convert import load_numpy_state_dict

from test_torch_conv import F32, GRAD, _check_jnp, _np, _ref_transpose
from test_torch_dropout import FedMasks

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _carried(name, *args, **kw):
    """The layer ``name`` of both packages, the reference's state carried
    into the port's."""
    ref = getattr(jnn, name)(*args, **kw)
    port = getattr(nn, name)(*args, **kw)
    assert list(port.state_dict()) == list(ref.state_dict())
    load_numpy_state_dict(port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


LAYERS = {  # name: (constructor args, input shape)
    "Conv1D": ((4, 6, 3, 2, 1), (2, 4, 9)),
    "Conv2D": ((4, 6, 3, 2, "SAME", 1, 2), (2, 4, 7, 8)),
    "Conv3D": ((4, 6, 3, 1, 1), (2, 4, 3, 4, 5)),
    "MaxPool1D": ((3, 2, 1), (2, 3, 9)),
    "MaxPool2D": ((3, 2, 1, False, True), (2, 3, 8, 9)),
    "MaxPool3D": ((2,), (2, 3, 4, 5, 6)),
    "AvgPool1D": ((3, 2, 1, False), (2, 3, 9)),
    "AvgPool2D": ((3, 2, 1, True, True), (2, 3, 8, 9)),
    "AvgPool3D": ((2, 2, 1), (2, 3, 4, 5, 6)),
    "AdaptiveAvgPool1D": ((4,), (2, 3, 9)),
    "AdaptiveAvgPool2D": (((3, None),), (2, 3, 8, 9)),
    "AdaptiveAvgPool3D": ((2,), (2, 3, 4, 5, 6)),
    "AdaptiveMaxPool1D": ((4,), (2, 3, 9)),
    "AdaptiveMaxPool2D": (((3, 4),), (2, 3, 8, 9)),
    "AdaptiveMaxPool3D": (((2, 3, 2),), (2, 3, 4, 5, 6)),
    "BatchNorm": ((3,), (4, 3, 5, 6)),
    "BatchNorm1D": ((3,), (4, 3, 7)),
    "BatchNorm2D": ((3,), (4, 3, 5, 6)),
    "BatchNorm3D": ((3,), (4, 3, 2, 3, 4)),
    "SyncBatchNorm": ((3,), (4, 3, 5, 6)),
    "GroupNorm": ((2, 4), (2, 4, 5, 6)),
    "InstanceNorm1D": ((3,), (2, 3, 7)),
    "InstanceNorm2D": ((3,), (2, 3, 5, 6)),
    "InstanceNorm3D": ((3,), (2, 3, 2, 3, 4)),
    "LocalResponseNorm": ((3,), (2, 5, 4, 4)),
    "Upsample": (((7, 9), None, "bilinear", True), (2, 3, 4, 5)),
    "UpsamplingBilinear2D": ((None, 2), (2, 3, 4, 5)),
    "UpsamplingNearest2D": (((5, 7),), (2, 3, 4, 5)),
    "Pad1D": (([1, 2], "reflect"), (2, 3, 5)),
    "Pad2D": (([1, 2, 0, 1], "replicate"), (2, 3, 4, 5)),
    "Pad3D": (([1, 0, 0, 1, 2, 1], "constant", 0.5), (2, 3, 2, 3, 4)),
    "PixelShuffle": ((2,), (2, 8, 3, 4)),
    "PixelUnshuffle": ((2,), (2, 3, 4, 6)),
    "ChannelShuffle": ((3,), (2, 6, 3, 4)),
    "Unfold": (([2, 3], 1, 1), (2, 3, 5, 6)),
    "ZeroPad2D": (([1, 2, 0, 1],), (2, 3, 4, 5)),
    "Dropout2D": ((0.0,), (2, 3, 4, 5)),
    "Dropout3D": ((0.0,), (2, 3, 2, 4, 5)),
    "AlphaDropout": ((0.0,), (2, 3, 4)),
}


# the batch norms read their mode; every other layer computes the same in both
CASES = [(name, "train") for name in sorted(LAYERS)] + \
    [(name, "eval") for name in sorted(LAYERS) if "BatchNorm" in name]


@pytest.mark.parametrize("name, mode", CASES)
def test_layer_matches_reference(name, mode):
    """Outputs, the gradients of the input and of every parameter, and the
    state dicts (a batch norm's running buffers after a training forward)."""
    args, shape = LAYERS[name]
    paddle.seed(1)
    ref, port = _carried(name, *args)
    getattr(ref, mode)()
    getattr(port, mode)()
    x = _np(70, *shape)
    tx, jx = torch.from_numpy(x).requires_grad_(), paddle.to_tensor(x, stop_gradient=False)
    got, want = port(tx), ref(jx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()), **F32)
    cot = _np(71, *got.shape)
    (got * torch.from_numpy(cot)).sum().backward()
    (want * paddle.to_tensor(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()), **GRAD)
    jgrads = dict(ref.named_parameters())
    for pname, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[pname].grad.numpy()),
                                   **GRAD, err_msg=pname)
    jstate = ref.state_dict()
    for key, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), np.asarray(jstate[key].numpy()), **F32,
                                   err_msg=key)


def test_bilinear_layer_and_nhwc_layers():
    paddle.seed(2)
    ref, port = _carried("Bilinear", 4, 5, 3)
    a, b = _np(72, 2, 4), _np(73, 2, 5)
    np.testing.assert_allclose(port(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy(),
                               np.asarray(ref(paddle.to_tensor(a), paddle.to_tensor(b)).numpy()),
                               **F32)
    x = _np(74, 2, 6, 7, 4)
    for cls, args in (("Conv2D", (4, 6, 3, 1, 1)), ("BatchNorm2D", (4,)),
                      ("MaxPool2D", (3, 2, 1)), ("AvgPool2D", (2,))):
        paddle.seed(3)
        ref, port = _carried(cls, *args, data_format="NHWC")
        np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(ref(paddle.to_tensor(x)).numpy()), **F32,
                                   err_msg=cls)


def test_layer_refusals_and_sync_batch_norm(monkeypatch):
    with pytest.raises(NotImplementedError):
        nn.SpectralNorm()
    fed = FedMasks(monkeypatch, seed=140)   # Dropout2D trains: the reference's channels
    x = np.arange(1, 37, dtype=np.float32).reshape(2, 2, 3, 3)
    np.testing.assert_allclose(nn.Dropout2D(0.5)(torch.from_numpy(x)).numpy(),
                               np.asarray(jnn.Dropout2D(0.5)(paddle.to_tensor(x)).numpy()),
                               **F32)
    fed.check_same_draws(1)
    with pytest.raises(NotImplementedError, match="NCHW only"):
        nn.AdaptiveMaxPool2D(2, data_format="NHWC")(torch.ones(1, 3, 3, 2))
    model = nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4, momentum=0.5))
    model[1]._mean.fill_(0.25)
    synced = nn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert isinstance(synced[1], nn.SyncBatchNorm)
    assert float(synced[1]._mean[0]) == 0.25 and synced[1]._momentum == 0.5
    assert nn.Conv2D(3, 4, 3, bias_attr=False).bias is None


def test_layers_build_on_the_default_device():
    ptt.set_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            nn.Conv2D(3, 4, 3)
        with pytest.raises(RuntimeError, match="CUDA"):
            nn.BatchNorm2D(4)
    conv = nn.Conv2D(3, 4, 3, device="cpu")
    bn = nn.BatchNorm2D(4, device="cpu")
    assert conv.weight.device.type == bn._mean.device.type == "cpu"


@pytest.mark.parametrize("nd, args, fmt", [
    (1, (4, 6, 3, 2, 1, 1), "NCL"), (2, (4, 6, 3, 2, [1, 0], [1, 0], 2), "NCHW"),
    (2, (4, 6, 3, 1, 1, 0, 1, 2), "NHWC"), (3, (4, 6, 3, 2, 1), "NCDHW")])
def test_transposed_conv_layers(nd, args, fmt):
    """Weight shapes and names as the reference's, the default
    initializer's bound, and the forward (and grads) against the
    reference's formula with the layer's own weights."""
    name = f"Conv{nd}DTranspose"
    paddle.seed(4)
    port = getattr(nn, name)(*args, data_format=fmt)
    ref = getattr(jnn, name)(*args, data_format=fmt)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    cin, cout, _, stride, pad = args[:5]
    opad, groups, dil = (tuple(args[5:]) + (0, 1, 1)[len(args) - 5:])[:3]
    assert float(port.weight.abs().max()) <= 1 / np.sqrt(cin // groups * 3 ** nd)
    shape = (2, cin) + (4,) * nd
    x = _np(75, *shape)
    if not fmt.startswith("NC"):
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    w, b = port.weight.detach().numpy(), port.bias.detach().numpy()
    fn = getattr(nn.functional, f"conv{nd}d_transpose")
    _check_jnp(lambda v, ww, bb: fn(v, ww, bb, stride, pad, opad, groups, dil, None, fmt),
               _ref_transpose(nd, stride, pad, opad, dil, groups, fmt), [x, w, b])
    got = port(torch.from_numpy(x))
    want = fn(torch.from_numpy(x), port.weight, port.bias, stride, pad, opad, groups, dil,
              None, fmt)
    assert torch.equal(got, want)
