"""The port's recurrent layers (``nn/layer/rnn.py``: ``SimpleRNN``,
``LSTM``, ``GRU``, ``RNN``, ``BiRNN``) against the JAX package's, on the
CPU, with the JAX layers' weights carried across: outputs, final states
and the gradients of the inputs, the initial states and every parameter
under random cotangents, over one and two layers, one and two
directions, batch- and time-major inputs, given initial states and
ragged ``sequence_length``.  Tolerances are the rows of
``tests/op_test.py``: f32 for values, the f32 gradient row for
gradients.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.convert import load_numpy_state_dict
from test_torch_dropout import FedMasks

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)     # tests/op_test.py, float32
GRAD = dict(rtol=5e-3, atol=1e-4)    # tests/op_test.py, float32 gradients
B, T, IN, HID = 3, 5, 4, 6


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flat(value):
    """The tensors of an output or a state tuple, in order."""
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _flat(v)]
    return [value]


def _compare(port, ref, inputs, jinputs, leaves, jleaves):
    """Call both with their inputs; compare every output tensor, then the
    gradients of ``leaves`` and of every parameter under one cotangent per
    output tensor."""
    got, want = _flat(port(*inputs)), _flat(ref(*jinputs))
    assert len(got) == len(want)
    loss, jloss = 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w.numpy()), **F32,
                                   err_msg=f"output {i}")
        cot = _np(100 + i, *g.shape)
        loss = loss + (g * torch.from_numpy(cot)).sum()
        jloss = jloss + (w * paddle.to_tensor(cot)).sum()
    loss.backward()
    jloss.backward()
    for i, (t, j) in enumerate(zip(leaves, jleaves)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.numpy()), **GRAD,
                                   err_msg=f"leaf {i}")
    jparams = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jparams[name].grad.numpy()),
                                   **GRAD, err_msg=name)


def _pair(cls, *args, seed=0, **kw):
    paddle.seed(seed)
    ref = getattr(jnn, cls)(*args, **kw)
    port = getattr(nn, cls)(*args, **kw)
    assert list(port.state_dict()) == list(ref.state_dict())
    load_numpy_state_dict(port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return port, ref


def _leaf(a):
    return torch.from_numpy(a).requires_grad_(), paddle.to_tensor(a, stop_gradient=False)


CASES = [  # class, extra kwargs, layers, direction, time_major, initial states, lengths
    ("SimpleRNN", {}, 1, "forward", False, False, False),
    ("SimpleRNN", {"activation": "relu"}, 2, "bidirect", False, True, True),
    ("SimpleRNN", {}, 2, "forward", True, False, True),
    ("LSTM", {}, 1, "forward", False, True, False),
    ("LSTM", {}, 2, "bidirect", False, False, True),
    ("LSTM", {}, 2, "bidirectional", True, True, True),
    ("GRU", {}, 1, "bidirect", False, False, False),
    ("GRU", {}, 2, "forward", False, True, True),
    ("GRU", {}, 2, "bidirect", True, False, True),
]


@pytest.mark.parametrize("cls, kw, layers, direction, time_major, init, ragged", CASES)
def test_multi_layer_rnn(cls, kw, layers, direction, time_major, init, ragged):
    port, ref = _pair(cls, IN, HID, layers, direction, time_major, **kw)
    x = _np(1, T, B, IN) if time_major else _np(1, B, T, IN)
    tx, jx = _leaf(x)
    leaves, jleaves = [tx], [jx]
    args, jargs = [tx], [jx]
    n = layers * (2 if direction != "forward" else 1)
    if init:
        states = [_leaf(_np(2 + i, n, B, HID)) for i in range(2 if cls == "LSTM" else 1)]
        leaves += [s[0] for s in states]
        jleaves += [s[1] for s in states]
        if cls == "LSTM":
            args.append(tuple(s[0] for s in states))
            jargs.append(tuple(s[1] for s in states))
        else:
            args.append(states[0][0])
            jargs.append(states[0][1])
    else:
        args.append(None)
        jargs.append(None)
    if ragged:
        lengths = np.array([T, 2, 4], np.int64)
        args.append(torch.from_numpy(lengths))
        jargs.append(paddle.to_tensor(lengths))
    _compare(port, ref, args, jargs, leaves, jleaves)


def test_sequence_length_zeros_outputs_and_holds_states():
    port = nn.LSTM(IN, HID, 1, "bidirect")
    x = torch.from_numpy(_np(5, B, T, IN))
    lengths = torch.tensor([T, 2, 4])
    out, (h, c) = port(x, None, lengths)
    assert not out[1, 2:].any() and not out[2, 4:].any()
    short, (h_short, _) = port(x[1:2, :2])
    torch.testing.assert_close(out[1:2, :2], short)
    torch.testing.assert_close(h[:, 1:2], h_short)


@pytest.mark.parametrize("cell, reverse, time_major", [("SimpleRNNCell", False, False),
                                                       ("LSTMCell", True, False),
                                                       ("GRUCell", False, True)])
def test_rnn_wrapper(cell, reverse, time_major):
    paddle.seed(6)
    jcell = getattr(jnn, cell)(IN, HID)
    ref = jnn.RNN(jcell, is_reverse=reverse, time_major=time_major)
    port = nn.RNN(getattr(nn, cell)(IN, HID), is_reverse=reverse, time_major=time_major)
    load_numpy_state_dict(port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    tx, jx = _leaf(_np(7, T, B, IN) if time_major else _np(7, B, T, IN))
    _compare(port, ref, [tx], [jx], [tx], [jx])
    with pytest.raises(NotImplementedError, match="sequence_length"):
        port(tx, None, torch.tensor([1, 2, 3]))


def test_birnn():
    paddle.seed(8)
    ref = jnn.BiRNN(jnn.GRUCell(IN, HID), jnn.LSTMCell(IN, HID))
    port = nn.BiRNN(nn.GRUCell(IN, HID), nn.LSTMCell(IN, HID))
    assert list(port.state_dict()) == list(ref.state_dict())
    load_numpy_state_dict(port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    tx, jx = _leaf(_np(9, B, T, IN))
    h0 = _leaf(_np(10, B, HID))
    hc = (_leaf(_np(11, B, HID)), _leaf(_np(12, B, HID)))
    _compare(port, ref, [tx, (h0[0], (hc[0][0], hc[1][0]))],
             [jx, (h0[1], (hc[0][1], hc[1][1]))],
             [tx, h0[0], hc[0][0], hc[1][0]], [jx, h0[1], hc[0][1], hc[1][1]])


def test_dropout_between_layers_and_bad_direction(monkeypatch):
    """Dropout 0.5 between the layers in training (a GRU, a bidirectional
    LSTM): with the same masks fed to both packages, outputs, states and
    every gradient match; eval draws none."""
    x = _np(13, B, T, IN)
    for cls, direction in (("GRU", "forward"), ("LSTM", "bidirect")):
        port, ref = _pair(cls, IN, HID, 2, direction, seed=13, dropout=0.5)
        fed = FedMasks(monkeypatch, seed=13)
        tx, jx = _leaf(x)
        _compare(port, ref, [tx], [jx], [tx], [jx])
        dirs = 2 if direction == "bidirect" else 1
        assert fed.port == [("mask", (B, T, dirs * HID), 0.5)]
        fed.check_same_draws(1)
        assert port.eval()(torch.from_numpy(x))[0].shape == (B, T, dirs * HID)
        fed.check_same_draws(1)
    with pytest.raises(ValueError, match="direction"):
        nn.LSTM(IN, HID, direction="backward")
    ptt.set_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            nn.LSTM(IN, HID)
    assert nn.LSTM(IN, HID, device="cpu").cells[0].weight_ih.device.type == "cpu"
