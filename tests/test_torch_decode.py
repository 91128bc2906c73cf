"""The port's recurrent cells, ``gather_tree`` and the decoding API
(``BeamSearchDecoder``, ``dynamic_decode``) against the JAX package, on the
CPU (the counterpart of ``test_decode.py``).

The JAX cells, embedding and output layer are built from a seed and their
weights cross to the port's through ``convert.py``; the same numpy inputs
go through both.  Cell outputs agree within the f32 row of
``tests/op_test.py`` (rtol 2e-5, atol 1e-6); ``gather_tree`` is exact;
``dynamic_decode``'s back-traced ids are exact against the JAX package's
and against the reference's eager numpy replica of the beam step
(``_ref_beam_decode``), with and without the length penalty, and its
lengths and final log-probabilities agree.  The reference's four tests of
its compiled-scan cache (``_dyndec_cache``, ``_DYNDEC_CACHE_MAX``) have no
counterpart: the eager loop compiles nothing; a step kwarg reaches every
step with its value of that call.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.tensor.tensor import Tensor

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as F

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)    # tests/op_test.py, float32
NEG = 1e9


@pytest.fixture(autouse=True)
def _on_cpu():
    """The cells are layers built on the default device: the CPU here."""
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _carry(jax_layer, torch_layer):
    load_numpy_state_dict(torch_layer, {k: np.asarray(v.numpy())
                                        for k, v in jax_layer.state_dict().items()})
    return torch_layer


def _log_softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def _ref_beam_decode(cell_np, embed_w, out_w, out_b, h0, start, end, K, max_step_num,
                     alpha=0.0):
    """``test_decode.py``'s eager numpy replica of the reference's beam
    step, then the gather_tree back-trace; returns ids [T, b, K]."""
    batch, H = h0.shape
    V = out_w.shape[1]
    h = np.repeat(h0[:, None, :], K, axis=1)
    log_probs = np.tile([[0.0] + [-NEG] * (K - 1)], (batch, 1))
    finished = np.zeros((batch, K), bool)
    lengths = np.zeros((batch, K), np.int64)
    tok = np.full((batch, K), start, np.int64)
    all_pred, all_parent = [], []
    for _ in range(max_step_num + 1):
        emb = embed_w[tok]
        h_new = cell_np(emb.reshape(batch * K, -1), h.reshape(batch * K, H)).reshape(batch, K, H)
        step_lp = _log_softmax(h_new @ out_w + out_b)
        noend = np.full((V,), -NEG)
        noend[end] = 0.0
        step_lp = np.where(finished[:, :, None], noend[None, None, :], step_lp)
        raw3 = step_lp + log_probs[:, :, None]
        raw = raw3.reshape(batch, K * V)
        if alpha:
            cand_len = lengths + (~finished).astype(np.int64)
            lp = ((5.0 + cand_len.astype(np.float32)) / 6.0) ** alpha
            sel = (raw3 / lp[:, :, None]).reshape(batch, K * V)
        else:
            sel = raw
        idx = np.argsort(-sel, axis=1, kind="stable")[:, :K]
        beam = idx // V
        token = (idx % V).astype(np.int64)
        log_probs = np.take_along_axis(raw, idx, axis=1)
        h = np.take_along_axis(h_new, beam[:, :, None], axis=1)
        finished = np.take_along_axis(finished, beam, axis=1)
        lengths = np.take_along_axis(lengths, beam, axis=1) + (~finished).astype(np.int64)
        finished = finished | (token == end)
        tok = token
        all_pred.append(token)
        all_parent.append(beam)
    pred, parent = np.stack(all_pred), np.stack(all_parent)
    out = np.zeros_like(pred)
    ptr = np.tile(np.arange(K)[None, :], (batch, 1))
    for ti in range(pred.shape[0] - 1, -1, -1):
        out[ti] = np.take_along_axis(pred[ti], ptr, axis=1)
        ptr = np.take_along_axis(parent[ti], ptr, axis=1)
    return out


def _gru_np(cell):
    wi, wh = cell.weight_ih.detach().numpy(), cell.weight_hh.detach().numpy()
    bi, bh = cell.bias_ih.detach().numpy(), cell.bias_hh.detach().numpy()

    def f(x, h):
        gi, gh = x @ wi.T + bi, h @ wh.T + bh
        H_ = h.shape[1]
        rz = 1.0 / (1.0 + np.exp(-(gi[:, :2 * H_] + gh[:, :2 * H_])))
        r, z = rz[:, :H_], rz[:, H_:]
        c = np.tanh(gi[:, 2 * H_:] + r * gh[:, 2 * H_:])
        return (h - c) * z + c

    return f


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
CELLS = {"simple_tanh": (jnn.SimpleRNNCell, nn.SimpleRNNCell, dict(activation="tanh")),
         "simple_relu": (jnn.SimpleRNNCell, nn.SimpleRNNCell, dict(activation="relu")),
         "lstm": (jnn.LSTMCell, nn.LSTMCell, {}),
         "gru": (jnn.GRUCell, nn.GRUCell, {})}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_matches_reference(name):
    jcls, tcls, kw = CELLS[name]
    paddle.seed(1)
    jc = jcls(6, 10, **kw)
    tc = _carry(jc, tcls(6, 10, **kw))
    assert sorted(tc.state_dict()) == sorted(jc.state_dict())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    if name == "lstm":
        h = rng.standard_normal((5, 10)).astype(np.float32)
        c = rng.standard_normal((5, 10)).astype(np.float32)
        jo, (jh, jcc) = jc(Tensor(x), (Tensor(h), Tensor(c)))
        to, (th, tcc) = tc(torch.as_tensor(x), (torch.as_tensor(h), torch.as_tensor(c)))
        pairs = ((to, jo), (th, jh), (tcc, jcc))
    else:
        h = rng.standard_normal((5, 10)).astype(np.float32)
        jo, jh = jc(Tensor(x), Tensor(h))
        to, th = tc(torch.as_tensor(x), torch.as_tensor(h))
        pairs = ((to, jo), (th, jh))
    for t, j in pairs:
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), **F32)
    # no state given: zeros, as in the reference
    jz, tz = jc(Tensor(x)), tc(torch.as_tensor(x))
    np.testing.assert_allclose(tz[0].detach().numpy(), jz[0].numpy(), **F32)


def test_cell_disabled_params_and_validation():
    cell = nn.GRUCell(4, 3, weight_hh_attr=False, bias_ih_attr=False)
    ref = jnn.GRUCell(4, 3, weight_hh_attr=False, bias_ih_attr=False)
    np.testing.assert_array_equal(cell.weight_hh.detach().numpy(), ref.weight_hh.numpy())
    np.testing.assert_array_equal(cell.bias_ih.detach().numpy(), ref.bias_ih.numpy())
    assert not cell.weight_hh.requires_grad and not cell.bias_ih.requires_grad
    assert cell.weight_ih.requires_grad
    bound = 1 / np.sqrt(3)
    assert np.abs(cell.weight_ih.detach().numpy()).max() <= bound
    with pytest.raises(ValueError, match="hidden_size"):
        nn.LSTMCell(4, 0)
    with pytest.raises(ValueError, match="activation"):
        nn.SimpleRNNCell(4, 3, activation="gelu")
    states = nn.LSTMCell(4, 3).get_initial_states(torch.zeros(2, 4))
    assert [tuple(s.shape) for s in states] == [(2, 3), (2, 3)]


# ---------------------------------------------------------------------------
# gather_tree
# ---------------------------------------------------------------------------
def test_gather_tree_matches_reference():
    rng = np.random.default_rng(3)
    T, b, K = 7, 3, 4
    ids = rng.integers(0, 50, (T, b, K)).astype(np.int32)
    parents = rng.integers(0, K, (T, b, K)).astype(np.int32)
    want = JF.gather_tree(Tensor(ids), Tensor(parents)).numpy()
    got = F.gather_tree(torch.as_tensor(ids), torch.as_tensor(parents)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


# ---------------------------------------------------------------------------
# BeamSearchDecoder + dynamic_decode
# ---------------------------------------------------------------------------
V, E, H, K = 23, 8, 16, 4


@pytest.fixture(scope="module")
def layers():
    paddle.seed(11)
    jl = (jnn.Embedding(V, E), jnn.GRUCell(E, H), jnn.Linear(H, V))
    tl = (_carry(jl[0], nn.Embedding(V, E, device="cpu")), _carry(jl[1], nn.GRUCell(E, H, device="cpu")),
          _carry(jl[2], nn.Linear(H, V, device="cpu")))
    return jl, tl


def _decoders(layers, **kw):
    (je, jc, jo), (te, tc, to) = layers
    return (jnn.BeamSearchDecoder(jc, start_token=0, end_token=1, beam_size=K,
                                  embedding_fn=je, output_fn=jo, **kw),
            nn.BeamSearchDecoder(tc, start_token=0, end_token=1, beam_size=K,
                                 embedding_fn=te, output_fn=to, **kw))


@pytest.mark.parametrize("alpha", [0.0, 0.8])
def test_dynamic_decode_matches_reference(layers, alpha):
    jdec, tdec = _decoders(layers, length_penalty=alpha)
    batch, max_step = 3, 7
    h0 = np.random.default_rng(2).standard_normal((batch, H)).astype(np.float32)
    jout, jst, jlen = jnn.dynamic_decode(jdec, inits=Tensor(h0), max_step_num=max_step,
                                         return_length=True)
    with torch.no_grad():
        tout, tst, tlen = nn.dynamic_decode(tdec, inits=torch.as_tensor(h0),
                                            max_step_num=max_step, return_length=True)
    assert tuple(tout.shape) == (batch, max_step + 1, K)
    np.testing.assert_array_equal(tout.numpy(), jout.numpy())
    want = _ref_beam_decode(_gru_np(layers[1][1]), layers[1][0].weight.detach().numpy(),
                            layers[1][2].weight.detach().numpy(),
                            layers[1][2].bias.detach().numpy(), h0, 0, 1, K, max_step,
                            alpha=alpha)
    np.testing.assert_array_equal(tout.numpy(), np.transpose(want, (1, 0, 2)))
    np.testing.assert_array_equal(tlen.numpy(), jlen.numpy())
    np.testing.assert_array_equal(tst.finished.numpy(), jst.finished.numpy())
    np.testing.assert_array_equal(tst.lengths.numpy(), jst.lengths.numpy())
    np.testing.assert_allclose(tst.log_probs.numpy(), jst.log_probs.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tst.cell_states.numpy(), jst.cell_states.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_dynamic_decode_time_major_is_test_and_lengths(layers):
    """is_test skips finalize: the stacked OutputWrapper comes back, time
    major, equal to the JAX package's field by field."""
    jdec, tdec = _decoders(layers)
    batch, max_step = 2, 5
    h0 = np.random.default_rng(1).standard_normal((batch, H)).astype(np.float32)
    jout, _, jlen = jnn.dynamic_decode(jdec, inits=Tensor(h0), max_step_num=max_step,
                                       output_time_major=True, is_test=True,
                                       return_length=True)
    with torch.no_grad():
        tout, _, tlen = nn.dynamic_decode(tdec, inits=torch.as_tensor(h0),
                                          max_step_num=max_step, output_time_major=True,
                                          is_test=True, return_length=True)
    assert type(tout).__name__ == "OutputWrapper"
    assert tuple(tout.predicted_ids.shape) == (max_step + 1, batch, K)
    np.testing.assert_array_equal(tout.predicted_ids.numpy(), jout.predicted_ids.numpy())
    np.testing.assert_array_equal(tout.parent_ids.numpy(), jout.parent_ids.numpy())
    np.testing.assert_allclose(tout.scores.numpy(), jout.scores.numpy(), rtol=1e-5, atol=1e-5)
    assert tuple(tlen.shape) == (batch, K) and (tlen.numpy() <= max_step + 1).all()
    np.testing.assert_array_equal(tlen.numpy(), jlen.numpy())


def test_lstm_beam_decoder_nested_states():
    """An LSTM cell's (h, c) states ride the beam bookkeeping as a tuple."""
    paddle.seed(4)
    je, jc, jo = jnn.Embedding(V, E), jnn.LSTMCell(E, H), jnn.Linear(H, V)
    te, tc = _carry(je, nn.Embedding(V, E, device="cpu")), _carry(jc, nn.LSTMCell(E, H))
    to = _carry(jo, nn.Linear(H, V, device="cpu"))
    rng = np.random.default_rng(6)
    h0, c0 = (rng.standard_normal((2, H)).astype(np.float32) for _ in range(2))
    jdec = jnn.BeamSearchDecoder(jc, 0, 1, K, embedding_fn=je, output_fn=jo)
    tdec = nn.BeamSearchDecoder(tc, 0, 1, K, embedding_fn=te, output_fn=to)
    jout, jst = jnn.dynamic_decode(jdec, inits=(Tensor(h0), Tensor(c0)), max_step_num=6)
    with torch.no_grad():
        tout, tst = nn.dynamic_decode(tdec, inits=(torch.as_tensor(h0), torch.as_tensor(c0)),
                                      max_step_num=6)
    np.testing.assert_array_equal(tout.numpy(), jout.numpy())
    for t, j in zip(tst.cell_states, jst.cell_states):
        np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-5, atol=1e-5)


def test_length_penalty_reranks_analytically():
    """Wu et al.'s penalty: a finished 2-token hypothesis with a better raw
    score than the best 5-token continuation wins at alpha = 0 and loses
    at alpha = 1; the state keeps the raw cumulative log-prob."""
    Kb, Vb, end = 2, 3, 0
    logits_b1 = np.array([0.0, 1.0, 2.0], np.float32)
    L0, L1 = -1.0, -0.7

    def cell(inputs, states, **kw):
        return states, states   # the cell states ARE each beam's logits

    states = nn.BeamSearchDecoder.StateWrapper(
        cell_states=torch.tensor([[[9.0, 9.0, 9.0], logits_b1.tolist()]]),
        log_probs=torch.tensor([[L0, L1]]),
        finished=torch.tensor([[True, False]]),
        lengths=torch.tensor([[2, 4]], dtype=torch.int32))
    inputs = torch.zeros((1, Kb), dtype=torch.int32)
    best_raw_b1 = L1 + _log_softmax(logits_b1[None])[0][2]
    assert L0 > best_raw_b1 and best_raw_b1 / (10 / 6) > L0 / (7 / 6)

    def run(alpha):
        dec = nn.BeamSearchDecoder(cell, start_token=0, end_token=end, beam_size=Kb,
                                   length_penalty=alpha)
        return dec.step(0, inputs, states)

    out0, st0, _, _ = run(0.0)
    assert int(out0.parent_ids[0, 0]) == 0 and int(out0.predicted_ids[0, 0]) == end
    np.testing.assert_allclose(float(out0.scores[0, 0]), L0, rtol=1e-6)
    np.testing.assert_array_equal(out0.scores.numpy(), st0.log_probs.numpy())

    out1, st1, _, _ = run(1.0)
    assert int(out1.parent_ids[0, 0]) == 1 and int(out1.predicted_ids[0, 0]) == 2
    np.testing.assert_allclose(float(out1.scores[0, 0]), best_raw_b1 / (10 / 6), rtol=1e-6)
    np.testing.assert_allclose(float(st1.log_probs[0, 0]), best_raw_b1, rtol=1e-6)
    assert int(st1.lengths[0, 0]) == 5
    assert int(out1.parent_ids[0, 1]) == 0 and int(out1.predicted_ids[0, 1]) == end
    assert int(st1.lengths[0, 1]) == 2 and bool(st1.finished[0, 1])


def test_dynamic_decode_requires_static_bound(layers):
    _, tdec = _decoders(layers)
    with pytest.raises(ValueError, match="max_step_num"):
        nn.dynamic_decode(tdec, inits=torch.zeros(1, H))


def test_tile_beam_merge_with_batch():
    x = np.arange(6).reshape(3, 2).astype(np.float32)
    tiled = nn.BeamSearchDecoder.tile_beam_merge_with_batch(torch.as_tensor(x), 2).numpy()
    want = jnn.BeamSearchDecoder.tile_beam_merge_with_batch(Tensor(x), 2).numpy()
    np.testing.assert_array_equal(tiled, want)
    assert tiled.shape == (6, 2)


class _KwDecoder(nn.Decoder):
    """A decoder whose step scales its input by a kwarg, finishes nothing,
    and has no finalize."""

    def initialize(self, inits):
        return inits, inits, torch.zeros((inits.shape[0],), dtype=torch.bool)

    def step(self, time, inputs, states, scale=1.0):
        out = inputs * scale
        return out, out, out, torch.zeros((inputs.shape[0],), dtype=torch.bool)


def test_step_kwargs_take_each_calls_value():
    """A step kwarg reaches every step with this call's value: a changed
    value is never stale (the reference's cache keys on it; the eager loop
    has nothing to cache)."""
    dec = _KwDecoder()
    h0 = torch.ones((2, 4))
    for scale in (2.0, 3.0, 2.0):
        out, _ = nn.dynamic_decode(dec, inits=h0, max_step_num=2, scale=scale)
        assert tuple(out.shape) == (2, 3, 4)
        for t in range(3):
            np.testing.assert_allclose(out[:, t].numpy(), scale ** (t + 1))


class _CountDecoder(nn.Decoder):
    """Row i finishes after step i; its state counts steps."""

    def initialize(self, inits):
        return inits, inits, torch.zeros((inits.shape[0],), dtype=torch.bool)

    def step(self, time, inputs, states):
        new = states + 1
        fin = torch.arange(states.shape[0]) <= time
        return new, new, new, fin


@pytest.mark.parametrize("impute", [False, True])
def test_impute_finished_and_lengths(impute):
    """Lengths count the steps a row was unfinished at its start; with
    impute_finished a finished row's state is carried, not stepped."""
    out, st, lens = nn.dynamic_decode(_CountDecoder(), inits=torch.zeros(3, 1), max_step_num=4,
                                      impute_finished=impute, return_length=True)
    assert lens.tolist() == [1, 2, 3]
    assert st[:, 0].tolist() == ([1.0, 2.0, 3.0] if impute else [5.0] * 3)
