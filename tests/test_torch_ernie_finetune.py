"""The ERNIE fine-tune (``bench.py``'s ladder row 2 at the tiny config) of
the port against the JAX package's, on the CPU:
``ErnieForSequenceClassification`` with dropout 0.1, the JAX model's
weights carried across (``convert.py``), ``AdamW`` with
``ClipGradByGlobalNorm(1.0)``, ``jit.TrainStep``, in f32 and under
``amp.decorate`` O2 bf16, three steps on one batch.

Both packages are fed the same masks (``test_torch_dropout.FedMasks``):
the JAX step draws its masks once, while it is traced, so the port's steps
are fed those masks on every step, and both must ask for the same sequence
of shapes: the embeddings, then the attention probabilities, the
attention residual, the FFN activation and the FFN residual of each
layer, then the pooled output.  Losses within rtol 1e-4 in f32 (the
training row of ``test_torch_train.py``) and 2e-2 in bf16 (``op_test``'s
bf16 row); parameters as ``test_torch_train.py`` holds them (Adam's first
steps may move a component with a near-zero gradient by ±lr either way;
the key projections' biases, which softmax ignores, have only rounding
for a gradient and are held to the ±lr bound alone).
The eager idiom (``loss.backward(); opt.step(); opt.clear_grad()``) is
held to the same JAX step.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ernie as jernie

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import ernie
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from test_torch_dropout import FedMasks

torch.set_num_threads(1)

LOSS = dict(rtol=1e-4, atol=0)      # f32 training losses (test_torch_train.py)
BF16 = dict(rtol=2e-2, atol=2e-2)   # tests/op_test.py, bfloat16
LR, STEPS, B, S = 1e-3, 3, 4, 16


def _pair(seed):
    paddle.seed(seed)
    jm = jernie.ErnieForSequenceClassification(jernie.ernie_tiny(), 2)
    tm = ernie.ErnieForSequenceClassification(ernie.ernie_tiny(), 2, device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed):
    """``bench.py``'s batch: ids and labels from ``default_rng``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, ernie.ernie_tiny().vocab_size, (B, S)).astype(np.int32)
    return ids, rng.integers(0, 2, (B,)).astype(np.int64)


def _jax_steps(jm, batch, amp):
    opt = paddle.optimizer.AdamW(LR, parameters=jm.parameters(),
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    if amp:
        jm, opt = paddle.amp.decorate(jm, opt, level="O2", dtype="bfloat16")
    step = paddle.jit.TrainStep(jm, lambda m, x, y: m(x, labels=y)[0], opt)
    ids, labels = paddle.to_tensor(batch[0]), paddle.to_tensor(batch[1])
    return jm, [float(step(ids, labels)) for _ in range(STEPS)]


def _port_steps(tm, batch, amp, fed, eager=False):
    opt = AdamW(LR, parameters=tm.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    if amp:
        tm, opt = ptt.amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    step = TrainStep(tm, lambda m, x, y: m(x, labels=y)[0], opt)
    losses = []
    for _ in range(STEPS):
        fed.rewind()
        if eager:
            loss = tm(batch[0], labels=batch[1])[0]
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        else:
            losses.append(float(step(*batch)))
    return tm, opt, losses


def _draws(layers):
    """The reference's mask requests of one step, in order."""
    h, heads, ff = 64, 4, 128
    per_layer = [("mask", (B, heads, S, S), 0.9), ("mask", (B, S, h), 0.9),
                 ("mask", (B, S, ff), 0.9), ("mask", (B, S, h), 0.9)]
    return [("mask", (B, S, h), 0.9)] + per_layer * layers + [("mask", (B, h), 0.9)]


@pytest.mark.parametrize("mode", ["f32", "bf16_o2", "f32_eager"])
def test_finetune_steps_follow_jax(monkeypatch, mode):
    amp = mode == "bf16_o2"
    jm, tm = _pair(30)
    fed = FedMasks(monkeypatch, seed=31)
    batch = _batch(4)
    jm, jl = _jax_steps(jm, batch, amp)
    assert fed.ref == _draws(ernie.ernie_tiny().num_hidden_layers)
    tm, opt, tl = _port_steps(tm, batch, amp, fed, eager=mode == "f32_eager")
    assert fed.port == fed.ref * STEPS
    assert all(np.isfinite(tl)) and tl[-1] < tl[0] and opt._step_count == STEPS
    np.testing.assert_allclose(tl, jl, **(BF16 if amp else LOSS))
    jparams = dict(jm.named_parameters())
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(jparams)
    for name, p in tm.named_parameters():
        want = jparams[name]
        assert str(p.dtype).replace("torch.", "") == str(want.dtype), name
        got = p.detach().float().numpy()
        want = np.asarray(want.astype("float32").numpy())
        if amp:
            np.testing.assert_allclose(got, want, **BF16, err_msg=name)
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR * STEPS, err_msg=name)
        if name.endswith("k_proj.bias"):
            continue    # softmax ignores it: its gradient is rounding, Adam moves it by its sign
        close = np.isclose(got, want, rtol=1e-3, atol=1e-5)
        assert close.mean() >= 0.99, (name, close.mean())


def test_training_and_eval_draw_as_the_reference(monkeypatch):
    """Training draws the 1 + 4 a layer + 1 masks, eval none; the training
    forward's logits and loss within the f32 training row."""
    jm, tm = _pair(32)
    fed = FedMasks(monkeypatch, seed=33)
    ids, labels = _batch(5)
    jloss, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss, logits = tm(ids, labels=labels)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS)
    fed.check_same_draws(2 + 4 * ernie.ernie_tiny().num_hidden_layers)
    jm.eval()
    tm.eval()
    np.testing.assert_allclose(tm(ids).detach().numpy(), jm(paddle.to_tensor(ids)).numpy(),
                               rtol=1e-4, atol=1e-5)
    fed.check_same_draws(2 + 4 * ernie.ernie_tiny().num_hidden_layers)


def test_real_masks_change_between_steps_and_reproduce_under_seed():
    """Without fed masks: two steps draw different masks, and ``seed``
    replays them."""
    def run():
        ptt.seed(9)
        _, tm = _pair(34)
        tm.train()
        ids, labels = _batch(6)
        return [float(tm(ids, labels=labels)[0]) for _ in range(2)]

    a, b = run(), run()
    assert a == b and a[0] != a[1]
