"""ERNIE (``models/ernie.py``) of the port against the JAX package's on the
tiny config, in eval mode, with the JAX model's weights carried across:
the encoder, the sequence-classification and the masked-LM models, with
and without a padding mask and segment ids, their losses, the gradients
of a dropout-free training step, bf16 weights, and a training forward
with dropout, both packages fed the same masks
(``test_torch_dropout.FedMasks``).  Tolerances are the rows of ``tests/op_test.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ernie as jernie

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.models import ernie
from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
from test_torch_dropout import FedMasks

torch.set_num_threads(1)

ATTN = dict(rtol=1e-4, atol=1e-5)   # attention reductions (test_torch_train.py)
BF16 = dict(rtol=2e-2, atol=2e-2)   # tests/op_test.py, bfloat16
GRAD = dict(rtol=1e-4, atol=1e-6)   # grads (test_torch_train.py)
B, S = 2, 12

MODELS = {  # port class, reference class, extra constructor args
    "encoder": (ernie.ErnieModel, jernie.ErnieModel, ()),
    "classifier": (ernie.ErnieForSequenceClassification,
                   jernie.ErnieForSequenceClassification, (3,)),
    "masked_lm": (ernie.ErnieForMaskedLM, jernie.ErnieForMaskedLM, ()),
}


def _pair(kind, seed=0, **cfg):
    cls, jcls, args = MODELS[kind]
    config = {"hidden_dropout_prob": 0.0, **cfg}
    paddle.seed(seed)
    jm = jcls(jernie.ernie_tiny(**config), *args)
    jm.eval()
    tm = cls(ernie.ernie_tiny(**config), *args, device="cpu").eval()
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _inputs(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (B, S)).astype(np.int32)
    segments = rng.integers(0, 2, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 7:] = 0
    return ids, segments, mask


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.numpy())


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_eval_forward_matches_reference(kind, masked, segments):
    jm, tm = _pair(kind)
    ids, seg, mask = _inputs(1)
    kw = dict(token_type_ids=seg if segments else None, attention_mask=mask if masked else None)
    jkw = {k: None if v is None else paddle.to_tensor(v) for k, v in kw.items()}
    got = tm(ids, **kw)
    want = jm(paddle.to_tensor(ids), **jkw)
    pairs = zip(got, want) if kind == "encoder" else [(got, want)]
    for g, w in pairs:
        np.testing.assert_allclose(_np(g), _np(w), **ATTN)


@pytest.mark.parametrize("kind", ["classifier", "masked_lm"])
def test_losses_match_reference(kind):
    jm, tm = _pair(kind, seed=2)
    ids, seg, mask = _inputs(3)
    if kind == "classifier":
        labels = np.array([2, 0])
    else:
        labels = np.where(np.random.default_rng(4).random((B, S)) < 0.3, ids, -100)
    jloss, jlogits = jm(paddle.to_tensor(ids), paddle.to_tensor(seg), paddle.to_tensor(mask),
                        labels=paddle.to_tensor(labels))
    loss, logits = tm(ids, seg, mask, labels=labels)
    np.testing.assert_allclose(_np(loss), _np(jloss), **ATTN)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **ATTN)


def test_state_dict_names_and_published_widths():
    jm, tm = _pair("masked_lm")
    assert list(tm.state_dict()) == list(jm.state_dict())
    base = ernie.ernie3_base()
    assert (base.num_hidden_layers, base.hidden_size, base.num_attention_heads,
            base.intermediate_size, base.vocab_size, base.max_position_embeddings) == \
        (12, 768, 12, 3072, 40000, 2048)
    assert vars(base) == vars(jernie.ernie3_base())
    assert vars(ernie.ernie_tiny(num_hidden_layers=3)) == \
        vars(jernie.ernie_tiny(num_hidden_layers=3))


def test_dropout_free_training_grads_match_reference():
    """With ``hidden_dropout_prob=0`` a training step needs no random mask:
    the masked-LM loss's gradient, through the flash Function's plain pair
    where no mask is given, equals the JAX model's."""
    jm, tm = _pair("masked_lm", seed=5)
    jm.train()
    tm.train()
    ids, seg, _ = _inputs(6)
    labels = np.where(np.random.default_rng(7).random((B, S)) < 0.5, ids, -100)
    jloss, _ = jm(paddle.to_tensor(ids), paddle.to_tensor(seg), labels=paddle.to_tensor(labels))
    jloss.backward()
    loss, _ = tm(ids, seg, labels=labels)
    loss.backward()
    np.testing.assert_allclose(_np(loss), _np(jloss), **ATTN)
    jgrads = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        if jgrads[name].grad is None:   # the pooler: not on the masked-LM loss's path
            assert p.grad is None, name
            continue
        np.testing.assert_allclose(_np(p.grad), _np(jgrads[name].grad), **GRAD, err_msg=name)


def test_bf16_weights_within_the_bf16_row():
    jm, tm = _pair("classifier", seed=8)
    ids, seg, mask = _inputs(9)
    want = jm(paddle.to_tensor(ids), paddle.to_tensor(seg), paddle.to_tensor(mask))
    tm.to(dtype="bfloat16")
    assert tm.ernie.encoder.layers[0].linear1.weight.dtype == torch.bfloat16
    got = tm(ids, seg, mask)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_training_with_dropout_raises_a9(monkeypatch):
    """Training with dropout (no longer refused): with the masks fed to
    both packages, the logits with a padding mask and segment ids match
    the JAX model's, and eval draws nothing."""
    jm, tm = _pair("classifier", seed=10, hidden_dropout_prob=0.1)
    jm.train()
    tm.train()
    fed = FedMasks(monkeypatch, seed=10)
    ids, seg, mask = _inputs(10)
    got = tm(ids, seg, mask)
    want = jm(paddle.to_tensor(ids), paddle.to_tensor(seg), paddle.to_tensor(mask))
    np.testing.assert_allclose(_np(got), _np(want), **ATTN)
    fed.check_same_draws(2 + 4 * ernie.ernie_tiny().num_hidden_layers)
    assert tuple(tm.eval()(ids).shape) == (B, 3)
    fed.check_same_draws(2 + 4 * ernie.ernie_tiny().num_hidden_layers)


def test_sequence_longer_than_positions_and_default_device():
    _, tm = _pair("encoder")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm(np.zeros((1, 129), np.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ernie.ErnieModel(ernie.ernie_tiny())
    ptt.set_device("cpu")
    try:
        assert ernie.ErnieModel(ernie.ernie_tiny()).pooler.weight.device.type == "cpu"
    finally:
        ptt.set_device(None)


def test_seed_fixes_the_weights_and_cpu_launches_nothing():
    a = ernie.ErnieModel(ernie.ernie_tiny(), device="cpu", seed=3)
    b = ernie.ErnieModel(ernie.ernie_tiny(), device="cpu", seed=3)
    c = ernie.ErnieModel(ernie.ernie_tiny(), device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["pooler.weight"], sc["pooler.weight"])
    reset_launch_counts()
    a.eval()(_inputs(11)[0])
    assert not any(LAUNCHES.values())
