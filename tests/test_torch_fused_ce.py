"""The chunked fused linear + cross entropy of the port
(``F.fused_linear_cross_entropy`` and ``LlamaForCausalLM`` with
``fused_ce_chunk > 0``) against the JAX package's, on the same numpy
inputs and weights, under the tolerance rows of ``tests/op_test.py``.

The loss, ``dh`` and ``dW`` are held for divisible and non-divisible
token counts, a chunk larger than the token count, chunks whose labels
are all ignored and a batch with none left, in f32 and bf16; the tiny
Llama's loss and every gradient against the JAX model's (the JAX side's
Pallas kernels in interpret mode); the backward keeps no logits; and the
hybrid model still refuses the chunked loss, as the reference's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny

import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models.llama_parallel import LlamaForCausalLMHybrid

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)    # tests/op_test.py, float32
BF16 = dict(rtol=2e-2, atol=2e-2)   # tests/op_test.py, bfloat16
LOSS = dict(rtol=1e-4, atol=0)      # the tiny Llama's loss (test_torch_train.py)
GRAD = dict(rtol=1e-4, atol=1e-6)   # the tiny Llama's grads (test_torch_train.py)
SEQ = 16


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _pair(n, d, vocab, seed, dtype):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, vocab)) / np.sqrt(d)).astype(np.float32)
    jh = paddle.to_tensor(jnp.asarray(h).astype(dtype), stop_gradient=False)
    jw = paddle.to_tensor(jnp.asarray(w).astype(dtype), stop_gradient=False)
    th = torch.from_numpy(h).to(getattr(torch, dtype)).requires_grad_()
    tw = torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_()
    return (jh, jw), (th, tw)


def _labels(n, vocab, seed, ignored=()):
    lab = np.random.default_rng(seed).integers(0, vocab, n)
    lab[list(ignored)] = -100
    return lab


CASES = {  # n tokens, chunk, ignored rows
    "divisible": (32, 8, (3, 17)),
    "remainder": (30, 8, (0,)),
    "chunk_above_n": (12, 64, (5,)),
    "one_chunk_all_ignored": (24, 8, tuple(range(8, 16))),
    "every_token_ignored": (16, 8, tuple(range(16))),
    "chunk_of_one": (5, 1, (2,)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_reference(case, dtype):
    n, chunk, ignored = CASES[case]
    d, vocab = 16, 40
    (jh, jw), (th, tw) = _pair(n, d, vocab, 1, dtype)
    lab = _labels(n, vocab, 2, ignored)
    jloss = JF.fused_linear_cross_entropy(jh, jw, paddle.to_tensor(lab), chunk_size=chunk)
    jloss.backward()
    loss = F.fused_linear_cross_entropy(th, tw, torch.from_numpy(lab), chunk_size=chunk)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert th.grad.dtype == th.dtype and tw.grad.dtype == tw.dtype
    tol = F32 if dtype == "float32" else BF16     # bf16 inputs, bf16 logits: the bf16 row
    np.testing.assert_allclose(_f32(loss), _f32(jloss.numpy()), **tol)
    np.testing.assert_allclose(_f32(th.grad), _f32(jh.grad.numpy()), **tol)
    np.testing.assert_allclose(_f32(tw.grad), _f32(jw.grad.numpy()), **tol)
    if case == "every_token_ignored":
        assert float(loss.detach()) == 0.0 and not th.grad.any() and not tw.grad.any()


@pytest.mark.parametrize("chunk", [1, 7, 16, 100])
def test_equals_unfused_cross_entropy(chunk):
    """Any chunking gives the loss and grads of ``F.cross_entropy`` on the
    full logits."""
    (_, _), (th, tw) = _pair(16, 8, 24, 3, "float32")
    lab = torch.from_numpy(_labels(16, 24, 4, (1, 9)))
    F.fused_linear_cross_entropy(th, tw, lab, chunk_size=chunk).backward()
    h2, w2 = th.detach().clone().requires_grad_(), tw.detach().clone().requires_grad_()
    want = F.cross_entropy(h2 @ w2, lab)
    want.backward()
    torch.testing.assert_close(th.grad, h2.grad, **F32)
    torch.testing.assert_close(tw.grad, w2.grad, **F32)


def test_backward_keeps_no_logits():
    """Only hidden, weight and labels are saved for the backward: no
    [tokens, vocab] tensor outlives the forward."""
    (_, _), (th, tw) = _pair(32, 8, 50, 5, "float32")
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        loss = F.fused_linear_cross_entropy(th, tw, torch.from_numpy(_labels(32, 50, 6)),
                                            chunk_size=8)
    assert sorted(tuple(s) for s in saved) == [(8, 50), (32,), (32, 8)]
    loss.backward()
    assert th.grad.shape == (32, 8) and tw.grad.shape == (8, 50)


def test_only_hidden_grad_when_weight_is_frozen():
    (_, _), (th, tw) = _pair(12, 8, 20, 7, "float32")
    tw.requires_grad_(False)
    F.fused_linear_cross_entropy(th, tw, torch.from_numpy(_labels(12, 20, 8)),
                                 chunk_size=5).backward()
    assert th.grad is not None and tw.grad is None


@pytest.fixture
def interpret():
    """The JAX package's Pallas kernels in interpret mode on the CPU."""
    prior = paddle.get_flags(["pallas_interpret"])
    paddle.set_flags({"pallas_interpret": True})
    yield
    paddle.set_flags(prior)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("chunk", [8, 12])
def test_llama_fused_loss_and_grads_match_reference(interpret, chunk, tied):
    """``fused_ce_chunk > 0``: ``(loss, None)``, loss and every grad equal
    to the JAX model's with its weights, the LM head's or (tied) the
    embedding's."""
    kw = dict(fused_ce_chunk=chunk, tie_word_embeddings=tied)
    paddle.seed(40)
    jm = JaxLlama(jax_llama_tiny(**kw))
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    ids = np.random.default_rng(41).integers(1, 256, (2, SEQ)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[0, :3] = -100
    jloss, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    assert logits is None and jlogits is None
    np.testing.assert_allclose(_f32(loss), _f32(jloss.numpy()), **LOSS)
    jgrads = dict(jm.named_parameters())
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(jgrads)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_f32(p.grad), _f32(jgrads[name].grad.numpy()), **GRAD,
                                   err_msg=name)


def test_llama_parallel_refuses_fused_chunk():
    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    try:
        dist.fleet.init(is_collective=True, strategy=strategy, devices=["cpu"] * 2)
        with pytest.raises(ValueError, match="fused_ce_chunk"):
            LlamaForCausalLMHybrid(llama_tiny(fused_ce_chunk=4),
                                   dist.get_hybrid_communicate_group())
    finally:
        topology.set_hybrid_communicate_group(None)
        jtopo.set_hybrid_communicate_group(None)
