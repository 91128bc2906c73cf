"""``jit.to_static``, ``jit.save`` and ``jit.load`` of the port (ROADMAP
A3d) against the JAX package's on the same numpy inputs and weights (carried
across by ``convert.load_numpy_state_dict``): the reference's ``TestJit``
and ``TestJitSaveLoad`` cases (``tests/test_amp_io_jit.py``), then
``llama_tiny`` and ``ernie_tiny`` saved with a dynamic batch and sequence,
loaded, and run at two shapes of the one program, against the JAX
package's ``jit.save`` → ``jit.load`` (static shapes: its Pallas kernels in
interpret mode take no symbolic dimension) and both eager forwards; the
kernels' operators in the saved graph with the flags on and not with a flag
off; each operator's fake against its plain version (``opcheck``); and the
files across the packages.  Tolerances are ``tests/op_test.py``'s rows.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import ernie as jernie
from paddle_tpu.models import llama_tiny as jax_llama_tiny

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.framework.io import load as torch_io_load
from paddle_tpu_torch.models import LlamaForCausalLM, ernie, llama_tiny
from paddle_tpu_torch.ops import custom_ops
from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
from paddle_tpu_torch.ops.fused_ln_swiglu import add_layer_norm_plain, swiglu_plain
from paddle_tpu_torch.ops.fused_norm import rms_norm_plain
from paddle_tpu_torch.ops.rope import rope_plain

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)    # tests/op_test.py, float32
ATTN = dict(rtol=1e-4, atol=1e-5)   # attention reductions (test_torch_train.py)
KERNEL_OPS = {"paddle_tpu_torch.rms_norm.default", "paddle_tpu_torch.rope.default",
              "paddle_tpu_torch.flash_attention.default"}


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _carry(jm, tm):
    """The JAX model's weights into the port's."""
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return tm


def _mlp_pair(widths=(8, 16, 4), act="ReLU", seed=0):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(widths[0], widths[1]), getattr(jnn, act)(),
                        jnn.Linear(widths[1], widths[2]))
    tm = tnn.Sequential(tnn.Linear(widths[0], widths[1]), getattr(tnn, act)(),
                        tnn.Linear(widths[1], widths[2]))
    return jm, _carry(jm, tm)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.numpy())


def _targets(program):
    return {str(n.target) for n in program.graph.nodes if n.op == "call_function"}


_GLOBAL_BN = None
_GLOBAL_JBN = None


class TestJit:
    def test_to_static_discovers_global_layer(self):
        global _GLOBAL_BN, _GLOBAL_JBN
        _GLOBAL_BN, _GLOBAL_JBN = tnn.BatchNorm2D(4), jnn.BatchNorm2D(4)
        x = _x((2, 4, 8, 8), 5)
        st = jit.to_static(lambda v: _GLOBAL_BN(v))
        jst = paddle.jit.to_static(lambda v: _GLOBAL_JBN(v))
        assert st._discover_layers() == [_GLOBAL_BN]
        for _ in range(2):   # the second call reuses the cache entry
            out, want = st(torch.from_numpy(x)), jst(paddle.to_tensor(x))
        assert len(st._cache) == 1
        np.testing.assert_allclose(_np(out), _np(want), **F32)
        np.testing.assert_allclose(_np(_GLOBAL_BN._mean), _np(_GLOBAL_JBN._mean), **F32)
        assert not np.allclose(_np(_GLOBAL_BN._mean), 0.0)
        _GLOBAL_BN = _GLOBAL_JBN = None

    def test_to_static_matches_eager(self):
        jm, tm = _mlp_pair((4, 8, 2), "Tanh")
        x = _x((3, 4), 0)
        st = jit.to_static(lambda v: tm(v))
        got = st(torch.from_numpy(x))
        assert torch.equal(got, tm(torch.from_numpy(x)))
        want = paddle.jit.to_static(lambda v: jm(v))(paddle.to_tensor(x))
        np.testing.assert_allclose(_np(got), _np(want), **F32)

    def test_to_static_backward(self):
        lin = tnn.Linear(3, 2)
        st = jit.to_static(lin)
        assert st is lin and isinstance(lin.forward, jit.StaticFunction)
        x = torch.ones(4, 3, requires_grad=True)
        st(x).sum().backward()
        np.testing.assert_allclose(lin.weight.grad.numpy(), np.full((3, 2), 4.0), rtol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.tile(lin.weight.sum(1).detach().numpy(),
                                                           (4, 1)), **F32)

    def test_to_static_buffer_update(self):
        bn, jbn = tnn.BatchNorm1D(2), jnn.BatchNorm1D(2)
        x = _x((8, 2), 0) + 5.0
        jit.to_static(lambda v: bn(v))(torch.from_numpy(x))
        paddle.jit.to_static(lambda v: jbn(v))(paddle.to_tensor(x))
        assert bn._mean.numpy().mean() > 0.1
        np.testing.assert_allclose(_np(bn._mean), _np(jbn._mean), **F32)
        np.testing.assert_allclose(_np(bn._variance), _np(jbn._variance), **F32)

    def test_cache_keys_and_bound(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_MAX", "2")
        lin = tnn.Linear(4, 2)
        st = jit.to_static(lambda v, scale=1.0: lin(v) * scale)
        for rows in (1, 2, 1, 3):
            st(torch.ones(rows, 4))
        st(torch.ones(3, 4), scale=2.0)     # a static leaf is part of the key
        assert len(st._cache) == 2 and st._cache.evictions == 2

    def test_not_to_static_and_ignore_module(self):
        def f(x):
            return x
        assert jit.not_to_static(f) is f and f._not_to_static
        assert jit.ignore_module([torch]) is None


class TestJitSaveLoad:
    def test_roundtrip_matches_reference(self, tmp_path):
        jm, tm = _mlp_pair()
        x = _x((2, 8), 0)
        path, jpath = str(tmp_path / "model"), str(tmp_path / "jmodel")
        jit.save(tm, path, input_spec=[jit.InputSpec([2, 8], "float32")])
        paddle.jit.save(jm, jpath, input_spec=[paddle.jit.InputSpec([2, 8], "float32")])
        assert os.path.exists(path + ".pdmodel") and os.path.exists(path + ".pdiparams")
        loaded = jit.load(path)
        got = loaded(torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), _np(tm(torch.from_numpy(x))), rtol=1e-6)
        np.testing.assert_allclose(_np(got), _np(paddle.jit.load(jpath)(paddle.to_tensor(x))),
                                   **F32)
        assert set(loaded.state_dict()) == set(tm.state_dict())
        assert loaded.device == torch.device("cpu") and not loaded.training

    def test_export_freezes_params(self, tmp_path):
        net = tnn.Linear(4, 4)
        x = torch.ones(1, 4)
        ref = net(x).detach()
        path = str(tmp_path / "frozen")
        jit.save(net, path, input_spec=[jit.InputSpec([1, 4])])
        with torch.no_grad():
            net.weight.zero_()
        np.testing.assert_allclose(_np(jit.load(path)(x)), _np(ref), rtol=1e-6)

    def test_save_restores_training_flag_and_dropout_off(self, tmp_path):
        net = tnn.Sequential(tnn.Linear(8, 8), tnn.Dropout(0.9))
        net.train()
        path = str(tmp_path / "dp")
        jit.save(net, path, input_spec=[jit.InputSpec([4, 8])])
        assert net.training
        loaded = jit.load(path)
        x = torch.from_numpy(_x((4, 8), 1))
        a, b = loaded(x), loaded(x)
        assert torch.equal(a, b) and float(a.abs().sum()) > 0
        net.eval()
        np.testing.assert_allclose(_np(a), _np(net(x)), rtol=1e-6)

    def test_params_only_save(self, tmp_path):
        net = tnn.Linear(4, 2)
        path = str(tmp_path / "ponly")
        jit.save(net, path)
        assert os.path.exists(path + ".pdiparams") and not os.path.exists(path + ".pdmodel")
        sd = jit.load(path)
        assert set(sd) == set(net.state_dict())
        for k, v in net.state_dict().items():
            assert torch.equal(sd[k], v)

    def test_dynamic_batch_export(self, tmp_path):
        jm, tm = _mlp_pair((8, 16, 4))
        path, jpath = str(tmp_path / "dyn"), str(tmp_path / "jdyn")
        jit.save(tm, path, input_spec=[jit.InputSpec([-1, 8])])
        paddle.jit.save(jm, jpath, input_spec=[paddle.jit.InputSpec([-1, 8])])
        loaded, jloaded = jit.load(path), paddle.jit.load(jpath)
        for bs in (1, 5, 16):
            x = _x((bs, 8), bs)
            got = loaded(torch.from_numpy(x))
            np.testing.assert_allclose(_np(got), _np(tm(torch.from_numpy(x))),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(_np(got), _np(jloaded(paddle.to_tensor(x))), **F32)

    def test_load_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            jit.load(str(tmp_path / "nope"))

    def test_save_plain_fn_without_spec_raises(self, tmp_path):
        with pytest.raises(ValueError, match="requires input_spec"):
            jit.save(lambda x: x, str(tmp_path / "fn"))

    def test_save_plain_fn_with_spec(self, tmp_path):
        path = str(tmp_path / "fn")
        jit.save(lambda x: torch.tanh(x) * 2, path, input_spec=[jit.InputSpec([None, 3])])
        x = torch.from_numpy(_x((4, 3), 2))
        assert torch.equal(jit.load(path)(x), torch.tanh(x) * 2)


# ---------------------------------------------------------------------------
# the models: one dynamic program against the JAX package at two shapes
# ---------------------------------------------------------------------------
SHAPES = ((2, 16), (3, 24))


def _ids(shape, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _llama_pair():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(num_hidden_layers=2))
    jm.eval()
    tm = _carry(jm, LlamaForCausalLM(llama_tiny(num_hidden_layers=2), device="cpu")).eval()
    return jm, tm


def _ernie_pair():
    paddle.seed(0)
    jm = jernie.ErnieForSequenceClassification(jernie.ernie_tiny(hidden_dropout_prob=0.0), 3)
    jm.eval()
    tm = ernie.ErnieForSequenceClassification(ernie.ernie_tiny(hidden_dropout_prob=0.0), 3,
                                              device="cpu").eval()
    return jm, _carry(jm, tm)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


@pytest.mark.parametrize("kind", ["llama", "ernie"])
def test_model_program_matches_reference(kind, tmp_path):
    """A dynamic batch and sequence in one saved program, run at two
    shapes: equal to the port's eager forward, and within the attention
    row of the JAX package's eager forward and of its saved program."""
    jm, tm = _llama_pair() if kind == "llama" else _ernie_pair()
    n_in = 1 if kind == "llama" else 2
    spec_dims = [None, None] if kind == "llama" else [None, "seq"]
    path = str(tmp_path / kind)
    jit.save(tm, path, input_spec=[jit.InputSpec(spec_dims, "int32")] * n_in)
    loaded = jit.load(path)
    assert KERNEL_OPS & _targets(loaded._program) == (
        KERNEL_OPS if kind == "llama" else {"paddle_tpu_torch.flash_attention.default"})
    for i, shape in enumerate(SHAPES):
        arrays = [_ids(shape, 10 + i)] + ([_ids(shape, 20 + i, 2)] if n_in == 2 else [])
        got = _first(loaded(*[torch.from_numpy(a) for a in arrays]))
        with torch.no_grad():
            eager = _first(tm(*[torch.from_numpy(a) for a in arrays]))
        np.testing.assert_allclose(_np(got), _np(eager), **F32)
        jargs = [paddle.to_tensor(a) for a in arrays]
        np.testing.assert_allclose(_np(got), _np(_first(jm(*jargs))), **ATTN)
        jpath = str(tmp_path / f"j{kind}{i}")
        paddle.jit.save(jm, jpath, input_spec=[paddle.jit.InputSpec(list(shape), "int32")] * n_in)
        np.testing.assert_allclose(_np(got), _np(_first(paddle.jit.load(jpath)(*jargs))),
                                   **ATTN)


def test_flag_off_traces_the_plain_version(tmp_path):
    _, tm = _llama_pair()
    path = str(tmp_path / "off")
    with ptt.flag_guard(use_fused_rms_norm=False, use_flash_attention=False):
        jit.save(tm, path, input_spec=[jit.InputSpec([None, None], "int32")])
    targets = _targets(jit.load(path)._program)
    assert KERNEL_OPS & targets == {"paddle_tpu_torch.rope.default"}


def test_fused_flags_trace_their_operators(tmp_path):
    """B4 and B11 are registered too: a model whose forward reaches them
    with the flag on holds their operators."""
    from paddle_tpu_torch.incubate.nn import functional as IF

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(8))
            self.b = torch.nn.Parameter(torch.zeros(8))

        def forward(self, x, r):
            out, pre = IF.fused_layer_norm(x, self.w, self.b, residual=r)
            return tnn.functional.swiglu(out, pre)

    block = Block()
    path = str(tmp_path / "fused")
    with ptt.flag_guard(use_fused_layernorm=True, use_fused_swiglu=True):
        jit.save(block, path, input_spec=[jit.InputSpec([None, 8])] * 2)
        x, r = torch.from_numpy(_x((3, 8), 0)), torch.from_numpy(_x((3, 8), 1))
        eager = block(x, r)
    loaded = jit.load(path)
    assert {"paddle_tpu_torch.add_layer_norm.default",
            "paddle_tpu_torch.swiglu.default"} <= _targets(loaded._program)
    np.testing.assert_allclose(_np(loaded(x, r)), _np(eager), **F32)


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6).contiguous()
    return {
        "rms_norm": ((r(2, 5, 16), r(16), 1e-6), lambda x, w, e: rms_norm_plain(x, w, e)),
        "rope": ((r(2, 6, 4, 8), r(2, 6, 2, 8), r(10, 8), r(10, 8), pos), rope_plain),
        "flash_attention": ((r(2, 6, 4, 8, dtype=torch.bfloat16),
                             r(2, 6, 2, 8, dtype=torch.bfloat16),
                             r(2, 6, 2, 8, dtype=torch.bfloat16), True, None),
                            flash_attention_plain),
        "swiglu": ((r(3, 16), r(3, 16)), swiglu_plain),
        "add_layer_norm": ((r(3, 16, dtype=torch.bfloat16), r(3, 16, dtype=torch.bfloat16),
                            r(16), r(16), 1e-5), add_layer_norm_plain),
    }


@pytest.mark.parametrize("name", sorted(custom_ops.OPS))
def test_operator_fake_matches_plain(name):
    """Each operator's fake gives the plain version's shapes and dtypes,
    and its CPU body is the plain version."""
    args, plain = _op_cases()[name]
    op = custom_ops.op(name)
    got, want = op(*args), plain(*args)
    got, want = (got if isinstance(got, tuple) else (got,)), \
        (want if isinstance(want, tuple) else (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
    if hasattr(torch.library, "opcheck"):
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


def test_pdiparams_cross_and_pdmodel_refused(tmp_path):
    """``.pdiparams`` crosses both ways (``framework.io``'s format); a
    ``.pdmodel`` of the other package raises, naming what it found."""
    jm, tm = _mlp_pair()
    path, jpath = str(tmp_path / "port"), str(tmp_path / "ref")
    jit.save(tm, path, input_spec=[jit.InputSpec([2, 8])])
    paddle.jit.save(jm, jpath, input_spec=[paddle.jit.InputSpec([2, 8])])
    from_ref = torch_io_load(jpath + ".pdiparams")
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(from_ref[k].numpy(), np.asarray(v.numpy()))
    # the reference unpickles the port's tensor payloads as they are: their
    # arrays hold the values
    from_port = paddle.load(path + ".pdiparams")
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(from_port[k].array, v.detach().numpy())
    with pytest.raises(ValueError, match="not a torch.export archive"):
        jit.load(jpath)
    with pytest.raises(Exception):
        paddle.jit.load(path)
