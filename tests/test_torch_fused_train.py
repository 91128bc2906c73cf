"""The port's training with the fused flags on, against the JAX package, on
the CPU: fused SwiGLU (B4) and AdamW (B5) on Llama, the residual-add +
LayerNorm (B11, B11b) and AdamW on GPT.

Each plain twin in ``paddle_tpu_torch/ops/fused_ln_swiglu.py`` (the
kernels' stand-ins on CPU tensors) is held against the Pallas kernel it
replaces, run in interpret mode, and against ``jax.vjp`` of it.  The
slices (``llama_tiny`` with ``use_fused_swiglu`` and ``use_fused_adamw``;
``gpt_tiny(hidden_size=128, intermediate_size=256)`` with
``use_fused_layernorm`` and ``use_fused_adamw``) are held against the JAX
package with ``pallas_interpret`` on.  The JAX wrappers send shapes that
do not tile (h % 128, rows % 8, ``fused_adamw_supported``) to jnp without
a word, so each slice test counts the calls that reach the JAX kernels.
Inputs and weights are numpy arrays from a seed, in f32.

Tolerances: ``tests/op_test.py``'s float32 row (rtol 2e-5, atol 1e-6) for
SwiGLU and the LayerNorm forward; its bfloat16 row (rtol 2e-2, atol 2e-2)
for bf16 inputs; for the LayerNorm backward the f32 row with atol 1e-5 on
dw and db (sums over 96 rows, in another order); AdamW within rtol 1e-6,
atol 1e-7 (``tests/test_pallas_kernels.py``'s AdamW check) against the
kernel, the f32 row against the jnp update (another order); slices as
``tests/test_torch_train.py``: losses rtol 1e-4, grads rtol 1e-4 / atol
1e-6, logits rtol 1e-4 / atol 1e-5, O2 losses rtol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.topology import (get_hybrid_communicate_group,
                                             set_hybrid_communicate_group)
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import fused_ln_swiglu as jax_fused

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.incubate.nn.functional import fused_layer_norm
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM, gpt_tiny,
                                     llama_tiny)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Dropout, LayerNorm, Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import LAUNCHES
from paddle_tpu_torch.ops.fused_ln_swiglu import (
    AddLayerNormFunction, SwiGLUFunction, adamw_plain, adamw_scalars,
    add_layer_norm_bwd_plain, add_layer_norm_plain, fused_adamw,
    fused_add_layer_norm, fused_add_layer_norm_bwd, fused_swiglu, fused_swiglu_bwd,
    swiglu_bwd_plain, swiglu_plain)
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
LN_DWDB = dict(rtol=2e-5, atol=1e-5)
ADAMW = dict(rtol=1e-6, atol=1e-7)
LOSS = dict(rtol=1e-4, atol=0)
GRAD = dict(rtol=1e-4, atol=1e-6)
LOGITS = dict(rtol=1e-4, atol=1e-5)
SEQ = 16
GPT_KW = dict(hidden_size=128, intermediate_size=256)   # h % 128: JAX takes its kernels
LLAMA_FLAGS = dict(use_fused_swiglu=True, use_fused_adamw=True)
GPT_FLAGS = dict(use_fused_layernorm=True, use_fused_adamw=True)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    got = got.detach().float() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _t(*arrays):
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


def _bf16(a):
    """A numpy f32 array rounded to bf16, as a JAX and a torch array."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _fused_flags(flags):
    """A fixture: the JAX package's Pallas kernels in interpret mode, with
    ``flags`` on in both packages, and no hybrid mesh left live by an
    earlier test of the process (one would route the JAX package's kernels
    through its shard_map wrappers instead of the functions counted)."""
    @pytest.fixture
    def fixture():
        prior = paddle.get_flags(["pallas_interpret"] + list(flags))
        hcg = get_hybrid_communicate_group()
        set_hybrid_communicate_group(None)
        paddle.set_flags({"pallas_interpret": True, **flags})
        try:
            with ptt.flag_guard(**flags):
                yield
        finally:
            paddle.set_flags(prior)
            set_hybrid_communicate_group(hcg)
    return fixture


llama_fused = _fused_flags(LLAMA_FLAGS)
gpt_fused = _fused_flags(GPT_FLAGS)


@pytest.fixture
def jax_calls(monkeypatch):
    """Counts of the calls that reach the JAX package's fused kernels (they
    are imported inside the functions that call them, so patching the
    module attribute reaches every caller)."""
    counts = {"fused_swiglu": 0, "fused_adamw": 0, "fused_add_layer_norm": 0}
    for name in counts:
        real = getattr(jax_fused, name)

        def counted(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(jax_fused, name, counted)
    return counts


# ---------------------------------------------------------------------------
# B4: SwiGLU
# ---------------------------------------------------------------------------
class TestSwiGLU:
    def test_plain_matches_pallas_and_its_vjp(self):
        g, u, dy = _np(0, 2, 8, 256), _np(1, 2, 8, 256), _np(2, 2, 8, 256)
        want, vjp = jax.vjp(lambda a, b: jax_fused.fused_swiglu(a, b, True),
                            jnp.asarray(g), jnp.asarray(u))
        jdg, jdu = vjp(jnp.asarray(dy))
        tg, tu, tdy = _t(g, u, dy)
        for out in (swiglu_plain(tg, tu), fused_swiglu(tg, tu)):
            _close(out, want, F32)
        for dg, du in (swiglu_bwd_plain(tg, tu, tdy), fused_swiglu_bwd(tg, tu, tdy)):
            _close(dg, jdg, F32)
            _close(du, jdu, F32)

    def test_bf16_outputs_in_gate_dtype(self):
        g, u, dy = _np(3, 16, 256), _np(4, 16, 256), _np(5, 16, 256)
        (jg, tg), (ju, tu), (jdy, tdy) = _bf16(g), _bf16(u), _bf16(dy)
        want, vjp = jax.vjp(lambda a, b: jax_fused.fused_swiglu(a, b, True), jg, ju)
        jdg, jdu = vjp(jdy)
        out = swiglu_plain(tg, tu)
        dg, du = swiglu_bwd_plain(tg, tu, tdy)
        assert out.dtype == dg.dtype == du.dtype == torch.bfloat16
        for got, w in ((out, want), (dg, jdg), (du, jdu)):
            _close(got, np.asarray(w.astype(jnp.float32)), BF16)

    def test_function_grads_equal_autograd_of_composite(self):
        g, u = (torch.from_numpy(_np(6 + i, 3, 5, 24)).requires_grad_() for i in range(2))
        dy = torch.from_numpy(_np(8, 3, 5, 24))
        before = dict(LAUNCHES)
        got = torch.autograd.grad(SwiGLUFunction.apply(g, u), (g, u), dy)
        assert LAUNCHES == before
        want = torch.autograd.grad(torch.nn.functional.silu(g) * u, (g, u), dy)
        for a, b in zip(got, want):
            _close(a, b.numpy(), F32)

    def test_functional_forms(self):
        x, y = _t(_np(9, 4, 32), _np(10, 4, 32))
        plain = torch.nn.functional.silu(x) * y
        torch.testing.assert_close(F.swiglu(x, y), plain)
        with ptt.flag_guard(use_fused_swiglu=True):
            torch.testing.assert_close(F.swiglu(x, y), plain, **F32)
        xy = torch.cat([x, y], -1)
        torch.testing.assert_close(F.swiglu(xy), plain)
        _close(F.swiglu(xy), JF.swiglu(paddle.to_tensor(xy.numpy())).numpy(), F32)


# ---------------------------------------------------------------------------
# B5: AdamW
# ---------------------------------------------------------------------------
def _adam_inputs(seed, *shape):
    return (_np(seed, *shape), 0.1 * _np(seed + 1, *shape), 0.01 * _np(seed + 2, *shape),
            np.abs(0.01 * _np(seed + 3, *shape)))


class TestAdamW:
    @pytest.mark.parametrize("t", [1, 7])
    @pytest.mark.parametrize("decay", [True, False])
    def test_matches_pallas(self, t, decay):
        p, g, m, v = _adam_inputs(20, 256, 128)
        want = jax_fused.fused_adamw(*(jnp.asarray(a) for a in (p, g, m, v)), 1e-3, t,
                                     0.9, 0.999, 1e-8, 0.01, decay, interpret=True)
        tp, tg, tm, tv = _t(p, g, m, v)
        lr, bc1, bc2 = adamw_scalars(1e-3, t, 0.9, 0.999)
        plain = adamw_plain(tp, tg, tm, tv, lr, bc1, bc2, 0.9, 0.999, 1e-8, 0.01, decay)
        got = fused_adamw(tp, tg, tm, tv, 1e-3, t, 0.9, 0.999, 1e-8, 0.01, decay)
        assert got[0] is tp and got[1] is tm and got[2] is tv   # in place
        for a, b, w in zip(plain, got, want):
            _close(a, w, ADAMW)
            _close(b, w, ADAMW)

    def test_off_size_matches_the_jax_jnp_update(self):
        """1000 elements: ``fused_adamw_supported`` refuses them, so the JAX
        optimizer runs its jnp chain; the port's kernel takes every size.
        The chain multiplies in another order (lr·m̂ / (√v̂ + ε), the bias
        corrections rounded from doubles), so the f32 row holds it."""
        assert not jax_fused.fused_adamw_supported(1000)
        p0, g, _, _ = _adam_inputs(30, 1000)
        jp = paddle.to_tensor(p0, stop_gradient=False)
        jopt = paddle.optimizer.AdamW(1e-2, parameters=[jp], weight_decay=0.1)
        tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        topt = AdamW(1e-2, parameters=[tp], weight_decay=0.1)
        for i in range(3):
            gi = g * (i + 1)
            (jp * paddle.to_tensor(gi)).sum().backward()
            jopt.step()
            jopt.clear_grad()
            with ptt.flag_guard(use_fused_adamw=True):
                (tp * torch.from_numpy(gi)).sum().backward()
                topt.step()
                topt.clear_grad()
        _close(tp, jp.numpy(), F32)

    @pytest.mark.parametrize("name", ["Adam", "AdamW"])
    def test_optimizer_matches_the_flag_off_update_in_place(self, name):
        """Adam couples its L2 decay into the gradient and runs the kernel
        without decay; AdamW decays only what ``apply_decay_param_fun`` lets
        through.  The fused one keeps writing into the same moment tensors.
        Three steps of lr 0.1 match the flag-off update within lr·1e-4 a
        step: the fused update takes 1 − β2^t in f32 from f32(β2), as the
        TPU wrapper does, 1.3e-5 relative from the flag-off path's double
        at t = 1, which moves an Adam update by up to 6.5e-6 of lr."""
        kw = dict(weight_decay=0.1) if name == "Adam" else \
            dict(weight_decay=0.5, apply_decay_param_fun=lambda n: n == "w")
        runs = []
        for flag in (False, True):
            w, b = (torch.nn.Parameter(torch.from_numpy(_np(40 + i, 5, 3))) for i in range(2))
            opt = getattr(ptt.optimizer, name)(0.1, parameters=[("w", w), ("b", b)], **kw)
            moments = []
            for i in range(3):
                with ptt.flag_guard(use_fused_adamw=flag):
                    (w * torch.from_numpy(_np(50 + i, 5, 3)) + b.square()).sum().backward()
                    opt.step()
                    opt.clear_grad()
                moments.append(opt._accumulators[id(w)]["moment1"])
            if flag:
                assert moments[0] is moments[1] is moments[2]
            runs.append((w.detach().clone(), b.detach().clone()))
        for a, c in zip(*runs):
            torch.testing.assert_close(a, c, rtol=0, atol=3 * 0.1 * 1e-4)


# ---------------------------------------------------------------------------
# B11 / B11b: residual add + LayerNorm
# ---------------------------------------------------------------------------
def _ln_inputs(seed, *shape):
    h = shape[-1]
    return (_np(seed, *shape), _np(seed + 1, *shape), 1 + 0.1 * _np(seed + 2, h),
            0.1 * _np(seed + 3, h))


def _jax_add_ln(x, r, w, b, dy, dpre):
    out, vjp = jax.vjp(lambda *a: jax_fused.fused_add_layer_norm(*a, 1e-5, True),
                       x, r, w, b)
    return out, vjp((dy, dpre))


class TestAddLayerNorm:
    def test_plain_matches_pallas_and_its_vjp(self):
        x, r, w, b = _ln_inputs(60, 4, 24, 256)
        dy, dpre = _np(64, 4, 24, 256), _np(65, 4, 24, 256)
        (jo, js), (jdx, jdr, jdw, jdb) = _jax_add_ln(
            *(jnp.asarray(a) for a in (x, r, w, b, dy, dpre)))
        np.testing.assert_array_equal(np.asarray(jdx), np.asarray(jdr))
        tx, tr, tw, tb, tdy, tdp = _t(x, r, w, b, dy, dpre)
        for out, s, mu, rstd in (add_layer_norm_plain(tx, tr, tw, tb),
                                 fused_add_layer_norm(tx, tr, tw, tb)):
            _close(out, jo, F32)
            _close(s, js, F32)
            for dx, dw, db in (add_layer_norm_bwd_plain(s, tw, mu, rstd, tdy, tdp),
                               fused_add_layer_norm_bwd(s, tw, mu, rstd, tdy, tdp)):
                _close(dx, jdx, F32)
                _close(dw, jdw, LN_DWDB)
                _close(db, jdb, LN_DWDB)

    @pytest.mark.parametrize("dpre", [False, True], ids=["no_dpre", "dpre"])
    @pytest.mark.parametrize("x_dtype,w_dtype", [("float32", "float32"),
                                                 ("float32", "bfloat16"),
                                                 ("bfloat16", "float32"),
                                                 ("bfloat16", "bfloat16")])
    @pytest.mark.parametrize("n", [1, 3, 64])
    @pytest.mark.parametrize("h", [1000, 1001, 256])
    def test_off_sizes_match_pallas_vjp(self, h, n, x_dtype, w_dtype, dpre):
        """The sizes the card's B11b takes as special cases (h not a
        multiple of 8, fewer rows than its persistent grid), both dtypes of
        x and w, with the residual's cotangent and without it (zero on the
        JAX side, None here).  bf16 values go to both sides rounded alike;
        each output at the row of its dtype."""
        x, r, w, b = _ln_inputs(100, n, h)
        dy, dp = _np(104, n, h), (_np(105, n, h) if dpre else np.zeros((n, h), np.float32))
        jx, jr, jdy, jdp = (jnp.asarray(a).astype(x_dtype) for a in (x, r, dy, dp))
        jw, jb = (jnp.asarray(a).astype(w_dtype) for a in (w, b))
        (jo, js), (jdx, _, jdw, jdb) = _jax_add_ln(jx, jr, jw, jb, jdy, jdp)
        tx, tr, tdy, tdp = (torch.from_numpy(a).to(getattr(torch, x_dtype))
                            for a in (x, r, dy, dp))
        tw, tb = (torch.from_numpy(a).to(getattr(torch, w_dtype)) for a in (w, b))
        out, s, mu, rstd = add_layer_norm_plain(tx, tr, tw, tb)
        dx, dw, db = fused_add_layer_norm_bwd(s, tw, mu, rstd, tdy, tdp if dpre else None)
        assert dx.dtype == tx.dtype and dw.dtype == db.dtype == tw.dtype
        x_tol = F32 if x_dtype == "float32" else BF16
        w_tol = LN_DWDB if w_dtype == "float32" else BF16
        for got, want, tol in ((out, jo, x_tol), (s, js, x_tol), (dx, jdx, x_tol),
                               (dw, jdw, w_tol), (db, jdb, w_tol)):
            _close(got, np.asarray(want.astype(jnp.float32)), tol)

    def test_bf16_x_with_f32_weight(self):
        """AMP O2's case: x and the residual bf16, w and b f32.  x^ comes
        from the stored bf16 sum, as ``_ln_bwd_kernel`` takes it."""
        x, r, w, b = _ln_inputs(70, 2, 8, 128)
        dy, dpre = _np(74, 2, 8, 128), _np(75, 2, 8, 128)
        (jx, tx), (jr, tr), (jdy, tdy), (jdp, tdp) = (_bf16(a) for a in (x, r, dy, dpre))
        (jo, js), (jdx, _, jdw, jdb) = _jax_add_ln(jx, jr, jnp.asarray(w), jnp.asarray(b),
                                                   jdy, jdp)
        tw, tb = _t(w, b)
        out, s, mu, rstd = add_layer_norm_plain(tx, tr, tw, tb)
        dx, dw, db = add_layer_norm_bwd_plain(s, tw, mu, rstd, tdy, tdp)
        assert out.dtype == s.dtype == dx.dtype == torch.bfloat16
        assert dw.dtype == db.dtype == torch.float32
        for got, want in ((out, jo), (s, js), (dx, jdx)):
            _close(got, np.asarray(want.astype(jnp.float32)), BF16)
        _close(dw, jdw, LN_DWDB)
        _close(db, jdb, LN_DWDB)

    @pytest.mark.parametrize("use_sum", [True, False])
    def test_function_grads_equal_autograd_of_composite(self, use_sum):
        """With the sum unused its cotangent is None (the kernel's dpre
        pointer is then NULL)."""
        x, r, w, b = (torch.from_numpy(a).requires_grad_() for a in _ln_inputs(80, 3, 7, 32))
        dy, dpre = _t(_np(84, 3, 7, 32), _np(85, 3, 7, 32))

        def loss(out, s):
            return (out * dy).sum() + ((s * dpre).sum() if use_sum else 0.0)

        before = dict(LAUNCHES)
        got = torch.autograd.grad(loss(*AddLayerNormFunction.apply(x, r, w, b, 1e-5)),
                                  (x, r, w, b))
        assert LAUNCHES == before
        s = x + r
        want = torch.autograd.grad(loss(F.layer_norm(s, 32, w, b, 1e-5), s), (x, r, w, b))
        for a, c in zip(got, want):
            _close(a, c.numpy(), LN_DWDB)

    def test_fused_layer_norm_dispatch(self):
        x, r, w, b = _t(*_ln_inputs(90, 2, 4, 64))
        plain_out, plain_pre = fused_layer_norm(x, w, b, 1e-5, residual=r)
        torch.testing.assert_close(plain_pre, x + r)
        with ptt.flag_guard(use_fused_layernorm=True):
            out, pre = fused_layer_norm(x, w, b, 1e-5, residual=r)
            assert isinstance(fused_layer_norm(x, w, b, 1e-5), torch.Tensor)
        torch.testing.assert_close(out, plain_out, **F32)
        torch.testing.assert_close(pre, plain_pre, **F32)
        want = JF.layer_norm(paddle.to_tensor((x + r).numpy()), [64],
                             paddle.to_tensor(w.numpy()), paddle.to_tensor(b.numpy()))
        _close(out, want.numpy(), F32)


# ---------------------------------------------------------------------------
# the functional layer and the layers GPT adds
# ---------------------------------------------------------------------------
class TestFunctionalAndLayers:
    def test_layer_norm_and_gelu_match_jax(self):
        x, w, b = _np(100, 3, 8, 48), 1 + _np(101, 48), _np(102, 48)
        want = JF.layer_norm(paddle.to_tensor(x), 48, paddle.to_tensor(w), paddle.to_tensor(b))
        _close(F.layer_norm(*_t(x), 48, *_t(w, b)), want.numpy(), F32)
        jx, tx = _bf16(x)
        got = F.layer_norm(tx, 48, *_t(w, b))
        assert got.dtype == torch.bfloat16
        want = JF.layer_norm(paddle.to_tensor(jx), 48, paddle.to_tensor(w), paddle.to_tensor(b))
        _close(got, np.asarray(want._value.astype(jnp.float32)), BF16)
        for approx in (False, True):
            _close(F.gelu(*_t(x), approximate=approx),
                   JF.gelu(paddle.to_tensor(x), approximate=approx).numpy(), F32)

    def test_linear_bias_and_layer_defaults(self):
        lin = Linear(4, 3, device="cpu")
        assert lin.bias is not None and not lin.bias.any()
        assert Linear(4, 3, bias_attr=False, device="cpu").bias is None
        x = torch.from_numpy(_np(103, 2, 4))
        with torch.no_grad():
            lin.bias.fill_(0.5)
        torch.testing.assert_close(lin(x), x @ lin.weight + 0.5)
        ln = LayerNorm(6, device="cpu")
        assert ln.weight.eq(1).all() and ln.bias.eq(0).all()

    def test_dropout_identity_and_refusals(self):
        x = torch.from_numpy(_np(104, 4, 5))
        assert F.dropout(x, 0.0) is x and F.dropout(x, 0.5, training=False) is x
        torch.testing.assert_close(F.dropout(x, 0.25, training=False,
                                             mode="downscale_in_infer"), x * 0.75)
        drop = Dropout(0.1)
        assert drop.eval()(x) is x
        with pytest.raises(NotImplementedError, match="Philox"):
            drop.train()(x)
        with pytest.raises(NotImplementedError, match="Philox"):
            F.dropout(x, 0.1)
        q = torch.zeros(1, 4, 2, 8)
        with pytest.raises(NotImplementedError, match="Philox"):
            F.scaled_dot_product_attention(q, q, q, dropout_p=0.1, is_causal=True)
        F.scaled_dot_product_attention(q, q, q, dropout_p=0.1, training=False)

    def test_gpt_with_dropout_raises_in_training_only(self):
        tm = GPTForCausalLM(gpt_tiny(dropout=0.1), device="cpu")
        ids = torch.from_numpy(_ids(105, (1, 8)))
        with pytest.raises(NotImplementedError, match="Philox"):
            tm(ids)
        with torch.no_grad():
            assert tm.eval()(ids).shape == (1, 8, 256)


# ---------------------------------------------------------------------------
# the slices
# ---------------------------------------------------------------------------
def _ids(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(np.int32)


def _batch(seed, b=2, s=SEQ):
    ids = _ids(seed, (b, s))
    return ids, np.roll(ids, -1, axis=1)


def _numpy_state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _llama_pair(seed, **kw):
    paddle.seed(seed)
    jm = JaxLlama(jax_llama_tiny(**kw))
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    load_numpy_state_dict(tm, _numpy_state(jm))
    return jm, tm


def _gpt_pair(seed, **kw):
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny(**GPT_KW, **kw))
    tm = GPTForCausalLM(gpt_tiny(**GPT_KW, **kw), device="cpu")
    load_numpy_state_dict(tm, _numpy_state(jm))
    return jm, tm


def _grads_match(jm, tm, ids, labels):
    jloss, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    _close(loss, jloss.numpy(), LOSS)
    _close(logits, jlogits.numpy(), LOGITS)
    jparams = dict(jm.named_parameters())
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(jparams)
    for name, p in tm.named_parameters():
        _close(p.grad, jparams[name].grad.numpy(), GRAD)


def _jax_train(jm, batches, amp=False):
    opt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters(),
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    if amp:
        jm, opt = paddle.amp.decorate(jm, opt, level="O2", dtype="bfloat16")
    step = paddle.jit.TrainStep(jm, lambda m, x, y: m(x, labels=y)[0], opt)
    return jm, [float(step(paddle.to_tensor(x), paddle.to_tensor(y))) for x, y in batches]


def _torch_train(tm, batches, amp=False):
    opt = AdamW(1e-3, parameters=tm.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    if amp:
        tm, opt = ptt.amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    step = TrainStep(tm, lambda m, x, y: m(x, labels=y)[0], opt)
    return tm, opt, [float(step(x, y)) for x, y in batches]


def _trajectories_match(jm, tm, batches):
    """Losses within rtol 1e-4; parameters as ``tests/test_torch_train.py``
    holds them (Adam's first step may move a near-zero-gradient component
    by ±lr, so within 2·lr·steps absolute and 99% within rtol 1e-3).  The
    key third of GPT's qkv bias is left out of the 99%: softmax ignores a
    constant added to a row of scores, so its gradient is zero but for
    rounding, and Adam moves it by that rounding's sign."""
    jm, jl = _jax_train(jm, batches)
    tm, opt, tl = _torch_train(tm, batches)
    np.testing.assert_allclose(tl, jl, **LOSS)
    assert tl[-1] < tl[0] and opt._step_count == len(batches)
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        got, want = p.detach().numpy(), jparams[name].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * 1e-3 * len(batches))
        if name.endswith("qkv_proj.bias"):
            third = got.shape[0] // 3
            got, want = np.delete(got, np.s_[third:2 * third]), \
                np.delete(want, np.s_[third:2 * third])
        assert np.isclose(got, want, rtol=1e-3, atol=1e-5).mean() >= 0.99, name


class TestLlamaFusedSlice:
    def test_loss_and_every_grad_match_jax(self, llama_fused, jax_calls):
        jm, tm = _llama_pair(110)
        _grads_match(jm, tm, *_batch(111))
        assert jax_calls["fused_swiglu"] == llama_tiny().num_hidden_layers

    def test_five_steps_follow_jax(self, llama_fused, jax_calls):
        jm, tm = _llama_pair(120)
        _trajectories_match(jm, tm, [_batch(121)] * 5)
        assert jax_calls["fused_swiglu"] > 0 and jax_calls["fused_adamw"] > 0


class TestGPTSlice:
    def test_state_dict_crosses_by_name(self):
        paddle.seed(130)
        names = set(JaxGPT(jax_gpt_tiny(**GPT_KW)).state_dict())
        assert {"gpt.wte.weight", "gpt.wpe.weight", "gpt.h.0.qkv_proj.weight",
                "gpt.h.0.qkv_proj.bias", "gpt.h.1.ln_2.bias", "gpt.ln_f.weight"} <= names
        assert not any("lm_head" in n for n in names)
        assert names == set(GPTForCausalLM(gpt_tiny(**GPT_KW), device="cpu").state_dict())

    def test_loss_and_every_grad_match_jax(self, gpt_fused, jax_calls):
        jm, tm = _gpt_pair(131)
        _grads_match(jm, tm, *_batch(132))
        assert jax_calls["fused_add_layer_norm"] == gpt_tiny().num_hidden_layers

    def test_five_steps_follow_jax(self, gpt_fused, jax_calls):
        jm, tm = _gpt_pair(140)
        _trajectories_match(jm, tm, [_batch(141)] * 5)
        assert jax_calls["fused_add_layer_norm"] > 0 and jax_calls["fused_adamw"] > 0

    def test_amp_o2_follows_jax_and_keeps_layer_norm_f32(self, gpt_fused, jax_calls):
        jm, tm = _gpt_pair(150)
        batches = [_batch(151 + i) for i in range(3)]
        jm, jl = _jax_train(jm, batches, amp=True)
        tm, opt, tl = _torch_train(tm, batches, amp=True)
        jdt = {n: str(p.dtype) for n, p in jm.named_parameters()}
        tdt = {n: str(p.dtype).replace("torch.", "") for n, p in tm.named_parameters()}
        assert tdt == jdt
        assert {tdt[n] for n in tdt if ".ln_" in n} == {"float32"}
        assert {tdt[n] for n in tdt if ".ln_" not in n} == {"bfloat16"}
        assert not any(id(p) in opt._master_weights for n, p in tm.named_parameters()
                       if ".ln_" in n)
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
        assert all(np.isfinite(tl)) and jax_calls["fused_add_layer_norm"] > 0

    def test_recompute_gives_the_same_grads(self):
        jm = _gpt_pair(155)[0]
        ids, labels = _batch(156)
        grads = []
        for flag in (False, True):
            tm = GPTForCausalLM(gpt_tiny(**GPT_KW, recompute=flag), device="cpu")
            load_numpy_state_dict(tm, _numpy_state(jm))
            with ptt.flag_guard(**GPT_FLAGS):
                tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))[0].backward()
            grads.append({n: p.grad for n, p in tm.named_parameters()})
        for name, g in grads[0].items():
            torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)

    def test_flags_off_match_jax(self):
        jm, tm = _gpt_pair(160)
        _grads_match(jm, tm, *_batch(161))

    def test_greedy_generate_is_token_exact(self):
        jm, tm = _gpt_pair(170)
        jm.eval()
        tm.eval()
        ids = _ids(171, (2, 9))
        jout, jscores = jm.generate(paddle.to_tensor(ids), max_new_tokens=6)
        out, scores = tm.generate(ids, max_new_tokens=6)
        np.testing.assert_array_equal(out.numpy(), jout.numpy())
        np.testing.assert_allclose(scores.numpy(), jscores.numpy(), rtol=0, atol=1e-5)


class TestBindings:
    def test_ctypes_signatures_match_the_sources(self):
        """Every ``_build.launch`` of the port's wrappers names argtypes that
        match its C prototype in ``ops/csrc`` one for one (the stream,
        appended by ``launch``, is the prototype's last parameter).  The
        CPU runs no kernel, so this is where a miscounted argument shows
        before the card."""
        import ctypes
        import importlib
        import re

        from paddle_tpu_torch.ops import _build

        ctype = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
                 "int": ctypes.c_int, "float": ctypes.c_float}
        seen = 0
        for path in sorted(_build.CSRC.parent.glob("*.py")):
            mod = importlib.import_module(f"paddle_tpu_torch.ops.{path.stem}")
            for src, sym, types in re.findall(
                    r'_build\.launch\(\s*"(\w+)",\s*"(\w+)",\s*(\w+)', path.read_text()):
                text = (_build.CSRC / f"{src}.cu").read_text()
                proto = re.search(rf'extern "C" int {sym}\(([^)]*)\)', text)
                params = [re.sub(r"\b(const|\w+)$", "", p.strip()).replace("const ", "")
                          .replace(" *", "*").strip() for p in proto.group(1).split(",")]
                assert [ctype[p] for p in params] == [*getattr(mod, types), ctypes.c_void_p], sym
                seen += 1
        assert seen >= 14
