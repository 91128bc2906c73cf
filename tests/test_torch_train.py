"""The port's Llama training slice against the JAX package, on the CPU.

Each plain backward beside a hand-written Hopper kernel
(``paddle_tpu_torch/ops``) is held against ``jax.vjp`` of the Pallas kernel
it replaces, run in interpret mode.  The whole slice (``llama_tiny`` loss
and gradients, ``TrainStep`` with ``AdamW`` and ``ClipGradByGlobalNorm``,
AMP O2, gradient merge) is held against the JAX package with
``pallas_interpret`` on, so the JAX side runs its Pallas forward and
backward kernels; the port on CPU tensors runs the plain twins through the
same autograd Functions the card runs its kernels through.  Inputs and
weights are numpy arrays from a seed, in f32.

Tolerances: ``tests/op_test.py``'s float32 row (rtol 2e-5, atol 1e-6) for
RMSNorm and RoPE, its bfloat16 row (rtol 2e-2, atol 2e-2) for bf16 RMSNorm
inputs, atol 1e-5 for an f32 dw summed over 64 rows (in another order, as
``test_torch_fused_train.py``'s LayerNorm dw); rtol 1e-4 / atol 1e-5 for attention (the sums over keys
run in another order); losses within rtol 1e-4 and gradients within rtol
1e-4 / atol 1e-6 at f32 (a forward and a backward through two layers, a
softmax over the vocabulary and reductions in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.models.llama import _rope_tables as jax_rope_tables
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import fused_rope as jax_rope
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from paddle_tpu.ops.pallas.fused_norm import fused_rms_norm as jax_rms

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed.fleet_utils import recompute
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import LAUNCHES
from paddle_tpu_torch.ops.flash_attention import (FlashAttentionFunction,
                                                  flash_attention_bwd,
                                                  flash_attention_bwd_plain,
                                                  flash_attention_plain)
from paddle_tpu_torch.ops.fused_norm import (RMSNormFunction, fused_rms_norm_bwd,
                                             rms_norm_bwd_plain, rms_norm_plain)
from paddle_tpu_torch.ops.rope import RopeFunction, fused_rope_bwd, rope_plain
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as torch_lr

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
ROW_SUM = dict(rtol=2e-5, atol=1e-5)   # f32 dw summed over 64 rows in another order
ATTN = dict(rtol=1e-4, atol=1e-5)
ATTN_BWD = dict(rtol=1e-4, atol=1e-4)  # chip_smoke.py's float32_attn_bwd row
LOSS = dict(rtol=1e-4, atol=0)
GRAD = dict(rtol=1e-4, atol=1e-6)
SEQ = 16     # a multiple of the 8-row Pallas blocks, so JAX takes its flash kernel


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture
def interpret():
    """The JAX package's Pallas kernels in interpret mode on the CPU."""
    prior = paddle.get_flags(["pallas_interpret"])
    paddle.set_flags({"pallas_interpret": True})
    yield
    paddle.set_flags(prior)


# ---------------------------------------------------------------------------
# the plain backward twins against jax.vjp of the Pallas kernels
# ---------------------------------------------------------------------------
class TestRMSNormBackward:
    @pytest.mark.parametrize("shape", [(16, 128), (2, 8, 64)])
    def test_plain_matches_pallas_vjp(self, shape):
        x, w, dy = _np(0, *shape), 1 + 0.1 * _np(1, shape[-1]), _np(2, *shape)
        _, vjp = jax.vjp(lambda a, b: jax_rms(a, b, 1e-5, True), jnp.asarray(x),
                         jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(dy))
        tx, tw = torch.from_numpy(x), torch.from_numpy(w)
        _, rstd = rms_norm_plain(tx, tw, 1e-5)
        for dx, dw in (rms_norm_bwd_plain(tx, tw, rstd, torch.from_numpy(dy)),
                       fused_rms_norm_bwd(tx, tw, rstd, torch.from_numpy(dy))):
            _close(dx, jdx, F32)
            _close(dw, jdw, F32)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n", [1, 3, 64])
    @pytest.mark.parametrize("h", [1000, 1001, 256])
    def test_off_sizes_match_pallas_vjp(self, h, n, dtype):
        """The sizes the card's B1b takes as special cases: h not a
        multiple of 8, fewer rows than its persistent grid.  bf16 inputs
        go to both sides rounded alike, at the bfloat16 row."""
        x, w, dy = _np(20, n, h), 1 + 0.1 * _np(21, h), _np(22, n, h)
        jx, jw, jdy = (jnp.asarray(a).astype(dtype) for a in (x, w, dy))
        _, vjp = jax.vjp(lambda a, b: jax_rms(a, b, 1e-5, True), jx, jw)
        jdx, jdw = vjp(jdy)
        tx, tw, tdy = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w, dy))
        _, rstd = rms_norm_plain(tx, tw, 1e-5)
        dx, dw = fused_rms_norm_bwd(tx, tw, rstd, tdy)
        assert dx.dtype == dw.dtype == tx.dtype
        f32 = dtype == "float32"
        _close(dx.float(), np.asarray(jdx.astype(jnp.float32)), F32 if f32 else BF16)
        _close(dw.float(), np.asarray(jdw.astype(jnp.float32)), ROW_SUM if f32 else BF16)

    def test_function_on_cpu_runs_the_plain_pair(self):
        x = torch.from_numpy(_np(3, 4, 32)).requires_grad_()
        w = torch.from_numpy(1 + _np(4, 32)).requires_grad_()
        before = dict(LAUNCHES)
        RMSNormFunction.apply(x, w, 1e-6).square().sum().backward()
        assert LAUNCHES == before
        xr, wr = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
        rms_norm_plain(xr, wr, 1e-6)[0].square().sum().backward()
        _close(x.grad, xr.grad.numpy(), F32)
        _close(w.grad, wr.grad.numpy(), F32)


class TestRopeBackward:
    @pytest.mark.parametrize("hq,hk", [(4, 4), (4, 2)])
    def test_plain_matches_pallas_vjp(self, hq, hk):
        b, s, d = 2, 16, 16
        q, k = _np(5, b, s, hq, d), _np(6, b, s, hk, d)
        gq, gk = _np(7, b, s, hq, d), _np(8, b, s, hk, d)
        cos, sin = jax_rope_tables(d, 64, 10000.0)
        _, vjp = jax.vjp(lambda a, c: tuple(jax_rope(a, c, cos[:s], sin[:s], True)),
                         jnp.asarray(q), jnp.asarray(k))
        jdq, jdk = vjp((jnp.asarray(gq), jnp.asarray(gk)))
        tc, ts = _rope_tables(d, 64, 10000.0)
        pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
        dq, dk = fused_rope_bwd(torch.from_numpy(gq), torch.from_numpy(gk), tc, ts, pos)
        _close(dq, jdq, F32)
        _close(dk, jdk, F32)

    def test_backward_is_the_rotation_by_minus_theta(self):
        """R(θ)ᵀ = R(−θ): rotating forward then back is the identity."""
        q = torch.from_numpy(_np(9, 1, 8, 2, 16))
        tc, ts = _rope_tables(16, 32, 10000.0)
        pos = torch.arange(8, dtype=torch.int32)[None]
        fq, _ = rope_plain(q, q, tc, ts, pos)
        bq, _ = rope_plain(fq, fq, tc, ts, pos, sin_sign=-1.0)
        torch.testing.assert_close(bq, q, **F32)

    def test_function_gradients_match_autograd(self):
        q = torch.from_numpy(_np(10, 2, 8, 4, 16)).requires_grad_()
        k = torch.from_numpy(_np(11, 2, 8, 2, 16)).requires_grad_()
        tc, ts = _rope_tables(16, 32, 10000.0)
        pos = torch.arange(8, dtype=torch.int32)[None].expand(2, 8)
        oq, ok = RopeFunction.apply(q, k, tc, ts, pos)
        (oq.square().sum() + ok.sum()).backward()
        qr, kr = (t.detach().clone().requires_grad_() for t in (q, k))
        pq, pk = rope_plain(qr, kr, tc, ts, pos)
        (pq.square().sum() + pk.sum()).backward()
        _close(q.grad, qr.grad.numpy(), F32)
        _close(k.grad, kr.grad.numpy(), F32)


class TestFlashBackward:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
    def test_plain_matches_pallas_vjp(self, causal, hq, hkv):
        """More than one tile (s 64, blocks 16) and GQA (hq 4, hkv 2)."""
        b, s, d = 2, 64, 16
        q, k, v = _np(12, b, s, hq, d), _np(13, b, s, hkv, d), _np(14, b, s, hkv, d)
        do = _np(15, b, s, hq, d)
        _, vjp = jax.vjp(lambda a, c, e: jax_flash(a, c, e, None, causal, 16, 16, True),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        out, lse = flash_attention_plain(tq, tk, tv, causal)
        for got in (flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(do), causal),
                    flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(do), causal)):
            for g, w in zip(got, want):
                _close(g, w, ATTN)

    # the head dims the card's d 256 kernels take (160 padded to 256), with
    # GQA 4:1 at d 256; tiles of 16 rows over s 64 as above
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("hq,hkv,d", [(4, 2, 160), (4, 4, 256), (8, 2, 256)])
    def test_plain_matches_pallas_vjp_wide_heads(self, causal, hq, hkv, d):
        b, s = 1, 64
        q, k, v = _np(16, b, s, hq, d), _np(17, b, s, hkv, d), _np(18, b, s, hkv, d)
        do = _np(19, b, s, hq, d)
        _, vjp = jax.vjp(lambda a, c, e: jax_flash(a, c, e, None, causal, 16, 16, True),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        out, lse = flash_attention_plain(tq, tk, tv, causal)
        for got in (flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(do), causal),
                    flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(do), causal)):
            for g, w in zip(got, want):
                _close(g, w, ATTN)

    # the d 256 dQ kernel's edges: sq < sk (the causal diagonal offset by
    # sk - sq), GQA 8:1, d 160 padded to 256 and d 256; tiles of 16 rows
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("d", [160, 256])
    def test_plain_matches_pallas_vjp_wide_heads_sq_lt_sk(self, causal, d):
        b, sq, sk, hq, hkv = 1, 32, 64, 8, 1
        q, k, v = _np(44, b, sq, hq, d), _np(45, b, sk, hkv, d), _np(46, b, sk, hkv, d)
        do = _np(47, b, sq, hq, d)
        _, vjp = jax.vjp(lambda a, c, e: jax_flash(a, c, e, None, causal, 16, 16, True),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
        out, lse = flash_attention_plain(tq, tk, tv, causal)
        for got in (flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal),
                    flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal)):
            for g, w in zip(got, want):
                _close(g, w, ATTN)

    # b, sq, sk, hq, hkv, d, causal: d 8 causal GQA, d 64 not causal, d 128
    # causal with sq < sk, d 256
    @pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
        (2, 64, 64, 4, 2, 8, True), (1, 64, 64, 2, 2, 64, False),
        (1, 32, 64, 2, 1, 128, True), (1, 32, 32, 2, 2, 256, True)])
    def test_3xtf32_products_match_pallas_vjp(self, b, sq, sk, hq, hkv, d, causal):
        """The f32 kernels' arithmetic (csrc/mma_tf32.cuh): the backward's
        five products (S, dP, dQ, dK, dV) each as three TF32 products, over
        the plain twin's math, within the f32 backward tolerance of the
        Pallas kernel's vjp."""
        q, k, v = _np(40, b, sq, hq, d), _np(41, b, sk, hkv, d), _np(42, b, sk, hkv, d)
        do = _np(43, b, sq, hq, d)
        _, vjp = jax.vjp(lambda a, c, e: jax_flash(a, c, e, None, causal, 16, 16, True),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
        out, lse = flash_attention_plain(tq, tk, tv, causal)
        got = _bwd_3xtf32(tq, tk, tv, out, lse, tdo, causal)
        for g, w in zip(got, want):
            _close(g, w, ATTN_BWD)

    def test_tf32_split_rounds_hi_to_nearest_and_truncates_lo(self):
        """hi: to nearest, ties away from zero (cvt.rna); lo: the tensor
        core's read of the rest, its 13 low bits dropped."""
        x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                          1 + 2 ** -10 + 2 ** -12 + 2 ** -22 + 2 ** -23])
        hi, lo = _split_tf32(x)
        assert hi.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10]
        assert lo.tolist() == [-2 ** -11, 2 ** -11, 2 ** -11 - 2 ** -22, 2 ** -12 + 2 ** -22]
        assert torch.equal(hi + (x - hi), x)

    def test_function_gradients_match_autograd_of_reference(self):
        from paddle_tpu_torch.ops.attention import sdpa_reference

        q, k, v = (torch.from_numpy(_np(16 + i, 1, 24, h, 16)).requires_grad_()
                   for i, h in enumerate((4, 2, 2)))
        do = torch.from_numpy(_np(19, 1, 24, 4, 16))
        got = torch.autograd.grad(FlashAttentionFunction.apply(q, k, v, True), (q, k, v), do)
        want = torch.autograd.grad(sdpa_reference(q, k, v, is_causal=True), (q, k, v), do)
        for g, w in zip(got, want):
            _close(g, w.numpy(), ATTN)


def _tf32_bits(x, add):
    """x's f32 bits plus ``add``, the 13 bits below TF32's mantissa cleared."""
    return ((x.contiguous().view(torch.int32) + add) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """x = hi + lo as the f32 kernels split an operand: hi by cvt.rna
    (half a TF32 ulp added to the magnitude, then truncated), lo = x - hi
    as the tensor core reads it (truncated toward zero)."""
    hi = _tf32_bits(x, 0x1000)
    return hi, _tf32_bits(x - hi, 0)


def _mm_3xtf32(eq, a, b):
    """einsum(eq, a, b) with each f32 product as three TF32 products,
    lo_a hi_b + hi_a lo_b + hi_a hi_b, summed in f32."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def _bwd_3xtf32(q, k, v, out, lse, dout, causal):
    """flash_attention_bwd_plain's f32 math with its five products by
    _mm_3xtf32."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / np.sqrt(d)
    kf, vf = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    s = _mm_3xtf32("bqhd,bkhd->bhqk", q, kf) * scale
    keep = (lse != float("-inf"))[..., None].expand(b, hq, sq, sk)
    if causal:
        keep = keep & (torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + (sk - sq))
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    delta = (dout * out).sum(-1).transpose(1, 2)
    ds = p * (_mm_3xtf32("bqhd,bkhd->bhqk", dout, vf) - delta[..., None]) * scale
    dq = _mm_3xtf32("bhqk,bkhd->bqhd", ds, kf)
    dk = _mm_3xtf32("bhqk,bqhd->bkhd", ds, q).reshape(b, sk, hkv, rep, d).sum(3)
    dv = _mm_3xtf32("bhqk,bqhd->bkhd", p, dout).reshape(b, sk, hkv, rep, d).sum(3)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the functional layer and the training pieces
# ---------------------------------------------------------------------------
class TestCrossEntropy:
    @pytest.mark.parametrize("kw", [dict(), dict(reduction="sum"), dict(reduction="none"),
                                    dict(label_smoothing=0.1), dict(ignore_index=3)])
    def test_matches_jax(self, kw):
        logits = _np(20, 12, 10)
        label = np.random.default_rng(21).integers(0, 10, 12).astype(np.int64)
        label[[2, 7]] = kw.get("ignore_index", -100)
        want = JF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(label), **kw)
        got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label), **kw)
        _close(got, want.numpy(), F32)

    def test_all_ignored_mean_is_zero_and_soft_labels_raise(self):
        """All-ignored labels give a zero mean; soft labels and class
        weights, which raised before the loss layers were ported, now give
        the reference's values (tests/test_torch_layers.py holds them over
        every reduction)."""
        got = F.cross_entropy(torch.zeros(3, 4), torch.full((3,), -100))
        assert float(got) == 0.0
        rng = np.random.default_rng(7)
        x = rng.standard_normal((3, 4)).astype(np.float32)
        soft = rng.dirichlet(np.ones(4), 3).astype(np.float32)
        hard, w = np.array([0, 3, -100]), np.array([0.5, 1.0, 2.0, 1.5], np.float32)
        pairs = [(F.cross_entropy(torch.from_numpy(x), torch.from_numpy(soft), soft_label=True),
                  JF.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(soft),
                                   soft_label=True)),
                 (F.cross_entropy(torch.from_numpy(x), torch.from_numpy(hard),
                                  weight=torch.from_numpy(w)),
                  JF.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(hard),
                                   weight=paddle.to_tensor(w)))]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=1e-6)


class TestSchedulersAndClip:
    def test_schedulers_match_jax(self):
        jax_lr = paddle.optimizer.lr
        pairs = [(jax_lr.CosineAnnealingDecay(0.1, T_max=5, eta_min=0.01),
                  torch_lr.CosineAnnealingDecay(0.1, T_max=5, eta_min=0.01)),
                 (jax_lr.LinearWarmup(jax_lr.CosineAnnealingDecay(0.1, 4), 3, 0.0, 0.1),
                  torch_lr.LinearWarmup(torch_lr.CosineAnnealingDecay(0.1, 4), 3, 0.0, 0.1)),
                 (jax_lr.LinearWarmup(0.05, 2, 0.01, 0.05),
                  torch_lr.LinearWarmup(0.05, 2, 0.01, 0.05))]
        for j, t in pairs:
            for _ in range(9):
                assert t() == pytest.approx(j(), rel=1e-12)
                j.step()
                t.step()

    def test_global_norm_clip_matches_jax(self):
        grads = [_np(22, 4, 3), _np(23, 5)]
        jp = [paddle.to_tensor(np.zeros_like(g)) for g in grads]
        want = paddle.nn.ClipGradByGlobalNorm(1.0)(
            [(p, paddle.to_tensor(g)) for p, g in zip(jp, grads)])
        tp = [torch.zeros(g.shape) for g in grads]
        got = ClipGradByGlobalNorm(1.0)([(p, torch.from_numpy(g)) for p, g in zip(tp, grads)])
        for (_, g), (_, w) in zip(got, want):
            _close(g, w.numpy(), F32)
        big = ClipGradByGlobalNorm(1e6)([(tp[0], torch.from_numpy(grads[0]))])
        torch.testing.assert_close(big[0][1], torch.from_numpy(grads[0]))


def _jax_model(seed, **kw):
    paddle.seed(seed)
    return JaxLlama(jax_llama_tiny(**kw))


def _torch_model(jm, **kw):
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return tm


def _batch(seed, b=2, s=SEQ):
    ids = np.random.default_rng(seed).integers(1, 256, (b, s)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


class TestLlamaGradients:
    def test_loss_and_every_grad_match_jax(self, interpret):
        jm = _jax_model(30)
        tm = _torch_model(jm)
        ids, labels = _batch(31)
        jloss, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jloss.backward()
        loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        _close(loss, jloss.numpy(), LOSS)
        _close(logits, jlogits.numpy(), dict(rtol=1e-4, atol=1e-5))
        jgrads = dict(jm.named_parameters())
        names = [n for n, _ in tm.named_parameters()]
        assert sorted(names) == sorted(jgrads)
        for name, p in tm.named_parameters():
            _close(p.grad, jgrads[name].grad.numpy(), GRAD)

    def test_recompute_gives_the_same_grads(self):
        jm = _jax_model(32)
        ids, labels = _batch(33)
        grads = []
        for flag in (False, True):
            tm = _torch_model(jm, recompute=flag)
            tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))[0].backward()
            grads.append({n: p.grad for n, p in tm.named_parameters()})
        for name, g in grads[0].items():
            torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)

    def test_recompute_wraps_checkpoint(self):
        lin = torch.nn.Linear(4, 4)
        x = torch.randn(3, 4, requires_grad=True)
        y = recompute(lin, x)
        y.sum().backward()
        torch.testing.assert_close(x.grad, lin.weight.sum(0).expand(3, 4))


def _jax_train(jm, steps, batches, lr=1e-3, amp=False, merge=None):
    opt = paddle.optimizer.AdamW(lr, parameters=jm.parameters(),
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    if amp:
        jm, opt = paddle.amp.decorate(jm, opt, level="O2", dtype="bfloat16")
    step = paddle.jit.TrainStep(jm, lambda m, x, y: m(x, labels=y)[0], opt,
                                gradient_merge=merge)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for x, y in batches[:steps]]
    return jm, opt, losses


def _torch_train(tm, steps, batches, lr=1e-3, amp=False, merge=None):
    opt = AdamW(lr, parameters=tm.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    if amp:
        tm, opt = ptt.amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    step = TrainStep(tm, lambda m, x, y: m(x, labels=y)[0], opt, gradient_merge=merge)
    losses = [float(step(x, y)) for x, y in batches[:steps]]
    return tm, opt, losses


class TestTrainStep:
    def test_five_steps_follow_jax(self, interpret):
        """Loss by loss within rtol 1e-4.  Final parameters: Adam's first
        step divides each gradient by its own magnitude, so a component
        whose gradient is near zero moves by up to lr whichever its sign,
        and the two packages may disagree on that sign.  So parameters
        are compared within 2·lr·steps absolute (the most two such
        trajectories can part), and at least 99% of the components
        within rtol 1e-3 / atol 1e-5."""
        jm = _jax_model(40)
        tm = _torch_model(jm)
        batches = [_batch(41)] * 5   # one batch: the loss must fall
        jm, _, jl = _jax_train(jm, 5, batches)
        tm, opt, tl = _torch_train(tm, 5, batches)
        np.testing.assert_allclose(tl, jl, **LOSS)
        assert tl[-1] < tl[0] and opt._step_count == 5
        jparams = dict(jm.named_parameters())
        for name, p in tm.named_parameters():
            got, want = p.detach().numpy(), jparams[name].numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * 1e-3 * 5)
            close = np.isclose(got, want, rtol=1e-3, atol=1e-5)
            assert close.mean() >= 0.99, (name, close.mean())

    def test_amp_o2_casts_as_jax_and_follows_its_loss(self, interpret):
        jm = _jax_model(50)
        tm = _torch_model(jm)
        batches = [_batch(51 + i) for i in range(3)]
        jm, _, jl = _jax_train(jm, 3, batches, amp=True)
        tm, opt, tl = _torch_train(tm, 3, batches, amp=True)
        jdt = {n: str(p.dtype) for n, p in jm.named_parameters()}
        tdt = {n: str(p.dtype).replace("torch.", "") for n, p in tm.named_parameters()}
        assert tdt == jdt and set(tdt.values()) == {"bfloat16"}
        for p in tm.parameters():
            assert opt._master_weights[id(p)].dtype == torch.float32
            torch.testing.assert_close(p, opt._master_weights[id(p)].to(p.dtype),
                                       rtol=0, atol=0)
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
        assert all(np.isfinite(tl))

    def test_gradient_merge_matches_jax(self, interpret):
        jm = _jax_model(60)
        tm = _torch_model(jm)
        batches = [_batch(61 + i, b=4) for i in range(3)]
        _, _, jl = _jax_train(jm, 3, batches, merge=2)
        _, opt, tl = _torch_train(tm, 3, batches, merge=2)
        np.testing.assert_allclose(tl, jl, **LOSS)
        assert opt._step_count == 3
        with pytest.raises(ValueError, match="divisible"):
            TrainStep(tm, lambda m, x, y: m(x, labels=y)[0], opt,
                      gradient_merge=3)(*_batch(64, b=4))

    def test_state_dict_slot_names(self):
        jm = _jax_model(70)
        tm = _torch_model(jm)
        _, opt, _ = _torch_train(tm, 1, [_batch(71)], amp=True)
        sd = opt.state_dict()
        assert sd["@step"] == 1
        assert {k.split(".", 1)[1] for k in sd if k.startswith("param_0.")} == \
            {"moment1", "moment2", "@t", "master_weight"}
        fresh = AdamW(1e-3, parameters=tm.parameters(), multi_precision=True)
        fresh.set_state_dict(sd)
        assert fresh._step_count == 1
        torch.testing.assert_close(fresh.state_dict()["param_0.moment2"], sd["param_0.moment2"])

    def test_named_parameters_and_decay_exemption(self):
        w = torch.nn.Parameter(torch.ones(3))
        b = torch.nn.Parameter(torch.ones(3))
        opt = AdamW(0.1, parameters=[("w", w), ("norm.b", b)], weight_decay=0.5,
                    apply_decay_param_fun=lambda n: "norm" not in n)
        (w.sum() + b.sum()).backward()
        opt.step()
        # both get the same Adam step of lr; only w also decays by lr*wd*w
        torch.testing.assert_close(b.detach(), torch.full((3,), 0.9))
        torch.testing.assert_close(w.detach(), torch.full((3,), 0.9 - 0.05))


class TestEagerOptimizer:
    @pytest.mark.parametrize("name,kw", [("Adam", dict(weight_decay=0.1)),
                                         ("AdamW", dict(weight_decay=0.1))])
    def test_eager_steps_match_jax(self, name, kw):
        """Adam (L2 decay coupled into the gradient) and AdamW (decoupled)
        through ``step()`` and ``clear_grad()``, three steps."""
        w0, gs = _np(90, 4, 3), [_np(91 + i, 4, 3) for i in range(3)]
        jp = paddle.to_tensor(w0, stop_gradient=False)
        jopt = getattr(paddle.optimizer, name)(0.01, parameters=[jp], **kw)
        tp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        topt = getattr(ptt.optimizer, name)(0.01, parameters=[tp], **kw)
        for g in gs:
            (jp * paddle.to_tensor(g)).sum().backward()
            jopt.step()
            jopt.clear_grad()
            (tp * torch.from_numpy(g)).sum().backward()
            topt.step()
            topt.clear_grad()
            assert tp.grad is None
        _close(tp, jp.numpy(), F32)

    def test_cross_entropy_takes_trailing_unit_labels(self):
        logits, label = torch.from_numpy(_np(95, 6, 5)), torch.tensor([1, 0, 4, 2, 3, 1])
        torch.testing.assert_close(F.cross_entropy(logits, label[:, None]),
                                   F.cross_entropy(logits, label))


class TestRefusals:
    def test_fused_ce_chunk_raises(self):
        """The chunked fused loss, which raised before it was ported, gives
        ``(loss, None)`` equal to the unfused loss; the hybrid model keeps
        refusing it, as the reference's does (tests/test_torch_fused_ce.py
        holds it against the JAX package)."""
        tm = LlamaForCausalLM(llama_tiny(fused_ce_chunk=8), device="cpu")
        ids, labels = _batch(80)
        loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        tm.config.fused_ce_chunk = 0
        want = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))[0]
        assert logits is None
        torch.testing.assert_close(loss, want, rtol=2e-5, atol=1e-6)

    @pytest.mark.parametrize("arg", ["health_guard", "persistent_cache", "snapshotter"])
    def test_train_step_guards_raise(self, arg):
        """``persistent_cache`` (A10) raises; ``snapshotter`` is taken since
        the checkpoint (A7a) is ported (``tests/test_torch_snapshot.py``
        drives it), and ``health_guard`` since the health layer (A7b) is
        (``tests/test_torch_health.py``)."""
        if arg in ("snapshotter", "health_guard"):
            obj = object()
            step = TrainStep(torch.nn.Linear(2, 2), lambda m, x: m(x).sum(), None,
                             **{arg: obj})
            assert getattr(step, f"_{arg}") is obj
            return
        with pytest.raises(NotImplementedError, match=arg):
            TrainStep(torch.nn.Linear(2, 2), lambda m, x: m(x).sum(), None, **{arg: True})

    def test_train_step_sdc_monitor_raises(self):
        """The SDC monitor (ROADMAP A7b) is ported: attaching it is taken
        (``tests/test_torch_sdc.py`` drives it)."""
        step = TrainStep(torch.nn.Linear(2, 2), lambda m, x: m(x).sum(), None)
        mon = object()
        step.attach_sdc_monitor(mon)
        assert step._sdc_monitor is mon
