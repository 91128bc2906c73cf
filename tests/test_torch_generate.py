"""The port's Llama serving slice against the JAX package, on the CPU.

A JAX ``LlamaForCausalLM`` is built from a seed; its ``state_dict`` crosses
to the port's model through ``paddle_tpu_torch.convert`` as numpy arrays;
the same numpy prompts then go through both.  At f32, logits of a full
forward agree within rtol 1e-4 / atol 1e-5 (the f32 row of
``tests/op_test.py`` loosened for the attention and vocabulary
reductions, which sum in another order), and greedy ``generate`` and
``Predictor.generate_batch`` are token-exact, with scores within 1e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny

from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.models import LlamaForCausalLM, llama_moe_tiny, llama_tiny

torch.set_num_threads(1)

LOGITS = dict(rtol=1e-4, atol=1e-5)
SCORES = dict(rtol=0, atol=1e-5)
CONFIGS = {"tiny": {}, "h128": dict(hidden_size=128, intermediate_size=256)}


def _pair(seed, **kw):
    paddle.seed(seed)
    jm = JaxLlama(jax_llama_tiny(**kw))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    load_numpy_state_dict(tm, _numpy_state(jm))
    return jm, tm


def _numpy_state(jax_model):
    return {k: np.asarray(v.numpy()) for k, v in jax_model.state_dict().items()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return _pair(0, **CONFIGS[request.param])


@pytest.fixture(scope="module")
def tiny():
    return _pair(1)


def _ids(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(np.int32)


def _jax_gen(jm, ids, **kw):
    out, scores = jm.generate(paddle.to_tensor(ids), **kw)
    return out.numpy(), scores.numpy()


def _torch_gen(tm, ids, **kw):
    out, scores = tm.generate(ids, **kw)
    return out.numpy(), scores.numpy()


def _assert_same_generation(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], **SCORES)


class TestForward:
    def test_logits_match(self, pair):
        jm, tm = pair
        ids = _ids(0, (2, 11))
        with torch.no_grad():
            got = tm(torch.as_tensor(ids)).numpy()
        np.testing.assert_allclose(got, jm(paddle.to_tensor(ids)).numpy(), **LOGITS)

    def test_logits_with_keep_mask_match(self, tiny):
        jm, tm = tiny
        ids = _ids(1, (2, 9))
        mask = np.ones((2, 9), np.int32)
        mask[1, :3] = 0
        with torch.no_grad():
            got = tm(torch.as_tensor(ids), attn_mask=torch.as_tensor(mask)).numpy()
        want = jm(paddle.to_tensor(ids), attn_mask=paddle.to_tensor(mask)).numpy()
        np.testing.assert_allclose(got, want, **LOGITS)

    def test_cache_path_matches_full_forward(self, tiny):
        """Prefill plus one decode step through the in-place cache gives the
        logits of the full forward over the longer sequence."""
        _, tm = tiny
        ids = torch.as_tensor(_ids(2, (2, 7))).long()
        with torch.no_grad():
            caches = tm.new_kv_cache(2, 16)
            tm(ids[:, :6], kv_cache=caches, position_offset=0)
            step, _ = tm(ids[:, 6:], kv_cache=caches, position_offset=6)
            full = tm(ids)
        torch.testing.assert_close(step[:, 0], full[:, 6], **LOGITS)


class TestGreedy:
    def test_unpadded_token_exact(self, pair):
        jm, tm = pair
        ids = _ids(3, (2, 11))
        kw = dict(max_new_tokens=8, eos_token_id=5, pad_token_id=0)
        _assert_same_generation(_torch_gen(tm, ids, **kw), _jax_gen(jm, ids, **kw))

    def test_left_padded_token_exact(self, tiny):
        jm, tm = tiny
        ids = _ids(4, (3, 12))
        mask = np.ones((3, 12), np.int32)
        mask[0, :5] = 0
        mask[2, :11] = 0
        kw = dict(max_new_tokens=6, eos_token_id=5, pad_token_id=0,
                  attention_mask=mask)
        _assert_same_generation(_torch_gen(tm, ids, **kw), _jax_gen(jm, ids, **kw))

    def test_bucket_pow2_token_exact(self, tiny):
        jm, tm = tiny
        ids = _ids(5, (2, 5))
        kw = dict(max_new_tokens=5, eos_token_id=5, pad_token_id=0, bucket="pow2")
        _assert_same_generation(_torch_gen(tm, ids, **kw), _jax_gen(jm, ids, **kw))
        unbucketed = _torch_gen(tm, ids, max_new_tokens=5, eos_token_id=5,
                                pad_token_id=0)
        np.testing.assert_array_equal(_torch_gen(tm, ids, **kw)[0], unbucketed[0])

    def test_eos_latch_min_new_and_repetition_penalty_token_exact(self, tiny):
        jm, tm = tiny
        ids = _ids(6, (2, 8))
        free = _torch_gen(tm, ids, max_new_tokens=6)[0]
        eos = int(free[0, 2])  # row 0 emits it third: the latch must engage
        for kw in (dict(eos_token_id=eos, pad_token_id=0),
                   dict(eos_token_id=eos, pad_token_id=0, min_new_tokens=4),
                   dict(eos_token_id=eos, repetition_penalty=1.3)):
            kw["max_new_tokens"] = 6
            _assert_same_generation(_torch_gen(tm, ids, **kw), _jax_gen(jm, ids, **kw))
        latched = _torch_gen(tm, ids, max_new_tokens=6, eos_token_id=eos,
                             pad_token_id=0)
        assert latched[0][0, 2] == eos and (latched[0][0, 3:] == 0).all()
        assert (latched[1][0, 3:] == 0).all()

    def test_against_pallas_interpret(self, tiny):
        """The JAX side through its Pallas kernels in interpret mode (flash
        prefill, decode kernel), as tests/test_decode_attention.py runs it."""
        jm, tm = tiny
        ids = _ids(7, (2, 16))
        kw = dict(max_new_tokens=6, eos_token_id=5, pad_token_id=0)
        prior = paddle.get_flags(["pallas_interpret"])
        paddle.set_flags({"pallas_interpret": True})
        try:
            want = _jax_gen(jm, ids, **kw)
        finally:
            paddle.set_flags(prior)
        _assert_same_generation(_torch_gen(tm, ids, **kw), want)

    def test_generate_batch_token_exact(self, tiny):
        jm, tm = tiny
        rng = np.random.default_rng(8)
        prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (3, 17, 9, 30, 5)]
        kw = dict(max_batch=2, max_new_tokens=5, eos_token_id=5, pad_token_id=0)
        got = Predictor.from_model(tm).generate_batch(prompts, **kw)
        want = JaxPredictor.from_model(jm).generate_batch(prompts, **kw)
        assert len(got) == len(want) == len(prompts)
        for a, b in zip(got, want):
            _assert_same_generation(a, b)

    def test_predictor_generate_returns_numpy(self, tiny):
        _, tm = tiny
        ids, scores = Predictor.from_model(tm).generate(_ids(9, (1, 4)), max_new_tokens=3)
        assert isinstance(ids, np.ndarray) and ids.shape == scores.shape == (1, 3)
        assert ids.dtype == np.int32 and (scores <= 0).all()


class TestSampling:
    def test_deterministic_for_a_seed(self, tiny):
        _, tm = tiny
        ids = _ids(10, (2, 6))
        kw = dict(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=20,
                  top_p=0.9, seed=3)
        a, b = _torch_gen(tm, ids, **kw), _torch_gen(tm, ids, **kw)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert np.isfinite(a[1]).all() and (a[1] <= 0).all()

    @pytest.mark.parametrize("knob", [dict(top_k=1), dict(top_p=1e-6)])
    def test_single_survivor_equals_greedy(self, tiny, knob):
        _, tm = tiny
        ids = _ids(11, (2, 6))
        greedy = _torch_gen(tm, ids, max_new_tokens=6)
        sampled = _torch_gen(tm, ids, max_new_tokens=6, do_sample=True, seed=4, **knob)
        np.testing.assert_array_equal(sampled[0], greedy[0])

    def test_temperature_changes_the_scores(self, tiny):
        """Scores follow the distribution sampled from: a hotter
        temperature flattens it, so the chosen tokens score lower."""
        _, tm = tiny
        ids = _ids(12, (2, 4))
        cold = _torch_gen(tm, ids, max_new_tokens=1, do_sample=True, top_k=1,
                          temperature=0.5)
        hot = _torch_gen(tm, ids, max_new_tokens=1, do_sample=True, top_k=5,
                         temperature=2.0)
        assert (cold[1] == 0).all() and (hot[1] < 0).all()


class TestRefusals:
    def test_beam_search_not_ported(self, tiny):
        """Beam search is ported (test_torch_beam_search.py holds it); of
        its options, only the repetition penalty is refused, as in the
        reference."""
        with pytest.raises(NotImplementedError, match="repetition_penalty with beam"):
            tiny[1].generate(_ids(13, (1, 4)), max_new_tokens=2, num_beams=2,
                             repetition_penalty=1.5)
        ids, scores = tiny[1].generate(_ids(13, (1, 4)), max_new_tokens=2, num_beams=2)
        assert tuple(ids.shape) == (1, 2) and tuple(scores.shape) == (1,)

    def test_moe_and_labels_not_ported(self, tiny):
        """MoE is ported (tests/test_torch_moe_llama.py holds it against
        the reference): ``llama_moe_tiny`` builds on the CPU and gives
        logits of the reference's shape.  The labels path is whole: the
        chunked fused loss (``fused_ce_chunk > 0``) gives ``(loss, None)``
        (tests/test_torch_fused_ce.py holds its values)."""
        moe = LlamaForCausalLM(llama_moe_tiny(), device="cpu")
        assert tuple(moe(torch.ones(2, 5, dtype=torch.long)).shape) == (2, 5, 256)
        loss, logits = LlamaForCausalLM(llama_tiny(fused_ce_chunk=4), device="cpu")(
            torch.ones(1, 2, dtype=torch.long), labels=torch.ones(1, 2, dtype=torch.long))
        assert logits is None and loss.shape == () and torch.isfinite(loss)

    def test_bad_attention_mask(self, tiny):
        with pytest.raises(ValueError, match="LEFT-padded"):
            tiny[1].generate(_ids(14, (1, 4)), max_new_tokens=2,
                             attention_mask=np.asarray([[1, 0, 1, 1]]))


class TestConvert:
    def test_missing_unexpected_and_shape(self, tiny):
        jm, tm = tiny
        arrays = _numpy_state(jm)
        with pytest.raises(KeyError, match="missing"):
            load_numpy_state_dict(tm, {k: v for k, v in arrays.items()
                                       if k != "lm_head.weight"})
        with pytest.raises(KeyError, match="unexpected.*extra"):
            load_numpy_state_dict(tm, dict(arrays, extra=np.zeros(1)))
        bad = dict(arrays)
        bad["llama.norm.weight"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="shape"):
            load_numpy_state_dict(tm, bad)

    def test_rope_buffers_checked_not_loaded(self, tiny):
        jm, tm = tiny
        arrays = _numpy_state(jm)
        tables = {n: np.asarray(b.numpy()) for n, b in jm.named_buffers()}
        load_numpy_state_dict(tm, dict(arrays, **tables))
        tables["llama.rope_cos"] = tables["llama.rope_cos"] + 1.0
        with pytest.raises(ValueError, match="rope_cos"):
            load_numpy_state_dict(tm, dict(arrays, **tables))

    def test_casts_to_the_model_dtype(self, tiny):
        jm, _ = tiny
        tm = LlamaForCausalLM(llama_tiny(), device="cpu", dtype=torch.bfloat16)
        load_numpy_state_dict(tm, _numpy_state(jm))
        w = tm.lm_head.weight
        assert w.dtype == torch.bfloat16
        np.testing.assert_allclose(w.detach().float().numpy(), jm.lm_head.weight.numpy(),
                                   rtol=1e-2, atol=1e-2)
