"""The port's beam search against the JAX package, on the CPU (the
counterpart of ``test_beam_search.py``).

A JAX ``llama_tiny`` (2 layers, vocab 64, f32) is built from a seed and its
weights cross to the port's model through ``convert.py``.  The port's
``generate(num_beams=K)`` must give the JAX package's ids exactly and its
scores within ``rtol=atol=2e-4``, and the same against a brute-force beam
search that recomputes every prefix with the port's full forward (no
cache), the oracle of ``test_beam_search.py``.  ``beam_search_loop`` is
also held against the JAX loop on step functions built to tie exactly
(lower index first) and to finish early (the early exit and the skipped
last forward leave the result bit-identical).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.generation.beam_search import beam_search_loop as jax_beam_search_loop
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny

from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.generation.beam_search import beam_search_loop
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn.functional import top_k_stable

torch.set_num_threads(1)

TINY = dict(num_hidden_layers=2, vocab_size=64, max_position_embeddings=64)
SCORES = dict(rtol=2e-4, atol=2e-4)
NEG = -1e9


@pytest.fixture(scope="module")
def pair():
    paddle.seed(7)
    jm = JaxLlama(jax_llama_tiny(**TINY))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**TINY), device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _log_softmax(x):
    x = x - x.max()
    return x - np.log(np.exp(x).sum())


def _full_logits(tm, prefix):
    with torch.no_grad():
        out = tm(torch.as_tensor(np.asarray(prefix, np.int64))[None])
    return out.double().numpy()[0, -1]


def brute_beam(tm, prompt, K, max_new, eos, pad, lp=1.0, early_stopping=False, min_new=0):
    """``test_beam_search.py``'s oracle over the port's full forward:
    python loops, every prefix recomputed without a cache, ties broken
    lower flat index first."""
    running = [(0.0, [])] + [(NEG, []) for _ in range(K - 1)]
    bank = []
    done = False
    V = None
    for t in range(max_new):
        if done:
            break
        cands = []
        for k, (cum, toks) in enumerate(running):
            logp = _log_softmax(_full_logits(tm, np.concatenate([prompt, toks])))
            V = logp.shape[0]
            if eos >= 0 and t < min_new:
                logp = logp.copy()
                logp[eos] = NEG
            for v in range(V):
                cands.append((cum + logp[v], k * V + v, k, v))
        cands.sort(key=lambda c: (-c[0], c[1]))
        top = cands[:min(2 * K, K * V)]
        for score, _, k, v in top:
            if v == eos:
                bank.append((score / ((t + 1) ** lp), running[k][1] + [v]))
        bank = sorted(bank, key=lambda h: -h[0])[:K]
        non_eos = [c for c in top if c[3] != eos][:K]
        running = [(c[0], running[c[2]][1] + [c[3]]) for c in non_eos]
        full = len(bank) == K
        if early_stopping:
            done = full
        else:
            done = full and bank[-1][0] >= running[0][0] / ((t + 1) ** lp)
    fill = [(cum / (max_new ** lp), toks) for cum, toks in running if cum > NEG / 2]
    merged = [(s, toks, 1) for s, toks in bank] + [(s, toks, 0) for s, toks in fill]
    merged.sort(key=lambda h: (-h[2], -h[0]))
    out_ids, out_scores = [], []
    for s, toks, _ in merged[:K]:
        out_ids.append(toks + [pad] * (max_new - len(toks)))
        out_scores.append(s)
    return np.asarray(out_ids, np.int32), np.asarray(out_scores)


def _both(pair, ids, mask=None, **kw):
    """The same generate call through both packages: (jax, port) as numpy
    (ids, scores)."""
    jm, tm = pair
    jkw = dict(kw, attention_mask=mask) if mask is not None else kw
    ji, js = jm.generate(paddle.to_tensor(ids), **jkw)
    ti, ts = tm.generate(ids, **jkw)
    return (ji.numpy(), js.numpy()), (ti.numpy(), ts.numpy())


def _prompts(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


@pytest.mark.parametrize("lp,early", [(1.0, False), (1.0, True), (2.0, False), (0.0, True)])
def test_beam4_matches_jax_and_bruteforce(pair, lp, early):
    prompts = _prompts(3, (2, 5))
    K, max_new, eos = 4, 6, 9
    (ji, js), (ti, ts) = _both(pair, prompts, max_new_tokens=max_new, num_beams=K,
                               eos_token_id=eos, pad_token_id=0, length_penalty=lp,
                               early_stopping=early, num_return_sequences=K)
    assert ti.dtype == np.int32 and ti.shape == (2 * K, max_new) and ts.shape == (2 * K,)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **SCORES)
    for bi in range(2):
        want_ids, want_scores = brute_beam(pair[1], prompts[bi], K, max_new, eos, 0, lp=lp,
                                           early_stopping=early)
        np.testing.assert_array_equal(ti.reshape(2, K, max_new)[bi], want_ids)
        np.testing.assert_allclose(ts.reshape(2, K)[bi], want_scores, **SCORES)


def test_beam_min_new_tokens(pair):
    prompt = _prompts(5, (1, 4))
    K, max_new, eos = 3, 5, 9
    (ji, js), (ti, ts) = _both(pair, prompt, max_new_tokens=max_new, num_beams=K,
                               eos_token_id=eos, pad_token_id=0, min_new_tokens=3,
                               num_return_sequences=K)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **SCORES)
    want_ids, _ = brute_beam(pair[1], prompt[0], K, max_new, eos, 0, min_new=3)
    np.testing.assert_array_equal(ti, want_ids)
    for row in ti:   # no hypothesis ends before 3 generated tokens
        eos_pos = np.where(row == eos)[0]
        assert not eos_pos.size or eos_pos[0] >= 2


def test_beam_no_eos_returns_running(pair):
    prompt = _prompts(6, (1, 3))
    (ji, js), (ti, ts) = _both(pair, prompt, max_new_tokens=4, num_beams=2,
                               num_return_sequences=2)
    want_ids, want_scores = brute_beam(pair[1], prompt[0], 2, 4, -1, -1)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti, want_ids)
    np.testing.assert_allclose(ts, js, **SCORES)
    np.testing.assert_allclose(ts, want_scores, **SCORES)


def test_beam_left_padded_rows_match_unpadded(pair):
    """A left-padded batch (pad_lens tiled K-fold) decodes each row as its
    unpadded prompt does, in both packages."""
    prompts = _prompts(10, (2, 7))
    mask = np.ones((2, 7), np.int32)
    mask[0, :3] = 0
    K, max_new, eos = 3, 5, 9
    kw = dict(max_new_tokens=max_new, num_beams=K, eos_token_id=eos, pad_token_id=0,
              num_return_sequences=K)
    (ji, js), (ti, ts) = _both(pair, prompts, mask, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **SCORES)
    solo, solo_scores = pair[1].generate(prompts[:1, 3:], **kw)
    np.testing.assert_array_equal(ti[:K], solo.numpy())
    np.testing.assert_allclose(ts[:K], solo_scores.numpy(), **SCORES)


def test_beam_batch_rows_match_solo(pair):
    prompts = _prompts(8, (3, 6))
    kw = dict(max_new_tokens=5, num_beams=3, eos_token_id=9, pad_token_id=0)
    (ji, _), (ti, _) = _both(pair, prompts, **kw)
    np.testing.assert_array_equal(ti, ji)
    for bi in range(3):
        solo, _ = pair[1].generate(prompts[bi:bi + 1], **kw)
        np.testing.assert_array_equal(ti[bi], solo.numpy()[0])


def test_beam_default_returns_best_only(pair):
    (ji, js), (ti, ts) = _both(pair, _prompts(9, (2, 4)), max_new_tokens=3, num_beams=3,
                               eos_token_id=9, pad_token_id=0)
    assert ti.shape == (2, 3) and ts.shape == (2,)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **SCORES)


def test_beam_arg_validation(pair):
    _, tm = pair
    prompt = np.zeros((1, 3), np.int32)
    with pytest.raises(ValueError, match="do_sample"):
        tm.generate(prompt, max_new_tokens=2, num_beams=2, do_sample=True)
    with pytest.raises(ValueError, match="num_return_sequences"):
        tm.generate(prompt, max_new_tokens=2, num_beams=2, num_return_sequences=3)
    with pytest.raises(ValueError, match="num_return_sequences"):
        tm.generate(prompt, max_new_tokens=2, num_return_sequences=2)
    with pytest.raises(NotImplementedError, match="repetition_penalty"):
        tm.generate(prompt, max_new_tokens=2, num_beams=2, repetition_penalty=1.2)


def test_sampling_num_return_sequences(pair):
    """do_sample + num_return_sequences repeats each row; the copies
    decode to distinct samples, and the same seed draws the same ones."""
    _, tm = pair
    prompt = np.random.default_rng(12).integers(1, 64, (2, 5)).astype(np.int32)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=1.5, num_return_sequences=3,
              seed=7)
    ids, scores = tm.generate(prompt, **kw)
    assert tuple(ids.shape) == (6, 8) and tuple(scores.shape) == (6, 8)
    got = ids.numpy()
    assert not (np.all(got[0] == got[1]) and np.all(got[1] == got[2]))
    np.testing.assert_array_equal(tm.generate(prompt, **kw)[0].numpy(), got)


# ---------------------------------------------------------------------------
# beam_search_loop on step functions built for it
# ---------------------------------------------------------------------------
def _table_step(table, xp):
    """A step function whose logits are ``table[row, token]``: the row id
    rides in the caches (reordered with the beams), so each batch row
    decodes on its own table."""
    def step(tok, caches, offset, pad_lens):
        row = caches[0][0]
        t = tok[:, 0]
        if xp is torch:
            return table[row.long(), t.long()], caches
        return table[row.astype(jnp.int32), t], caches
    return step


def _run_both(table, first, K, max_new, eos, **kw):
    """beam_search_loop through both packages on the same tables; the
    port's step calls are counted.  Returns ((ids, scores) jax, port, calls)."""
    b = first.shape[0]
    rows = np.repeat(np.arange(b, dtype=np.float32), K)
    calls = []
    t_step = _table_step(torch.as_tensor(table), torch)

    def counted(*a):
        calls.append(1)
        return t_step(*a)

    got = beam_search_loop(counted, [(torch.as_tensor(rows),) * 2], torch.as_tensor(first),
                           num_beams=K, max_new=max_new, eos=eos, pad=0, **kw)
    want = jax_beam_search_loop(_table_step(jnp.asarray(table), jnp),
                                [(jnp.asarray(rows),) * 2], jnp.asarray(first),
                                num_beams=K, max_new=max_new, eos=eos, pad=0, **kw)
    return tuple(np.asarray(x) for x in want), tuple(x.numpy() for x in got), len(calls)


def test_top_k_stable_lower_index_first():
    x = torch.tensor([[1.0, 3.0, 3.0, NEG, NEG, 3.0, NEG]])
    vals, idx = top_k_stable(x, 5)
    assert idx.tolist() == [[1, 2, 5, 0, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0, NEG]]


@pytest.mark.parametrize("early", [False, True])
def test_exact_ties_pin_lower_index_first(early):
    """Logits that tie exactly everywhere (two values only, repeated across
    tokens and beams): the port's ids equal the JAX loop's, whose top_k
    takes the lower index first, and the scores are equal."""
    V, K, b = 6, 3, 2
    table = np.tile(np.array([2.0, 1.0, 2.0, 1.0, 2.0, 1.0], np.float32), (b, V, 1))
    first = np.array([[1.0, 2.0, 2.0, 1.0, 2.0, 1.0], [2.0] * V], np.float32)
    (ji, js), (ti, ts), _ = _run_both(table, first, K, 5, eos=3, early_stopping=early)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)


def test_early_exit_and_skipped_last_step_are_bit_identical():
    """Row 0 favours eos and fills its bank at step 1, row 1 never emits
    it.  Alone, row 0 stops after one forward; beside row 1, the loop runs
    max_new - 1 forwards (the last step's is skipped).  Row 0's result is
    bit-identical both ways, and equals the JAX loop's full scan."""
    V, K, T, eos = 8, 2, 6, 0
    rng = np.random.default_rng(4)
    table = rng.standard_normal((2, V, V)).astype(np.float32)
    table[0, :, eos] = 5.0
    table[1, :, eos] = -5.0
    first = table[:, 0].copy()
    (ji, js), (ti, ts), calls = _run_both(table, first, K, T, eos, early_stopping=True)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)
    assert calls == T - 1
    (_, _), (ti0, ts0), calls0 = _run_both(table[:1], first[:1], K, T, eos,
                                           early_stopping=True)
    assert calls0 == 1
    np.testing.assert_array_equal(ti0[0], ti[0])
    assert ts0[0].tobytes() == ts[0].tobytes()
    assert (ti0[0, :, 0] == eos).any()
