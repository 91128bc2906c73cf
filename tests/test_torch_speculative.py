"""The port's speculative decoding against the JAX package, on the CPU (the
counterpart of ``test_speculative.py``'s drafter, rejection-sampling,
standalone-loop and engine cases).

A JAX ``llama_tiny`` (2 layers, vocab 96, f32) is built from a seed and its
weights cross to the port's model through ``convert.py``.

- The host-side parts are the reference's numpy code: the drafters'
  proposals, ``AdaptiveK``'s lengths and ``rejection_sample_step``'s draws
  under one seed are equal case by case in both packages.
- ``speculative_generate`` (greedy) is token-exact against the port's
  ``generate`` and against the JAX ``speculative_generate``, with the same
  counts of drafts, acceptances and verify steps, for the n-gram,
  shallow-exit and draft-model drafters.
- ``ServingEngine(speculative=k)`` is token-exact against the serial port
  engine and the JAX engine with speculation, with ``spec_proposed_total``
  and ``spec_accepted_total`` equal to the JAX engine's; every decode
  forward is ``1 + k`` wide.  The reference's
  ``test_token_exact_vs_serial_one_compile`` is red only at its
  ``spec_acceptance > 0`` check (the n-gram drafter finds nothing to accept
  on this random model), so acceptance is held here by the JAX engine's
  counts and by an oracle drafter that proposes the serial stream.

Engine sizes are explicit: ``tests/conftest.py`` pins the serving
environment variables for the whole suite.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.generation import AdaptiveK as JaxAdaptiveK
from paddle_tpu.generation import DraftModelDrafter as JaxDraftModelDrafter
from paddle_tpu.generation import NGramDrafter as JaxNGramDrafter
from paddle_tpu.generation import ShallowExitDrafter as JaxShallowExitDrafter
from paddle_tpu.generation import SpecConfig as JaxSpecConfig
from paddle_tpu.generation import rejection_sample_step as jax_rejection_sample_step
from paddle_tpu.generation import speculative_generate as jax_speculative_generate
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.engine import Request as JaxRequest

from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.generation import (AdaptiveK, DraftModelDrafter, NGramDrafter,
                                         ShallowExitDrafter, SpecConfig,
                                         rejection_sample_step, speculative_generate)
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.serving import ServingEngine, TokenSink
from paddle_tpu_torch.serving.engine import Request

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

TINY = dict(num_hidden_layers=2, vocab_size=96, max_position_embeddings=128)
KW = dict(max_batch=3, page_tokens=8, num_pages=24, max_pages_per_seq=6)
EVICT = dict(max_batch=3, page_tokens=4, num_pages=9, max_pages_per_seq=8)
OFFLOAD_KW = dict(max_batch=2, page_tokens=8, num_pages=9, max_pages_per_seq=8)
STATS = ("proposed", "accepted", "verify_steps", "tokens", "rows", "acceptance_rate",
         "effective_tokens_per_step")


@pytest.fixture(scope="module", autouse=True)
def _restore_request_ids():
    """Both packages number requests from a class counter; restore them, so
    that later tests of the same process that compare rids across the two
    engines see the counters as they left them."""
    saved = JaxRequest._next_rid, Request._next_rid
    yield
    JaxRequest._next_rid, Request._next_rid = saved


@pytest.fixture(scope="module")
def pair():
    paddle.seed(3)
    jm = JaxLlama(jax_llama_tiny(**TINY))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**TINY), device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _solo(tm, prompt, max_new, eos=None):
    ids, _ = tm.generate(np.asarray(prompt)[None], max_new_tokens=max_new, eos_token_id=eos,
                         pad_token_id=0 if eos is not None else None)
    return ids.numpy()[0]


def _mixed_prompts(seed=7):
    rng = np.random.default_rng(seed)
    ps = [rng.integers(1, 96, n).astype(np.int32) for n in (5, 9, 3)]
    ps.append(np.asarray([7, 8, 9, 7, 8, 9, 7, 8], np.int32))  # loopy
    return ps


def _serve(cls, model, prompts, max_new=10, kw=KW, **extra):
    eng = cls(model, **kw, **extra)
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    outs = eng.run()
    eng.pool.check_leaks()
    return eng, [np.asarray(outs[r]) for r in rids]


class StreamOracle:
    """A drafter that knows each prompt's serial greedy stream and proposes
    its next tokens: every draft is accepted."""

    def __init__(self, streams):
        self.streams = streams
        self.probs = None

    def begin(self, context):
        self._ctx = [int(t) for t in context]

    def observe(self, tokens):
        self._ctx.extend(int(t) for t in tokens)

    def propose(self, k, temperature=0.0, rng=None):
        for prompt, stream in self.streams:
            n = len(prompt)
            if self._ctx[:n] == prompt:
                done = len(self._ctx) - n
                return [int(t) for t in stream[done:done + k]]
        return []


class WrongDrafter(StreamOracle):
    """Proposes the last token k times, which the test model's greedy
    stream does not repeat: its drafts are rejected."""

    def __init__(self):
        self.probs = None

    def propose(self, k, temperature=0.0, rng=None):
        return [self._ctx[-1]] * k


def _oracle(tm, prompts, max_new):
    streams = [([int(t) for t in p], list(_solo(tm, p, max_new))) for p in prompts]
    return lambda: StreamOracle(streams)


# ---------------------------------------------------------------------------
# drafters, AdaptiveK, rejection sampling
# ---------------------------------------------------------------------------
class TestDrafters:
    @pytest.mark.parametrize("ctx, observe, k, max_ngram", [
        ([5, 6, 7, 5, 6, 7, 5, 6], [], 3, 3),        # looping continuation
        ([2, 3, 9, 8, 3, 7, 2, 3], [], 2, 3),        # longest suffix wins
        ([1, 2, 3, 4], [], 4, 4),                    # no match
        ([1, 2, 3, 4], [], 0, 4),                    # k = 0
        ([9, 1], [2, 9, 1], 2, 4),                   # observe extends
        ([4], [], 3, 4),                             # too short
        ([1, 1, 1, 1, 1], [], 4, 2),                 # self-overlapping match
    ])
    def test_ngram_matches_reference(self, ctx, observe, k, max_ngram):
        got, want = NGramDrafter(max_ngram), JaxNGramDrafter(max_ngram)
        for dr in (got, want):
            dr.begin(ctx)
            dr.observe(observe)
        assert got.propose(k) == want.propose(k)

    def test_adaptive_k_matches_reference(self):
        rng = np.random.default_rng(0)
        for adaptive, decay in ((True, 0.5), (True, 0.7), (False, 0.7)):
            got, want = AdaptiveK(4, adaptive, decay), JaxAdaptiveK(4, adaptive, decay)
            for _ in range(40):
                proposed = int(rng.integers(0, 5))
                accepted = int(rng.integers(0, proposed + 1))
                got.update(accepted, proposed)
                want.update(accepted, proposed)
                assert got.k() == want.k() and got.ema == want.ema
        ctrl = AdaptiveK(k_max=4, adaptive=True, decay=0.5)
        for _ in range(6):
            ctrl.update(accepted=0, proposed=4)
        assert ctrl.k() == 1
        for _ in range(8):
            ctrl.update(accepted=4, proposed=4)
        assert ctrl.k() == 4

    def test_model_drafters_match_reference(self, pair):
        """The draft-model drafter over the target proposes the target's
        greedy continuation; both model drafters propose what the JAX
        drafters propose, also after observing and across a re-begin."""
        jm, tm = pair
        prompt = [3, 11, 7, 29, 5]
        expect = _solo(tm, np.asarray(prompt, np.int32), 4)
        cases = ((DraftModelDrafter(tm, capacity=32), JaxDraftModelDrafter(jm, capacity=32)),
                 (ShallowExitDrafter(tm, capacity=32, draft_layers=1),
                  JaxShallowExitDrafter(jm, capacity=32, draft_layers=1)))
        for got, want in cases:
            for dr in (got, want):
                dr.begin(prompt)
            assert got.propose(4) == want.propose(4)
            for dr in (got, want):
                dr.observe([9, 17])
            assert got.propose(3) == want.propose(3)
            got.begin(prompt[:3])
            want.begin(prompt[:3])
            assert got.propose(2) == want.propose(2)
        dr = cases[0][0]
        dr.begin(prompt)
        assert dr.propose(4) == [int(t) for t in expect]

    def test_spec_config_matches_reference(self):
        for kw in ({}, dict(k=2, ngram_max=2)):
            got, want = SpecConfig(**kw).make_drafter(), JaxSpecConfig(**kw).make_drafter()
            assert type(got).__name__ == type(want).__name__
            assert got.max_ngram == want.max_ngram
        with pytest.raises(ValueError, match="unknown drafter"):
            SpecConfig(drafter="nope").make_drafter()
        assert isinstance(SpecConfig(drafter=lambda: "made").make_drafter(), str)


class TestRejectionSampling:
    @pytest.mark.parametrize("q_kind", ["none", "dist"])
    def test_same_draws_under_one_seed(self, q_kind):
        """The same (p, q, draft) sequence through both packages, each with
        its own default_rng(seed): identical (accepted, token) pairs."""
        rng = np.random.default_rng(5)
        cases = []
        for _ in range(300):
            p = rng.dirichlet(np.ones(6))
            q = None if q_kind == "none" else rng.dirichlet(np.ones(6))
            cases.append((p, q, int(rng.integers(0, 6))))
        a, b = np.random.default_rng(9), np.random.default_rng(9)
        got = [rejection_sample_step(p, q, d, a) for p, q, d in cases]
        want = [jax_rejection_sample_step(p, q, d, b) for p, q, d in cases]
        assert got == want
        assert {ok for ok, _ in got} == {True, False}

    def test_output_distribution_matches_target(self):
        p = np.array([0.5, 0.3, 0.15, 0.05])
        q = np.array([0.1, 0.2, 0.3, 0.4])
        rng = np.random.default_rng(0)
        counts = np.zeros_like(p)
        for _ in range(20000):
            d = int(rng.choice(4, p=q))
            counts[rejection_sample_step(p, q, d, rng)[1]] += 1
        np.testing.assert_allclose(counts / 20000, p, atol=0.02)

    def test_matching_draft_always_accepted(self):
        ok, tok = rejection_sample_step(np.array([0.0, 1.0, 0.0]), None, 1,
                                        np.random.default_rng(1))
        assert ok and tok == 1


# ---------------------------------------------------------------------------
# speculative_generate
# ---------------------------------------------------------------------------
class TestSpeculativeGenerate:
    @pytest.mark.parametrize("drafter", ["ngram", "shallow", "draft_model"])
    def test_greedy_token_exact_vs_generate_and_reference(self, pair, drafter):
        jm, tm = pair
        cap = 64
        make = {"ngram": lambda m, M: "ngram",
                "shallow": lambda m, M: (lambda: M(m, cap, draft_layers=1)),
                "draft_model": lambda m, M: (lambda: M(m, cap))}[drafter]
        cls = {"ngram": (None, None), "shallow": (ShallowExitDrafter, JaxShallowExitDrafter),
               "draft_model": (DraftModelDrafter, JaxDraftModelDrafter)}[drafter]
        rng = np.random.default_rng(11)
        prompts = [rng.integers(1, 96, 6).astype(np.int32),
                   np.asarray([4, 9, 2, 4, 9, 2, 4, 9], np.int32)]
        for prompt in prompts:
            ids, stats = speculative_generate(tm, prompt[None], max_new_tokens=10,
                                              drafter=make(tm, cls[0]), k=3)
            jids, jstats = jax_speculative_generate(jm, paddle.to_tensor(prompt[None]),
                                                    max_new_tokens=10,
                                                    drafter=make(jm, cls[1]), k=3)
            assert ids.dtype == torch.int32
            np.testing.assert_array_equal(ids.numpy()[0], _solo(tm, prompt, 10))
            np.testing.assert_array_equal(ids.numpy(), jids.numpy())
            assert {k: stats[k] for k in STATS} == {k: jstats[k] for k in STATS}
            assert stats["verify_steps"] >= 1 and stats["effective_tokens_per_step"] > 0

    def test_batch_rows_run_in_turn(self, pair):
        jm, tm = pair
        prompts = np.random.default_rng(2).integers(1, 96, (2, 7)).astype(np.int32)
        ids, stats = speculative_generate(tm, prompts, max_new_tokens=8, k=4)
        jids, jstats = jax_speculative_generate(jm, paddle.to_tensor(prompts),
                                                max_new_tokens=8, k=4)
        np.testing.assert_array_equal(ids.numpy(), jids.numpy())
        np.testing.assert_array_equal(ids.numpy(), tm.generate(prompts, max_new_tokens=8)[0])
        assert stats["rows"] == jstats["rows"]

    def test_oracle_drafter_accepts_everything(self, pair):
        _, tm = pair
        prompt = np.asarray([3, 11, 7, 29, 5, 18], np.int32)
        ids, stats = speculative_generate(tm, prompt[None], max_new_tokens=12,
                                          drafter=lambda: DraftModelDrafter(tm, 64), k=4,
                                          adaptive=False)
        np.testing.assert_array_equal(ids.numpy()[0], _solo(tm, prompt, 12))
        assert stats["acceptance_rate"] == 1.0
        assert stats["effective_tokens_per_step"] > 1.0

    def test_eos_latch_and_padding(self, pair):
        jm, tm = pair
        prompt = np.asarray([4, 9, 2, 4, 9, 2], np.int32)
        expect = _solo(tm, prompt, 12)
        eos = int(expect[3])        # an early stop at a real token
        ids, _ = speculative_generate(tm, prompt[None], max_new_tokens=12, k=3,
                                      eos_token_id=eos, pad_token_id=0)
        jids, _ = jax_speculative_generate(jm, paddle.to_tensor(prompt[None]),
                                           max_new_tokens=12, k=3, eos_token_id=eos,
                                           pad_token_id=0)
        row = ids.numpy()[0]
        cut = list(row).index(eos)
        np.testing.assert_array_equal(row[:cut + 1], expect[:cut + 1])
        assert all(t == 0 for t in row[cut + 1:])
        np.testing.assert_array_equal(ids.numpy(), jids.numpy())

    def test_sampling_path_is_seeded(self, pair):
        _, tm = pair
        prompt = np.asarray([4, 9, 2, 4, 9, 2], np.int32)
        kw = dict(max_new_tokens=8, drafter=lambda: DraftModelDrafter(tm, 64), k=3,
                  do_sample=True, temperature=0.8, seed=7)
        ids, stats = speculative_generate(tm, prompt[None], **kw)
        row = ids.numpy()[0]
        assert row.shape == (8,) and ((0 <= row) & (row < 96)).all()
        np.testing.assert_array_equal(speculative_generate(tm, prompt[None], **kw)[0], ids)

    def test_rope_overhang_guard(self, pair):
        """prompt + max_new at the rope table's edge raises, in both
        packages, instead of writing past the cache."""
        jm, tm = pair
        prompt = np.ones((TINY["max_position_embeddings"] - 4,), np.int32)
        with pytest.raises(ValueError, match="max_position_embeddings"):
            speculative_generate(tm, prompt[None], max_new_tokens=4, k=4)
        with pytest.raises(ValueError, match="max_position_embeddings"):
            jax_speculative_generate(jm, paddle.to_tensor(prompt[None]), max_new_tokens=4, k=4)
        # one spare position: k shrinks to fit and the stream stays exact
        prompt = np.arange(1, TINY["max_position_embeddings"] - 4, dtype=np.int32) % 96
        ids, _ = speculative_generate(tm, prompt[None], max_new_tokens=3, k=4)
        np.testing.assert_array_equal(ids.numpy()[0], _solo(tm, prompt, 3))


# ---------------------------------------------------------------------------
# the serving engine with speculation
# ---------------------------------------------------------------------------
def _spec_counts(eng):
    m = eng.meter
    return (m.spec_proposed_total, m.spec_accepted_total, m.spec_emitted_total,
            m.spec_verify_steps, m.spec_rows_total)


class TestEngineSpeculative:
    def test_token_exact_vs_serial_and_reference(self, pair):
        jm, tm = pair
        prompts = _mixed_prompts()
        _, serial = _serve(ServingEngine, tm, prompts)
        eng, spec = _serve(ServingEngine, tm, prompts, speculative=4)
        jeng, jspec = _serve(JaxEngine, jm, prompts, speculative=4)
        for i, (a, b, c) in enumerate(zip(serial, spec, jspec)):
            np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
            np.testing.assert_array_equal(b, c, err_msg=f"request {i}")
        assert _spec_counts(eng) == _spec_counts(jeng)
        s, js = eng.meter.summary(), jeng.meter.summary()
        for key in ("spec_acceptance", "effective_tokens_per_step"):
            assert s[key] == js[key] and s[key] is not None
        assert s["effective_tokens_per_step"] >= 1.0

    def test_oracle_drafter_acceptance(self, pair):
        jm, tm = pair
        prompts = _mixed_prompts(3)
        _, serial = _serve(ServingEngine, tm, prompts)
        oracle = _oracle(tm, prompts, 10)
        eng, spec = _serve(ServingEngine, tm, prompts,
                           speculative=SpecConfig(k=4, drafter=oracle))
        jeng, jspec = _serve(JaxEngine, jm, prompts,
                             speculative=JaxSpecConfig(k=4, drafter=oracle))
        for a, b, c in zip(serial, spec, jspec):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(b, c)
        s = eng.meter.summary()
        assert s["spec_acceptance"] == 1.0 and s["effective_tokens_per_step"] > 1.0
        assert _spec_counts(eng) == _spec_counts(jeng)

    def test_decode_width_is_fixed(self, pair):
        """Every decode forward is [max_batch, 1 + k] wide whatever
        AdaptiveK picks (a drafter that is always wrong drives it from 3
        valid draft slots down to 1); prefill chunks are [1, page_tokens]."""
        _, tm = pair
        eng = ServingEngine(tm, speculative=SpecConfig(k=3, drafter=WrongDrafter), **KW)
        shapes, valid = [], []
        fwd = eng._forward

        def spy(tokens, positions, tables, n_tok, **k):
            shapes.append(tuple(tokens.shape))
            if tokens.shape[0] == KW["max_batch"]:
                valid.append(int(n_tok.max()))
            return fwd(tokens, positions, tables, n_tok, **k)

        eng._forward = spy
        rng = np.random.default_rng(8)
        for p in [rng.integers(1, 96, n).astype(np.int32) for n in (5, 9, 3)]:
            eng.submit(p, max_new_tokens=10)
        eng.run()
        decode = [s for s in shapes if s[0] == KW["max_batch"]]
        assert decode and set(decode) == {(KW["max_batch"], 4)}
        assert set(shapes) - set(decode) == {(1, KW["page_tokens"])}
        assert valid[0] == 4 and 2 in valid and eng._adapt.k() == 1, valid

    def test_serial_summary_leaves_spec_fields_none(self, pair):
        eng, _ = _serve(ServingEngine, pair[1], _mixed_prompts()[:1], max_new=3)
        s = eng.meter.summary()
        assert s["spec_acceptance"] is None and s["effective_tokens_per_step"] is None
        assert eng.spec is None and eng._spec_width == 1

    def test_token_exact_under_eviction(self, pair):
        jm, tm = pair
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, 96, n).astype(np.int32) for n in (6, 9, 5)]
        _, serial = _serve(ServingEngine, tm, prompts, kw=EVICT)
        eng, spec = _serve(ServingEngine, tm, prompts, kw=EVICT, speculative=3)
        jeng, jspec = _serve(JaxEngine, jm, prompts, kw=EVICT, speculative=3)
        assert eng.meter.summary()["evictions"] >= 1
        for a, b, c in zip(serial, spec, jspec):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(b, c)
        assert _spec_counts(eng) == _spec_counts(jeng)
        assert eng.meter.summary()["evictions"] == jeng.meter.summary()["evictions"]

    def test_token_exact_under_offload_recall(self, pair):
        """Two 20-token prompts outgrow a 9-page pool: the victim swaps out
        to the host tier and back with its drafter kept, and the streams
        match the serial engine's with room for both."""
        _, tm = pair
        rng = np.random.default_rng(7)
        prompts = [rng.integers(1, 96, 20).astype(np.int32) for _ in range(2)]
        _, serial = _serve(ServingEngine, tm, prompts, max_new=20,
                           kw=dict(OFFLOAD_KW, num_pages=32))
        drafters = {}
        eng = ServingEngine(tm, offload=True, speculative=3, **OFFLOAD_KW)
        fwd = eng._forward

        def spy(tokens, *a, **k):   # the drafter each decode step sees
            if tokens.shape[0] == OFFLOAD_KW["max_batch"]:
                for r in eng._active.values():
                    drafters.setdefault(r.rid, set()).add(id(r.drafter))
            return fwd(tokens, *a, **k)

        eng._forward = spy
        rids = [eng.submit(p, max_new_tokens=20) for p in prompts]
        outs = eng.run()
        s = eng.meter.summary()
        assert s["kv_offloads"] >= 1 and s["kv_recalls"] >= 1 and s["evictions"] == 0
        for r, want in zip(rids, serial):
            np.testing.assert_array_equal(outs[r], want)
        assert all(len(ids) == 1 for ids in drafters.values()), "a recall kept its drafter"
        eng.pool.check_leaks()

    def test_journal_crash_recovery_token_exact(self, pair, tmp_path):
        """A speculative engine abandoned mid-stream, recovered into a fresh
        one from its journal: every stream equals the serial one, every
        sink token once."""
        _, tm = pair
        prompts = _mixed_prompts(5)
        _, serial = _serve(ServingEngine, tm, prompts)
        jdir, spath = str(tmp_path / "j"), str(tmp_path / "out.jsonl")
        sink = TokenSink(spath)
        eng = ServingEngine(tm, speculative=3, journal=jdir, on_token=sink, **KW)
        rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
        for _ in range(3):
            eng.step()
        assert TokenSink.collect(spath) and not eng._results
        sink.close()
        sink = TokenSink(spath)
        eng2 = ServingEngine(tm, speculative=3, journal=jdir, on_token=sink, **KW)
        info = eng2.recover()
        outs = eng2.run()
        sink.close()
        assert info["replayed"] == len(prompts)
        streams = TokenSink.collect(spath)     # raises on a duplicate
        for r, want in zip(rids, serial):
            np.testing.assert_array_equal(outs[r], want)
            assert streams[r] == list(want)
        eng3 = ServingEngine(tm, speculative=3, journal=jdir, **KW)
        eng3.recover()
        for r, want in zip(rids, serial):
            np.testing.assert_array_equal(eng3._results[r], want)

    def test_spec_config_resolution(self, pair, monkeypatch):
        _, tm = pair
        small = dict(max_batch=2, page_tokens=8, num_pages=16, max_pages_per_seq=4)
        eng = ServingEngine(tm, speculative=SpecConfig(k=2, adaptive=False), **small)
        assert eng._spec_width == 3 and not eng._adapt.adaptive
        assert ServingEngine(tm, speculative=0, **small).spec is None
        with pytest.raises(TypeError):
            ServingEngine(tm, speculative="yes", **small)
        monkeypatch.setenv("PADDLE_TPU_SPEC_K", "3")
        eng2 = ServingEngine(tm, **small)
        assert eng2.spec is not None and eng2._spec_width == 4
        assert ServingEngine(tm, speculative=1, **small)._spec_width == 2
