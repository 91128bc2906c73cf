"""The port's MoE Llama against the JAX package's, on the CPU.

``llama_moe_tiny()`` (an ``ExpertParallelMLP`` in both layers) and
``llama_moe_tiny(num_hidden_layers=4, moe_every=2)`` (MoE and dense
layers in turn) are built from a seed in the JAX package; their weights
cross through ``convert``.  At f32: logits within rtol 1e-4 / atol 1e-5
and the aux loss within 1e-5 (attention and the vocabulary sum in another
order); losses within rtol 1e-4 and every gradient within rtol 1e-4 /
atol 1e-5, the chunked fused loss included; three ``TrainStep`` steps of
AdamW + clip loss by loss within rtol 1e-4, under O2 within 2e-2;
``recompute`` bit-equal to no recompute.  Greedy ``generate``,
``Predictor.generate_batch``, ``speculative_generate`` and the
``ServingEngine`` (``tp`` 1 and 2, ``cp`` 2, ``speculative``) are
token-exact.

Routing couples the tokens of one call, so each path must feed the MoE
the reference's token blocks: a prefill chunk with its zero pads, a
decode step with its idle rows.  ``TestEngineBlocks`` builds a model in
which a prefill chunk's pads fill the expert a real token chooses second,
so that choice drops only when the pads are fed, and holds the engine to
the JAX engine there.

Engine sizes are explicit: ``tests/conftest.py`` pins the serving
environment variables for the whole suite.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.generation import ShallowExitDrafter as JaxShallowExitDrafter
from paddle_tpu.generation import speculative_generate as jax_speculative_generate
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_moe_tiny as jax_llama_moe_tiny
from paddle_tpu.models import mixtral_8x7b as jax_mixtral_8x7b
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.engine import Request as JaxRequest

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.generation import ShallowExitDrafter, speculative_generate
from paddle_tpu_torch.incubate.distributed.models import moe
from paddle_tpu_torch.incubate.distributed.models.moe import ExpertParallelMLP
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama_moe_tiny, mixtral_8x7b
from paddle_tpu_torch.models.llama import LlamaMLP
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.engine import Request

torch.set_num_threads(1)
_DEFAULT_FLAGS = dict(ptt.get_flags())   # at import, before any test sets one

LOGITS = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-4, atol=0)
GRAD = dict(rtol=1e-4, atol=1e-5)
CONFIGS = {"every": {}, "alternate": dict(num_hidden_layers=4, moe_every=2)}
SERVE = dict(vocab_size=96)
KW = dict(max_batch=4, page_tokens=8, num_pages=40, max_pages_per_seq=6)


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _pair(seed, **kw):
    paddle.seed(seed)
    jm = JaxLlama(jax_llama_moe_tiny(**kw))
    tm = LlamaForCausalLM(llama_moe_tiny(**kw), device="cpu")
    load_numpy_state_dict(tm, _state(jm))
    return jm, tm


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jm, tm = _pair(0, **CONFIGS[request.param])
    jm.eval(), tm.eval()
    return jm, tm


@pytest.fixture(autouse=True)
def _numerics_pinned():
    """The process state a bit-exact comparison reads, pinned for each test
    and restored after it: one intra-op thread, grad mode on, f32 default
    dtype, no CPU autocast, the port's flags at their defaults.  An earlier
    test file of the same worker may leave any of them changed."""
    saved = (torch.get_num_threads(), torch.is_grad_enabled(), torch.get_default_dtype(),
             torch.is_autocast_enabled("cpu"), dict(ptt.get_flags()))
    torch.set_num_threads(1)
    torch.set_grad_enabled(True)
    torch.set_default_dtype(torch.float32)
    torch.set_autocast_enabled("cpu", False)
    ptt.set_flags(_DEFAULT_FLAGS)
    yield
    torch.set_num_threads(saved[0])
    torch.set_grad_enabled(saved[1])
    torch.set_default_dtype(saved[2])
    torch.set_autocast_enabled("cpu", saved[3])
    ptt.set_flags(saved[4])


@pytest.fixture(autouse=True)
def _request_ids():
    """Both packages number requests from a class counter; restore them."""
    saved = JaxRequest._next_rid, Request._next_rid
    yield
    JaxRequest._next_rid, Request._next_rid = saved


def _ids(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(np.int32)


def _batch(seed, b=2, s=16):
    ids = _ids(seed, (b, s))
    return ids, np.roll(ids, -1, axis=1)


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class TestModel:
    def test_layers_and_names(self, pair):
        jm, tm = pair
        tm(torch.ones(1, 2, dtype=torch.long))
        assert [n for n, _ in tm.named_buffers()] == ["llama.rope_cos", "llama.rope_sin"]
        kinds = [type(ly.mlp).__name__ for ly in tm.llama.layers]
        assert kinds == [type(ly.mlp).__name__ for ly in jm.llama.layers]
        assert "ExpertParallelMLP" in kinds
        assert sorted(n for n, _ in tm.named_parameters()) == \
            sorted(n for n, _ in jm.named_parameters())

    def test_logits_and_aux_loss_match(self, pair):
        jm, tm = pair
        ids = _ids(1, (2, 11))
        with torch.no_grad():
            got = tm(torch.as_tensor(ids))
            aux = tm.moe_aux_loss()
        _close(got, jm(paddle.to_tensor(ids)).numpy(), LOGITS)
        _close(aux, jm.moe_aux_loss().numpy(), dict(rtol=1e-5, atol=0))

    @pytest.mark.parametrize("chunk", [0, 8])
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_loss_and_every_grad_match(self, name, chunk):
        jm, tm = _pair(2, fused_ce_chunk=chunk, **CONFIGS[name])
        ids, labels = _batch(3)
        jloss, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jloss.backward()
        loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        _close(loss, jloss.numpy(), LOSS)
        assert (logits is None) == (jlogits is None) == (chunk > 0)
        jparams = dict(jm.named_parameters())
        for n, p in tm.named_parameters():
            _close(p.grad, jparams[n].grad.numpy(), dict(GRAD, err_msg=n))

    def test_recompute_leaves_moe_layers_unchecked_and_gives_the_same_grads(self, monkeypatch):
        jm, _ = _pair(4, **CONFIGS["alternate"])
        ids, labels = _batch(5)
        wrapped = []
        from paddle_tpu_torch.models import llama as llama_mod

        real = llama_mod.recompute
        monkeypatch.setattr(llama_mod, "recompute",
                            lambda layer, *a: wrapped.append(type(layer.mlp)) or real(layer, *a))
        grads, losses = [], []
        for flag in (False, True):
            tm = LlamaForCausalLM(llama_moe_tiny(recompute=flag, **CONFIGS["alternate"]),
                                  device="cpu")
            load_numpy_state_dict(tm, _state(jm))
            loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
            loss.backward()
            losses.append(loss.detach())
            grads.append({n: p.grad for n, p in tm.named_parameters()})
        assert wrapped == [LlamaMLP, LlamaMLP]
        torch.testing.assert_close(losses[1], losses[0], rtol=0, atol=0)
        for n, g in grads[0].items():
            torch.testing.assert_close(grads[1][n], g, rtol=0, atol=0)
        jr = JaxLlama(jax_llama_moe_tiny(recompute=True, **CONFIGS["alternate"]))
        jr.set_state_dict(jm.state_dict())
        jloss, _ = jr(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        _close(losses[1], jloss.numpy(), LOSS)

    def test_configs_equal_the_reference_field_for_field(self):
        for mine, theirs in ((llama_moe_tiny(), jax_llama_moe_tiny()),
                             (mixtral_8x7b(), jax_mixtral_8x7b()),
                             (mixtral_8x7b(num_hidden_layers=16), jax_mixtral_8x7b(
                                 num_hidden_layers=16))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def _param_count(cfg) -> int:
    """Parameters of ``LlamaForCausalLM(cfg)``, reckoned from the config."""
    d, h, kv, hd = cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    attn = d * h * hd * 2 + d * kv * hd * 2
    total = cfg.vocab_size * d * (1 if cfg.tie_word_embeddings else 2) + d
    for i in range(cfg.num_hidden_layers):
        moe_layer = cfg.moe_num_experts > 0 and i % cfg.moe_every == 0
        e = cfg.moe_num_experts
        mlp = d * e + 3 * e * d * cfg.intermediate_size if moe_layer \
            else 3 * d * cfg.intermediate_size
        total += attn + mlp + 2 * d
    return total


def test_mixtral_layer_is_1_4513_billion_parameters():
    for kw in CONFIGS.values():
        cfg = llama_moe_tiny(**kw)
        assert _param_count(cfg) == LlamaForCausalLM(cfg, device="cpu").num_params()
    one, two = (_param_count(mixtral_8x7b(num_hidden_layers=n)) for n in (1, 2))
    assert two - one == 1_451_270_144
    assert round((two - one) / 1e9, 4) == 1.4513
    assert round(_param_count(mixtral_8x7b()) / 1e9, 2) == 46.70
    assert round(_param_count(mixtral_8x7b(num_hidden_layers=16)) / 1e9, 2) == 23.48


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
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


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_follows_jax(name, amp):
    jm, tm = _pair(6, **CONFIGS[name])
    batches = [_batch(7)] * 3
    jm, jl = _jax_train(jm, batches, amp)
    tm, opt, tl = _torch_train(tm, batches, amp)
    np.testing.assert_allclose(tl, jl, **(dict(rtol=2e-2) if amp else LOSS))
    assert tl[-1] < tl[0] and all(np.isfinite(tl))
    if amp:
        experts = [p for n, p in tm.named_parameters() if n.endswith((".w1", ".w2"))]
        assert experts and all(p.dtype == torch.bfloat16 and p.dim() == 3 for p in experts)
        assert all(opt._master_weights[id(p)].dtype == torch.float32 for p in experts)
        jdt = {n: str(p.dtype) for n, p in jm.named_parameters()}
        assert {n: str(p.dtype).replace("torch.", "") for n, p in tm.named_parameters()} == jdt


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------
@pytest.fixture
def traced_moe(monkeypatch):
    """The JAX package's ``Layer.__setattr__`` makes the MoE layer's
    ``l_aux`` a non-persistable buffer on its first forward, so a traced
    ``generate`` leaves a tracer among the model's buffers, and the next
    program, which takes the buffers as arguments, raises
    ``UnexpectedTracerError`` (a fault of the reference, ROADMAP §C; the
    port keeps ``l_aux`` a plain attribute).  Generation reads no
    ``l_aux``: keeping it out of the buffers changes no value of these
    programs and lets the reference run more than one."""
    real = jmoe.ExpertParallelMLP.forward

    def forward(self, inp):
        out = real(self, inp)
        la = self._buffers.pop("l_aux", None)
        self._non_persistable_buffer_names.discard("l_aux")
        object.__setattr__(self, "l_aux", la)
        return out

    monkeypatch.setattr(jmoe.ExpertParallelMLP, "forward", forward)


def _same_generation(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=0, atol=1e-5)


@pytest.mark.usefixtures("traced_moe")
class TestGeneration:
    def test_greedy_left_padded_token_exact(self, pair):
        jm, tm = pair
        ids = _ids(8, (3, 12))
        mask = np.ones((3, 12), np.int32)
        mask[0, :5] = 0
        mask[2, :11] = 0
        kw = dict(max_new_tokens=6, eos_token_id=5, pad_token_id=0, attention_mask=mask)
        got = tm.generate(ids, **kw)
        want = jm.generate(paddle.to_tensor(ids), **kw)
        _same_generation((got[0].numpy(), got[1].numpy()), (want[0].numpy(), want[1].numpy()))

    def test_generate_batch_token_exact(self, pair):
        """Ragged prompts in two length buckets, batches of two rows (the
        last one filled with a copy)."""
        jm, tm = pair
        rng = np.random.default_rng(9)
        prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (3, 17, 9, 30, 5)]
        kw = dict(max_batch=2, max_new_tokens=5, eos_token_id=5, pad_token_id=0)
        got = Predictor.from_model(tm).generate_batch(prompts, **kw)
        want = JaxPredictor.from_model(jm).generate_batch(prompts, **kw)
        assert len(got) == len(want) == len(prompts)
        for a, b in zip(got, want):
            _same_generation(a, b)

    def test_speculative_generate_token_exact(self, pair):
        """The shallow-exit drafter runs the first layer's MoE on one
        token; the verify block [1, 1 + k] routes as the reference's."""
        jm, tm = pair
        prompt = _ids(10, (1, 7))
        ids, stats = speculative_generate(tm, prompt, max_new_tokens=8, k=3,
                                          drafter=lambda: ShallowExitDrafter(tm, 64))
        jids, jstats = jax_speculative_generate(
            jm, paddle.to_tensor(prompt), max_new_tokens=8, k=3,
            drafter=lambda: JaxShallowExitDrafter(jm, 64))
        np.testing.assert_array_equal(ids.numpy(), jids.numpy())
        assert stats["verify_steps"] == jstats["verify_steps"]


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
def _serve_pair(seed=11, **kw):
    paddle.seed(seed)
    jm = JaxLlama(jax_llama_moe_tiny(**SERVE, **kw))
    jm.eval()
    tm = LlamaForCausalLM(llama_moe_tiny(**SERVE, **kw), device="cpu")
    load_numpy_state_dict(tm, _state(jm))
    return jm, tm.eval()


def _serve(eng, prompts, max_new=6, eos=5):
    rids = [eng.submit(p, max_new_tokens=max_new, eos_token_id=eos) for p in prompts]
    outs = eng.run()
    return [list(outs[r]) for r in rids]


def _prompts(seed=12, lens=(5, 11, 20)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, n).astype(np.int32) for n in lens]


@pytest.mark.serving
class TestEngine:
    @pytest.mark.parametrize("spec", [0, 3])
    @pytest.mark.parametrize("tp", [1, 2])
    def test_token_exact_vs_jax_engine(self, tp, spec):
        """``max_batch`` 4 over 3 prompts (an idle row every step), prompts
        of 5, 11 and 20 tokens over 8-token pages."""
        jm, tm = _serve_pair()
        prompts = _prompts()
        got = _serve(ServingEngine(tm, tp=tp, speculative=spec, **KW), prompts)
        want = _serve(JaxEngine(jm, tp=tp, speculative=spec, **KW), prompts)
        assert got == want
        assert all(len(g) == 6 or g[-1] == 5 for g in got)

    def test_cp_prefill_token_exact_vs_jax_engine(self):
        """``cp=2``: each prompt of at least two page chunks prefills in one
        forward, whose MoE routes the whole padded prompt at once."""
        jm, tm = _serve_pair()
        prompts = _prompts(16, (40, 33))
        eng = ServingEngine(tm, cp=2, **KW)
        got = _serve(eng, prompts)
        assert eng.cp_prefills == 2 and not eng.cp_fallbacks
        assert got == _serve(JaxEngine(jm, cp=2, **KW), prompts)

    def test_moe_weights_stay_whole_under_tp(self):
        _, tm = _serve_pair(**CONFIGS["alternate"])
        eng = ServingEngine(tm, tp=2, **KW)
        moe_layers = [i for i, ly in enumerate(tm.llama.layers)
                      if isinstance(ly.mlp, ExpertParallelMLP)]
        assert moe_layers == [0, 2]
        for i, w in enumerate(eng._weights):
            assert ("gate" in w) == (i not in moe_layers)
            assert len(w["q"]) == 2
        assert not hasattr(tm.llama.layers[0].mlp.w1, "shards")
        assert _serve(eng, _prompts()) == _serve(ServingEngine(_serve_pair(
            **CONFIGS["alternate"])[1], **KW), _prompts())


def _crafted_pair():
    """A model whose routers send token 0 (the pad) to expert 0 first and
    every other token to expert 2 first and expert 0 second: each token's
    embedding is 10·u (pad) or 10·w (others) plus its drawn row, and each
    router reads the u and w coordinates of the normalised input."""
    jm, _ = _serve_pair(seed=13, moe_capacity_factor=1.0)
    arrays = {k: v.copy() for k, v in _state(jm).items()}
    emb = arrays["llama.embed_tokens.weight"]
    emb[0, 0] += 10.0
    emb[1:, 1] += 10.0
    for name in arrays:
        if name.endswith("mlp.gate_weight"):
            g = np.zeros_like(arrays[name])
            g[0] = [3.0, 2.0, 0.0, 0.0]
            g[1] = [2.0, 0.0, 3.0, 0.0]
            arrays[name] = g
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in arrays.items()})
    tm = LlamaForCausalLM(llama_moe_tiny(**SERVE, moe_capacity_factor=1.0), device="cpu")
    load_numpy_state_dict(tm, arrays)
    return jm, tm.eval()


@pytest.mark.serving
class TestEngineBlocks:
    def test_pads_push_a_real_second_choice_out_and_the_engines_agree(self, monkeypatch):
        """A 17-token prompt over 16-token pages: its last chunk is one
        real token and 15 pads.  Fed that chunk, the pads' first choices
        fill expert 0 (capacity 8), and the real token's second choice
        (expert 0) drops; fed the real token alone it would be kept."""
        jm, tm = _crafted_pair()
        kw = dict(max_batch=2, page_tokens=16, num_pages=12, max_pages_per_seq=4)
        prompts = [_prompts(14, (17,))[0], _prompts(15, (6,))[0]]
        seen = []
        real_route = moe._route

        def spy(logits, k, capacity):
            r = real_route(logits, k, capacity)
            seen.append((logits.shape[0], r))
            return r

        monkeypatch.setattr(moe, "_route", spy)
        got = _serve(ServingEngine(tm, **kw), prompts, max_new=5, eos=None)
        monkeypatch.undo()
        want = _serve(JaxEngine(jm, **kw), prompts, max_new=5, eos=None)
        assert got == want
        chunk = [r for n, r in seen if n == 16]
        last = chunk[tm.config.num_hidden_layers]   # the second chunk, first layer
        assert last.expert[:, 0].tolist() == [2, 0]
        assert not bool(last.keep[1, 0]) and bool((last.expert[0, 1:] == 0).all())
        alone = real_route(torch.tensor([[16.0, 0.0, 24.0, 0.0]]), 2, 8)
        assert bool(alone.keep.all())
