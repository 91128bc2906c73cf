"""The port's context-parallel prefill (``ServingEngine(cp=n)``) against the
JAX engine, on the CPU (the counterpart of ``test_longctx.py``'s
``TestCPPrefill``).

``llama_tiny`` (2 layers, vocab 96, f32, the JAX model's weights carried
across), prompts of 40 and 33 tokens in 8-token pages (both pad to 6
chunks, 48 tokens):
- ``cp=2`` token-exact against the JAX engine with ``cp=2`` (its ring over
  two virtual CPU devices) and against the port's chunked engine, for bf16,
  int8 and fp8 pages, and ``cp=4`` against the chunked engine;
- the pages the ring prefill writes: every page outside the prompt's table
  and the trash page untouched, the prompt's pages equal to the chunked
  prefill's (int8 scales and fp8 bytes included) up to f32 rounding;
- a one-chunk prompt takes the chunked path (``short_prompt``);
- ``tp=2, cp=2`` raises; the ring members wrap round-robin over the
  visible devices; no page leaks.

Engine sizes are explicit: ``tests/conftest.py`` pins the serving
environment variables for the whole suite.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.engine import Request as JaxRequest

from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.serving import ServingEngine, TRASH_PAGE
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.engine import Request

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

TINY = dict(num_hidden_layers=2, vocab_size=96, max_position_embeddings=128)
ENGINE = dict(max_batch=2, page_tokens=8, num_pages=32, max_pages_per_seq=6)


@pytest.fixture(autouse=True)
def _request_ids():
    """Both packages number requests from a class counter; restore them, so
    that later tests of the same process that compare rids across the two
    engines see the counters as they left them."""
    saved = JaxRequest._next_rid, Request._next_rid
    yield
    JaxRequest._next_rid, Request._next_rid = saved


def _jax_model():
    """A fresh same-seeded JAX model per engine: a cp > 1 JAX engine puts
    the parameters on its ring mesh in place."""
    paddle.seed(3)
    m = JaxLlama(jax_llama_tiny(**TINY))
    m.eval()
    return m


@pytest.fixture(scope="module")
def model():
    tm = LlamaForCausalLM(llama_tiny(**TINY), device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy())
                               for k, v in _jax_model().state_dict().items()})
    return tm.eval()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, n).astype(np.int32) for n in lens]


def _serve(eng, prompts, max_new=8):
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    outs = eng.run()
    assert eng.pool.pages_free == eng.pool.capacity     # no page leaked
    return [outs[r] for r in rids]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_cp2_token_exact_vs_jax_cp2_and_chunked(model, kv_dtype):
    prompts = _prompts(11, (40, 33))
    cpe = ServingEngine(model, cp=2, kv_dtype=kv_dtype, **ENGINE)
    got = _serve(cpe, prompts)
    assert cpe.cp_prefills == 2 and not cpe.cp_fallbacks
    chunked = _serve(ServingEngine(model, kv_dtype=kv_dtype, **ENGINE), prompts)
    jeng = JaxEngine(_jax_model(), cp=2, kv_dtype=kv_dtype, **ENGINE)
    want = _serve(jeng, prompts)
    assert len(jeng._cp_execs) == 1       # the JAX ring served both prompts
    for g, c, w in zip(got, chunked, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, c)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_cp4_token_exact_vs_chunked(model, kv_dtype):
    prompts = _prompts(12, (40, 33))
    cpe = ServingEngine(model, cp=4, kv_dtype=kv_dtype, **ENGINE)
    got = _serve(cpe, prompts)
    assert cpe.cp_prefills == 2
    chunked = _serve(ServingEngine(model, kv_dtype=kv_dtype, **ENGINE), prompts)
    for g, c in zip(got, chunked):
        np.testing.assert_array_equal(g, c)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_ring_prefill_writes_only_the_prompt_pages(model, kv_dtype):
    """One 33-token prompt over pages 5, 9, 2, 7, 11 (its table) and the
    trash page (the sixth, pad chunk): every other page stays zero, and the
    prompt's pages hold what the chunked prefill writes."""
    p = _prompts(13, (33,))[0]
    table = [5, 9, 2, 7, 11]
    cpe = ServingEngine(model, cp=2, kv_dtype=kv_dtype, **ENGINE)
    ref = ServingEngine(model, kv_dtype=kv_dtype, **ENGINE)
    got = cpe._cp_prefill_run(p, table)
    padded = np.full((ENGINE["max_pages_per_seq"],), TRASH_PAGE, np.int32)
    padded[:len(table)] = table
    want = ref._prefill_chunks(p, padded[None])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    others = [i for i in range(ENGINE["num_pages"]) if i not in table + [TRASH_PAGE]]
    for key, arenas in cpe._arenas.items():
        for li, arena in enumerate(arenas):
            assert not arena[others].float().any(), f"{key}[{li}] wrote outside the table"
            a, b = arena[table].float(), ref._arenas[key][li][table].float()
            if key in ("k", "v") and kv_dtype != "bf16":
                # a k/v value one f32 ulp apart can cross a rounding
                # boundary of the quantizer: one step of int8 or e4m3
                step = 1.0 if kv_dtype == "int8" else 0.125 * b.abs().max()
                assert (a - b).abs().max() <= step, f"{key}[{li}]"
            else:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_one_chunk_prompt_takes_the_chunked_path(model):
    p = np.arange(1, 9, dtype=np.int32)       # one chunk < cp = 2
    eng = ServingEngine(model, cp=2, **ENGINE)
    got = _serve(eng, [p], max_new=4)
    assert eng.cp_fallbacks == {"short_prompt": 1} and eng.cp_prefills == 0
    np.testing.assert_array_equal(got[0], _serve(ServingEngine(model, **ENGINE), [p],
                                                 max_new=4)[0])


def test_tp_with_cp_is_loud(model):
    with pytest.raises(ValueError, match="cannot combine"):
        ServingEngine(model, tp=2, cp=2, **ENGINE)


def test_ring_members_wrap_round_robin(model, monkeypatch):
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(engine_mod, "devices", lambda kind: cards)
    eng = ServingEngine(model, cp=3, **ENGINE)
    assert eng.cp_devices == [cards[0], cards[1], cards[0]]
    assert eng._mesh.axis_devices("sep") == eng.cp_devices
    assert ServingEngine(model, cp=2, **ENGINE).cp_devices == [cards[0], cards[1]]
    monkeypatch.undo()
    assert ServingEngine(model, cp=4, **ENGINE).cp_devices == [torch.device("cpu")] * 4
