"""The port's serving slice against the JAX package, on the CPU.

- ``serving.kv_quant``: the int8 values and scales and the fp8 bytes equal
  those of the reference's compiled quantizers (``jax.jit``; XLA turns the
  division by a constant into a multiplication by its f32 reciprocal).
  Against the reference called eagerly, the int8 values are equal and the
  scales within 1 ulp.
- B8/B9's plain twins (``decode_attention_int8/fp8_plain``) against the
  Pallas kernels run with ``interpret=True`` at the reference tests'
  shapes: ``out`` within 2e-5 (f32), caches and scales bit-equal
  everywhere, the appended row included.
- ``PagedKVPool``: one seeded sequence of calls gives the same tables,
  free counts and bytes in both packages.
- ``ServingEngine`` on ``llama_tiny`` (2 layers, vocab 96, f32, the JAX
  model's weights carried across): token streams equal to the JAX
  engine's for bf16 (native), int8 and fp8 pages; ``last_decode_logits``
  within 1e-4 of max |logit| for native pages and 2e-3 for int8/fp8 (a k/v
  value one ulp apart can cross a rounding boundary of the quantizer);
  mid-flight eviction token-exact against the JAX engine and against the
  port's own ``generate``; equal SLO summaries under the same fake clock;
  loud failures on poisoned pages; the unported options raise (the prefix
  cache, the offload tier and the journal are held in
  ``test_torch_prefix_offload.py`` and ``test_torch_journal.py``).

Engine sizes are explicit: ``tests/conftest.py`` pins the serving
environment variables for the whole suite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.models.llama import rotate_half_apply
from paddle_tpu.ops.pallas import decode_attention_fp8 as jax_decode_fp8
from paddle_tpu.ops.pallas import decode_attention_int8 as jax_decode_int8
from paddle_tpu.serving import Deadline as JaxDeadline
from paddle_tpu.serving import PagedKVPool as JaxPool
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import kv_quant as jkq

from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models.llama import _rope_tables, apply_rotary_at_positions
from paddle_tpu_torch.ops.decode_attention import (
    decode_attention_fp8, decode_attention_int8, decode_attention_int8_plain)
from paddle_tpu_torch.serving import (Deadline, Overloaded, PagedKVPool,
                                      ServingEngine, TRASH_PAGE)
from paddle_tpu_torch.serving import kv_quant as tkq

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

TINY = dict(num_hidden_layers=2, vocab_size=96, max_position_embeddings=128)
ENGINE = dict(max_batch=3, page_tokens=8, num_pages=32, max_pages_per_seq=6)
EVICT = dict(max_batch=3, page_tokens=4, num_pages=9, max_pages_per_seq=8)
LOGITS_TOL = {"bf16": 1e-4, "int8": 2e-3, "fp8": 2e-3}


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def pair():
    paddle.seed(3)
    jm = JaxLlama(jax_llama_tiny(**TINY))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**TINY), device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, n).astype(np.int32) for n in lens]


def _serve(engine_cls, model, prompts, max_new, eos=None, **kw):
    eng = engine_cls(model, **kw)
    rids = [eng.submit(p, max_new_tokens=max_new, eos_token_id=eos) for p in prompts]
    outs = eng.run()
    return eng, [outs[r] for r in rids]


def _bits(x):
    return np.asarray(x).view(np.uint8 if np.asarray(x).dtype.itemsize == 1 else np.int32)


# ---------------------------------------------------------------------------
# kv_quant
# ---------------------------------------------------------------------------
def _kv_samples():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 4, 64)) * 3).astype(np.float32)
    # exact half-way quotients: amax 127 gives scale 1, so x / scale = k + .5
    for row, sign in ((0, 1.0), (1, -1.0)):
        x[row, 0] = 0.0
        x[row, 0, 0] = sign * 127.0
        x[row, 0, 1:12] = sign * (np.arange(11) + 0.5)
    x[2, 1] = 0.0                                  # an all-zero token
    return x


class TestKvQuant:
    def test_int8_matches_reference(self):
        x = _kv_samples()
        q, s = tkq.quantize_kv(torch.from_numpy(x))
        jq, js = jax.jit(jkq.quantize_kv)(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
        eq, es = jkq.quantize_kv(jnp.asarray(x))   # eager: a true division
        np.testing.assert_array_equal(q.numpy(), np.asarray(eq))
        assert np.abs(_bits(s.numpy()) - _bits(es)).max() <= 1
        assert q[0, 0, :12].tolist() == [127, 0, 2, 2, 4, 4, 6, 6, 8, 8, 10, 10]
        assert not q[2, 1].any()
        np.testing.assert_array_equal(tkq.dequantize_kv(q, s).numpy(),
                                      np.asarray(jkq.dequantize_kv(jq, js)))

    @pytest.mark.parametrize("scale", [1.0, 0.5, 0.37])
    def test_fp8_matches_reference(self, scale):
        x = _kv_samples() * 40
        x[3, 0, :2] = (600.0, -600.0)
        got = tkq.quantize_kv_fp8(torch.from_numpy(x), scale)
        want = jax.jit(lambda v: jkq.quantize_kv_fp8(v, scale))(jnp.asarray(x))
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), _bits(want))
        if scale == 1.0:   # eager equals compiled where 1/scale is exact
            np.testing.assert_array_equal(
                got.view(torch.uint8).numpy(), _bits(jkq.quantize_kv_fp8(jnp.asarray(x), scale)))
            assert got[3, 0, :2].float().tolist() == [448.0, -448.0]
            assert np.asarray(want[3, 0, :2]).astype(np.float32).tolist() == [448.0, -448.0]
        np.testing.assert_array_equal(tkq.dequantize_kv_fp8(got, scale).numpy(),
                                      np.asarray(jkq.dequantize_kv_fp8(want, scale)))

    def test_dtype_resolution_and_scale_env(self, monkeypatch):
        for v in ("bf16", "float32", "int8", "s8", "fp8", "f8e4m3fn", None):
            assert tkq.kv_cache_dtype(v) == jkq.kv_cache_dtype(v)
        monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
        assert tkq.kv_cache_dtype() == "int8"
        with pytest.raises(NotImplementedError, match="e4m3fn"):
            tkq.kv_cache_dtype("f8e5m2")
        with pytest.raises(ValueError):
            tkq.kv_cache_dtype("int4")
        monkeypatch.setenv("PADDLE_TPU_KV_FP8_SCALE", "0.25")
        assert tkq.default_fp8_scale() == 0.25
        monkeypatch.setenv("PADDLE_TPU_KV_FP8_SCALE", "0")
        with pytest.raises(ValueError, match="> 0"):
            tkq.default_fp8_scale()
        with pytest.raises(NotImplementedError, match="A10"):
            tkq.observe_kv_absmax([torch.ones(2)])

    def test_page_bytes(self):
        for kvd in ("bf16", "int8", "fp8"):
            assert tkq.kv_page_bytes(8, 2, 16, kvd, n_layers=2) == \
                jkq.kv_page_bytes(8, 2, 16, kvd, n_layers=2)
            assert tkq.kv_scale_page_bytes(8, 2, kvd, n_layers=2) == \
                jkq.kv_scale_page_bytes(8, 2, kvd, n_layers=2)


# ---------------------------------------------------------------------------
# B8 / B9 plain twins against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
_B, _H, _KV, _D, _C, _BLK = 2, 8, 4, 64, 256, 128
CASES = {"pos100": (100, [0, 5], 1.0), "pos0": (0, [0, 3], 1.0),
         "pad_ge_pos": (100, [0, 120], 1.0), "last_row": (255, [7, 0], 1.0),
         "saturating": (100, [0, 5], 300.0)}


def _decode_inputs(seed, pos, amp):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((_B, 1, _H, _D)).astype(np.float32)
    kn = (amp * rng.standard_normal((_B, 1, _KV, _D))).astype(np.float32)
    vn = rng.standard_normal((_B, 1, _KV, _D)).astype(np.float32)
    ck = rng.standard_normal((_B, _C, _KV, _D)).astype(np.float32)
    cv = rng.standard_normal((_B, _C, _KV, _D)).astype(np.float32)
    ck[:, pos:] = 0
    cv[:, pos:] = 0
    return q, kn, vn, ck, cv


class TestDecodeTwins:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_int8_twin_matches_pallas(self, case):
        pos, pads, amp = CASES[case]
        q, kn, vn, ck, cv = _decode_inputs(1, pos, amp)
        ckq, ks = jkq.quantize_kv(jnp.asarray(ck))
        cvq, vs = jkq.quantize_kv(jnp.asarray(cv))
        ks_t, vs_t = jnp.transpose(ks, (0, 2, 1)), jnp.transpose(vs, (0, 2, 1))
        pads = np.asarray(pads, np.int32)
        want = jax_decode_int8(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), ckq, cvq,
                               ks_t, vs_t, pos, jnp.asarray(pads), block_k=_BLK,
                               interpret=True)
        ins = [torch.from_numpy(np.array(a)) for a in (q, kn, vn, ckq, cvq, ks_t, vs_t)]
        got = decode_attention_int8_plain(*ins, pos, torch.from_numpy(pads))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        for g, orig in zip(got[1:], ins[3:]):
            assert g is orig                        # updated in place
        # the wrapper takes the twin on CPU tensors
        again = decode_attention_int8(*[torch.from_numpy(np.array(a)) for a in
                                        (q, kn, vn, ckq, cvq, ks_t, vs_t)],
                                      pos, torch.from_numpy(pads))
        for g, w in zip(again, got):
            assert torch.equal(g, w)

    @pytest.mark.parametrize("kv_scale", [1.0, 0.5, 0.37])
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_fp8_twin_matches_pallas(self, case, kv_scale):
        pos, pads, amp = CASES[case]
        q, kn, vn, ck, cv = _decode_inputs(2, pos, amp)
        ckq = jkq.quantize_kv_fp8(jnp.asarray(ck), kv_scale)
        cvq = jkq.quantize_kv_fp8(jnp.asarray(cv), kv_scale)
        pads = np.asarray(pads, np.int32)
        want = jax_decode_fp8(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), ckq, cvq,
                              pos, jnp.asarray(pads), kv_scale=kv_scale, block_k=_BLK,
                              interpret=True)
        caches = [torch.from_numpy(_bits(c).copy()).view(torch.float8_e4m3fn)
                  for c in (ckq, cvq)]
        got = decode_attention_fp8(torch.from_numpy(q), torch.from_numpy(kn),
                                   torch.from_numpy(vn), *caches, pos,
                                   torch.from_numpy(pads), kv_scale=kv_scale)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.view(torch.uint8).numpy(), _bits(w))
        assert got[1] is caches[0] and got[2] is caches[1]

    def test_pad_ge_pos_attends_only_the_new_token(self):
        q, kn, vn, ck, cv = _decode_inputs(3, 50, 1.0)
        cq, _ = tkq.quantize_kv(torch.from_numpy(ck))
        caches = (cq, cq.clone(), torch.ones(_B, _KV, _C), torch.ones(_B, _KV, _C))
        out = decode_attention_int8_plain(
            torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), *caches, 50,
            torch.tensor([50, 60], dtype=torch.int32))[0]
        want = np.repeat(vn[:, :, :, None, :], _H // _KV, axis=3).reshape(_B, 1, _H, _D)
        np.testing.assert_array_equal(out.numpy(), want)

    def test_shapes_checked(self):
        q, kn, vn, ck, cv = (torch.from_numpy(a) for a in _decode_inputs(4, 10, 1.0))
        cq = ck.to(torch.int8)
        s = torch.ones(_B, _KV, _C)
        with pytest.raises(ValueError, match="scales"):
            decode_attention_int8(q, kn, vn, cq, cq.clone(), s[:, :, :10], s, 10)
        with pytest.raises(ValueError, match="outside the cache"):
            decode_attention_int8(q, kn, vn, cq, cq.clone(), s, s.clone(), _C)
        f8 = ck.to(torch.float8_e4m3fn)
        with pytest.raises(ValueError, match="kv_scale"):
            decode_attention_fp8(q, kn, vn, f8, f8.clone(), 10, kv_scale=0.0)
        with pytest.raises(ValueError, match=r"\[b, 1, h, d\]"):
            decode_attention_fp8(q, kn[:, :, :2], vn, f8, f8.clone(), 10)


# ---------------------------------------------------------------------------
# PagedKVPool
# ---------------------------------------------------------------------------
class TestPagedKVPool:
    def test_seeded_sequence_matches_reference(self):
        rng = np.random.default_rng(5)
        pools = (JaxPool(num_pages=24, page_tokens=4), PagedKVPool(num_pages=24, page_tokens=4))
        for p in pools:
            p.set_page_bytes(4096, 256, "int8")
        seen = set()
        for step in range(200):
            live = sorted(pools[1]._tables, key=str)
            op = "alloc" if not live else ("alloc", "free", "adopt", "incref")[rng.integers(0, 4)]
            if op == "alloc":
                args = (f"r{step}", int(rng.integers(1, 5)))
            elif op == "free":
                args = (live[rng.integers(0, len(live))],)
            else:
                args = (f"a{step}", pools[1].table(live[rng.integers(0, len(live))])[:2])
            results = []
            for p in pools:
                try:
                    if op == "alloc":
                        results.append(p.alloc(*args))
                    elif op == "free":
                        results.append(p.free(*args))
                    elif op == "adopt":
                        results.append(p.adopt(*args))
                    else:
                        p.incref(args[1])
                        results.append(p.decref(args[1]))
                except RuntimeError as e:   # each package's PoolExhausted
                    results.append(("exhausted", str(e)))
            assert results[0] == results[1], (step, op, results)
            seen.add("exhausted" if isinstance(results[1], tuple) else op)
            ref, port = pools
            assert {k: port.table(k) for k in port._tables} == \
                {k: ref.table(k) for k in ref._tables}, step
            for attr in ("pages_free", "pages_used", "peak_used", "bytes_per_page",
                         "scale_bytes_per_page", "kv_dtype"):
                assert getattr(port, attr) == getattr(ref, attr), (step, attr)
            assert (port.used_bytes(), port.pool_bytes(), port.shared_pages(),
                    port.occupancy(), port.bytes_per_token()) == \
                (ref.used_bytes(), ref.pool_bytes(), ref.shared_pages(),
                 ref.occupancy(), ref.bytes_per_token()), step
            assert [port.refcount(i) for i in range(24)] == [ref.refcount(i) for i in range(24)]
        assert seen == {"alloc", "free", "adopt", "incref", "exhausted"}
        for p in pools:
            for k in list(p._tables):
                p.free(k)
            p.check_leaks()

    def test_errors_match_reference(self):
        for cls in (JaxPool, PagedKVPool):
            pool = cls(num_pages=4, page_tokens=4)
            a = pool.alloc("a", 2)
            assert TRASH_PAGE not in a and pool.capacity == 3
            with pytest.raises(Exception, match="need 2 pages"):
                pool.alloc("b", 2)
            assert pool.table("b") == []
            with pytest.raises(AssertionError, match="leaked"):
                pool.check_leaks()
            with pytest.raises(ValueError, match="trash"):
                pool.incref([0])
            pool.free("a")
            with pytest.raises(KeyError):
                pool.free("a")
            with pytest.raises(KeyError, match="double-free"):
                pool.decref(a)
            pool.check_leaks()


# ---------------------------------------------------------------------------
# ServingEngine against the JAX engine
# ---------------------------------------------------------------------------
class TestEngine:
    @pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
    def test_token_exact_vs_reference(self, pair, kv_dtype):
        jm, tm = pair
        prompts = _prompts(0, (5, 11, 20, 7, 13))
        je, jouts = _serve(JaxEngine, jm, prompts, 6, eos=5, kv_dtype=kv_dtype, **ENGINE)
        te, touts = _serve(ServingEngine, tm, prompts, 6, eos=5, kv_dtype=kv_dtype, **ENGINE)
        for a, b in zip(touts, jouts):
            np.testing.assert_array_equal(a, b)
        a, b = te.last_decode_logits, np.asarray(je.last_decode_logits)
        assert a.shape == b.shape
        assert np.abs(a - b).max() / max(np.abs(b).max(), 1.0) < LOGITS_TOL[kv_dtype]
        adt = {"bf16": torch.float32, "int8": torch.int8, "fp8": torch.float8_e4m3fn}
        assert te._arenas["k"][0].dtype == adt[kv_dtype]
        assert sorted(te._arenas) == sorted(je._arenas)
        for key in ("bytes_per_page", "scale_bytes_per_page", "kv_dtype"):
            assert getattr(te.pool, key) == getattr(je.pool, key), key
        assert te._arena_bytes == je._arena_bytes and te._scale_bytes == je._scale_bytes

    def test_quantized_pages_halve_the_bytes(self, pair):
        _, tm = pair
        engines = {k: ServingEngine(tm, kv_dtype=k, **ENGINE) for k in ("bf16", "int8", "fp8")}
        bf = engines["bf16"].pool
        for k in ("int8", "fp8"):
            assert engines[k].pool.bytes_per_page * 2 == bf.bytes_per_page
        assert engines["int8"].pool.scale_bytes_per_page > 0
        assert engines["fp8"].pool.scale_bytes_per_page == 0 == bf.scale_bytes_per_page
        for e in engines.values():
            assert e.meter.summary()["kv_bytes_per_token"] == e.pool.bytes_per_token()

    @pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
    def test_eviction_token_exact(self, pair, kv_dtype):
        """A pool too small for the load forces mid-flight evictions: the
        port's streams equal the JAX engine's and, for native pages, its
        own unbatched ``generate``."""
        jm, tm = pair
        prompts = _prompts(2, (6, 9, 5))
        je, jouts = _serve(JaxEngine, jm, prompts, 10, kv_dtype=kv_dtype, **EVICT)
        te, touts = _serve(ServingEngine, tm, prompts, 10, kv_dtype=kv_dtype, **EVICT)
        assert te.meter.evictions_total >= 1
        assert te.meter.evictions_total == je.meter.evictions_total
        for a, b in zip(touts, jouts):
            np.testing.assert_array_equal(a, b)
        if kv_dtype == "bf16":
            for p, a in zip(prompts, touts):
                ids, _ = tm.generate(p[None], max_new_tokens=10)
                np.testing.assert_array_equal(a, ids.numpy()[0])
        te.pool.check_leaks()

    def test_summary_matches_reference_under_one_clock(self, pair):
        jm, tm = pair
        prompts = _prompts(2, (6, 9, 5, 12))
        summaries, meters = [], []
        for cls, model, dl in ((JaxEngine, jm, JaxDeadline), (ServingEngine, tm, Deadline)):
            clock = FakeClock()
            eng = cls(model, now=clock, **EVICT)
            rids = [eng.submit(p, max_new_tokens=10, eos_token_id=7) for p in prompts[:3]]
            rids.append(eng.submit(prompts[3], max_new_tokens=4, deadline=dl(ttft_s=0.05)))
            steps = 0
            while eng._queue or eng._active:
                clock.t += 0.01 * (1 + steps % 3)
                eng.step()
                steps += 1
            summaries.append(eng.meter.summary())
            meters.append((eng.meter.tokens_out_total, eng.meter.evictions_total,
                           eng.meter.finished_total, eng.meter.shed_total, dict(eng.shed)))
        (js, ts), (jmeter, tmeter) = summaries, meters
        assert sorted(ts) == sorted(js)
        for key in js:
            if key != "wall_time":
                assert ts[key] == js[key], key
        assert tmeter == jmeter
        assert tmeter[1] >= 1 and tmeter[3] == 1

    def test_admission_refusals_match_reference(self, pair):
        jm, tm = pair
        for cls, model in ((JaxEngine, jm), (ServingEngine, tm)):
            eng = cls(model, max_queue=2, max_batch=2, page_tokens=4, num_pages=6,
                      max_pages_per_seq=8)
            eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3, rid=40)
            with pytest.raises(ValueError, match="already known"):
                eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3, rid=40)
            with pytest.raises(ValueError, match="budget"):
                eng.submit(np.arange(1, 30, dtype=np.int32), max_new_tokens=8)
            with pytest.raises(ValueError, match="pool"):
                eng.submit(np.arange(1, 25, dtype=np.int32), max_new_tokens=8)
            eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
            with pytest.raises(Overloaded if cls is ServingEngine else Exception,
                               match="queue full"):
                eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
            assert eng.meter.rejected_total == 1
            assert len(eng.run()) == 2

    def test_nan_scale_page_fails_loudly(self, pair):
        _, tm = pair
        eng = ServingEngine(tm, max_batch=2, page_tokens=8, num_pages=16,
                            max_pages_per_seq=4, kv_dtype="int8")
        rid = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=6)
        eng.step()                      # prefill + first decode step
        eng._arenas["ks"][0][eng.pool.table(rid)[0]] = float("nan")
        with pytest.raises(RuntimeError, match=r"non-finite.*kv_dtype=int8"):
            for _ in range(4):
                eng.step()

    def test_nan_fp8_arena_fails_loudly(self, pair):
        _, tm = pair
        eng = ServingEngine(tm, max_batch=2, page_tokens=8, num_pages=16,
                            max_pages_per_seq=4, kv_dtype="fp8")
        rid = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=6)
        eng.step()
        eng._arenas["k"][0][eng.pool.table(rid)[0]] = float("nan")
        with pytest.raises(RuntimeError, match=r"non-finite.*kv_dtype=fp8"):
            for _ in range(4):
                eng.step()

    # speculative decoding (A2) is ported: with it on, tp > 1 still raises
    @pytest.mark.parametrize("kw, item", [
        (dict(speculative=3, tp=2), "A6"), (dict(tp=2), "A6")], ids=["kw0-A2", "kw1-A6"])
    def test_unported_options_raise(self, pair, kw, item):
        with pytest.raises(NotImplementedError, match=item):
            ServingEngine(pair[1], **ENGINE, **kw)

    def test_unported_entry_points_raise(self, pair, monkeypatch):
        eng = ServingEngine(pair[1], **ENGINE)
        with pytest.raises(ValueError, match="donation lint"):
            ServingEngine(pair[1], lint=True, **ENGINE)
        with pytest.raises(NotImplementedError, match="A8"):
            eng.submit_prefilled(np.arange(1, 4), 1, [])
        with pytest.raises(NotImplementedError, match="A8"):
            eng.prefill_export(np.arange(1, 4))
        with pytest.raises(RuntimeError, match="journal-backed"):
            eng.recover()
        with pytest.raises(NotImplementedError, match="A7"):
            eng.run(watchdog_s=1.0)
        # speculative decoding (A2) is ported: the variable turns it on,
        # and tensor-parallel decode still raises under it
        monkeypatch.setenv("PADDLE_TPU_SPEC_K", "2")
        assert ServingEngine(pair[1], **ENGINE)._spec_width == 3
        monkeypatch.setenv("PADDLE_TPU_SERVE_TP", "2")
        with pytest.raises(NotImplementedError, match="A6"):
            ServingEngine(pair[1], **ENGINE)


class TestModelHelpers:
    def test_rope_at_positions_matches_rotate_half_apply(self):
        rng = np.random.default_rng(7)
        q = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
        k = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
        pos = np.array([[0, 1, 2, 3, 4], [9, 10, 11, 12, 13], [125, 126, 127, 128, 129]])
        cos, sin = _rope_tables(16, 128, 10000.0)
        pj = np.clip(pos, 0, 127)
        cs, sn = cos.numpy()[pj][:, :, None], sin.numpy()[pj][:, :, None]
        wq, wk = rotate_half_apply(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cs), jnp.asarray(sn))
        gq, gk = apply_rotary_at_positions(torch.from_numpy(q), torch.from_numpy(k), cos, sin,
                                           torch.as_tensor(pos, dtype=torch.int32))
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))

    def test_kv_cache_spec_matches_reference(self, pair):
        jm, tm = pair
        assert tm._kv_cache_spec() == tuple(jm._kv_cache_spec())
