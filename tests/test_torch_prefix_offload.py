"""The port's prefix cache and host-RAM KV offload against the JAX package,
on the CPU (the counterparts of ``test_disagg.py``'s ``TestCOWPool``,
``TestPrefixCache`` and ``TestPrefixEngine`` and ``test_longctx.py``'s
``TestOffloadPool``, ``TestParkPlan`` and ``TestOffloadEngine``).

- The units, case for case: each case runs once through the JAX
  package's ``PagedKVPool``/``PrefixCache``/``OffloadPool`` and once
  through the port's, asserts the reference test's expectations on both,
  and asserts the two runs equal (tables, refcounts, matches, counters,
  frames).
- The engines on ``llama_tiny`` (2 layers, vocab 96, f32, the JAX model's
  weights carried across), the same prompts from a numpy seed: token
  streams equal to the JAX engine's with the same options, and equal
  prefix and offload counters; prefix hits also equal the port's own
  engine without a cache, and offload runs the port's engine with room for
  every request.

Engine sizes are explicit: ``tests/conftest.py`` pins the serving
environment variables for the whole suite.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import OffloadPool as JaxOffloadPool
from paddle_tpu.serving import PagedKVPool as JaxPool
from paddle_tpu.serving import PrefixCache as JaxPrefixCache
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import TRASH_PAGE as JAX_TRASH_PAGE
from paddle_tpu.serving import PoolExhausted as JaxPoolExhausted
from paddle_tpu.serving import default_offload_pages as jax_default_offload_pages
from paddle_tpu.serving.engine import Request as JaxRequest

from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.serving import (OffloadPool, PagedKVPool, PoolExhausted,
                                      PrefixCache, ServingEngine, TRASH_PAGE,
                                      default_offload_pages)
from paddle_tpu_torch.serving.engine import Request

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

TINY = dict(num_hidden_layers=2, vocab_size=96, max_position_embeddings=128)
KW = dict(max_batch=3, page_tokens=8, num_pages=32, max_pages_per_seq=6)
OFFLOAD_KW = dict(max_batch=2, page_tokens=8, num_pages=9, max_pages_per_seq=8)

# one namespace per package: the unit cases run on both
PKGS = {
    "jax": dict(Pool=JaxPool, Prefix=JaxPrefixCache, Offload=JaxOffloadPool,
                Exhausted=JaxPoolExhausted, trash=JAX_TRASH_PAGE,
                offload_pages=jax_default_offload_pages,
                frame=lambda fill: {k: np.full((2, 8, 2, 4), fill, np.float32)
                                    for k in ("k", "v")}),
    "torch": dict(Pool=PagedKVPool, Prefix=PrefixCache, Offload=OffloadPool,
                  Exhausted=PoolExhausted, trash=TRASH_PAGE,
                  offload_pages=default_offload_pages,
                  frame=lambda fill: {k: torch.full((2, 8, 2, 4), fill)
                                      for k in ("k", "v")}),
}


def _both(case, **kw):
    """Run ``case(ns, **kw)`` on each package; the runs must agree."""
    got = {name: case(ns, **kw) for name, ns in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


@pytest.fixture(autouse=True)
def _request_ids():
    """Both packages number requests from a class counter; keep the
    counters as they were for later tests of the same process."""
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
    return jm, tm.eval()


def _serve_phases(engine, phases, max_new):
    """Serve each list of prompts of ``phases`` to completion in turn;
    returns the outputs in prompt order."""
    outs = []
    for prompts in phases:
        rids = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
        res = engine.run()
        outs += [res[r] for r in rids]
    return outs


# ---------------------------------------------------------------------------
# copy-on-write page refcounts
# ---------------------------------------------------------------------------
class TestCOWPool:
    def test_alloc_takes_one_ref_free_drops_it(self):
        def case(ns):
            pool = ns["Pool"](num_pages=8, page_tokens=4)
            pages = pool.alloc("a", 3)
            assert all(pool.refcount(p) == 1 for p in pages)
            assert pool.shared_pages() == 0
            assert pool.free("a") == 3
            assert all(pool.refcount(p) == 0 for p in pages)
            pool.check_leaks()
            return pages
        _both(case)

    def test_adopt_shares_and_survives_first_free(self):
        def case(ns):
            pool = ns["Pool"](num_pages=8, page_tokens=4)
            pages = pool.alloc("a", 2)
            assert pool.adopt("b", pages) == pages
            assert all(pool.refcount(p) == 2 for p in pages)
            assert pool.shared_pages() == 2
            assert pool.free("a") == 0
            assert pool.pages_used == 2
            assert pool.free("b") == 2
            pool.check_leaks()
            return pages, pool.pages_free
        _both(case)

    def test_double_free_of_shared_page_raises(self):
        def case(ns):
            pool = ns["Pool"](num_pages=8, page_tokens=4)
            [p] = pool.alloc("a", 1)
            pool.incref([p])
            pool.free("a")
            assert pool.decref([p]) == 1
            with pytest.raises(KeyError):
                pool.decref([p])
            pool.check_leaks()
            return p
        _both(case)

    def test_trash_page_never_refcounted(self):
        def case(ns):
            pool = ns["Pool"](num_pages=8, page_tokens=4)
            assert pool.refcount(ns["trash"]) == 0
            for op in (pool.incref, pool.decref, lambda ps: pool.adopt("a", ps)):
                with pytest.raises(ValueError):
                    op([ns["trash"]])
            pool.check_leaks()
            return ns["trash"]
        _both(case)

    def test_incref_of_free_page_raises(self):
        def case(ns):
            pool = ns["Pool"](num_pages=8, page_tokens=4)
            with pytest.raises(KeyError):
                pool.incref([3])
            with pytest.raises(KeyError):
                pool.adopt("a", [3])
            pool.check_leaks()
            return pool.pages_free
        _both(case)

    def test_leak_check_counts_shared_pages_once(self):
        def case(ns):
            pool = ns["Pool"](num_pages=8, page_tokens=4)
            pages = pool.alloc("a", 3)
            pool.adopt("b", pages)
            pool.adopt("c", pages[:1])
            for rid in ("a", "b", "c"):
                pool.free(rid)
            pool.check_leaks()
            [p] = pool.alloc("r", 1)
            pool.incref([p])
            pool.free("r")
            with pytest.raises(AssertionError):
                pool.check_leaks()
            pool.check_leaks(allow_shared=True)
            pool.decref([p])
            pool.check_leaks()
            return pages, p
        _both(case)

    def test_evicted_request_pages_stay_while_trie_holds(self):
        def case(ns):
            pool = ns["Pool"](num_pages=4, page_tokens=4)
            pages = pool.alloc("victim", 2)
            pool.incref(pages)
            assert pool.free("victim") == 0
            got = pool.alloc("next", 1)
            assert set(got).isdisjoint(pages)
            pool.free("next")
            assert pool.decref(pages) == 2
            pool.check_leaks()
            return pages, got
        _both(case)


# ---------------------------------------------------------------------------
# the prefix trie
# ---------------------------------------------------------------------------
class TestPrefixCache:
    def test_match_never_covers_the_last_token(self):
        def case(ns):
            pool = ns["Pool"](num_pages=16, page_tokens=4)
            pc = ns["Prefix"](pool, max_pages=8)
            prompt = list(range(1, 9))
            table = pool.alloc("a", 2)
            assert pc.insert(prompt, table) == 2
            m1 = pc.match(prompt)
            assert len(m1[0]) == 1 and m1[1] == 4
            m2 = pc.match(prompt + [9])
            assert len(m2[0]) == 2 and m2[1] == 8
            assert pc.match([5, 6, 7, 8]) == ([], 0)
            pool.free("a")
            pc.clear()
            pool.check_leaks()
            return m1, m2
        _both(case)

    def test_insert_skips_partial_tail_page(self):
        def case(ns):
            pool = ns["Pool"](num_pages=16, page_tokens=4)
            pc = ns["Prefix"](pool, max_pages=8)
            table = pool.alloc("a", 3)
            assert pc.insert(list(range(1, 11)), table) == 2
            assert pool.refcount(table[2]) == 1
            pool.free("a")
            assert pool.refcount(table[0]) == 1
            pc.clear()
            pool.check_leaks()
            return table
        _both(case)

    def test_lru_evicts_leaves_only(self):
        def case(ns):
            pool = ns["Pool"](num_pages=16, page_tokens=2)
            pc = ns["Prefix"](pool, max_pages=2)
            t_a = pool.alloc("a", 2)
            pc.insert([1, 2, 3, 4], t_a)
            t_b = pool.alloc("b", 1)
            pc.insert([9, 9], t_b)
            assert pc.pages_held() == 2 and pc.pages_evicted == 1
            assert pc.match([1, 2, 9]) == ([t_a[0]], 2)
            assert pool.refcount(t_a[1]) == 1
            pool.free("a")
            pool.free("b")
            pc.clear()
            pool.check_leaks()
            return t_a, t_b, pc.summary()
        _both(case)

    def test_clear_releases_every_trie_ref(self):
        def case(ns):
            pool = ns["Pool"](num_pages=16, page_tokens=2)
            pc = ns["Prefix"](pool, max_pages=8)
            t = pool.alloc("a", 3)
            pc.insert([1, 2, 3, 4, 5, 6], t)
            pool.free("a")
            assert pc.clear() == 3
            assert pc.pages_held() == 0
            pool.check_leaks()
            return t
        _both(case)

    def test_note_drives_hit_rate_not_match(self):
        def case(ns):
            pc = ns["Prefix"](ns["Pool"](num_pages=16, page_tokens=4), max_pages=8)
            pc.match([1, 2, 3, 4, 5])
            assert (pc.hits, pc.misses) == (0, 0)
            pc.note(False)
            pc.note(True, n_tokens=8)
            assert (pc.hits, pc.misses) == (1, 1)
            assert pc.hit_rate() == 0.5 and pc.tokens_saved == 8
            return pc.summary()
        _both(case)

    def test_budget_from_env(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_PREFIX_PAGES", "5")
        assert _both(lambda ns: ns["Prefix"](ns["Pool"](8, 4)).max_pages) == 5


# ---------------------------------------------------------------------------
# the host tier
# ---------------------------------------------------------------------------
def _np(frame):
    return {k: np.asarray(v) for k, v in frame.items()} if frame is not None else None


class TestOffloadPool:
    def test_stage_publish_atomicity(self):
        def case(ns):
            op = ns["Offload"](max_pages=4)
            op.stage("a", 0, ns["frame"](1.0))
            assert not op.holds("a", 0) and op.frames_held() == 0
            assert op.get("a", 0) is None
            assert op.publish() == []
            assert op.holds("a", 0) and op.frames_held() == 1
            with pytest.raises(RuntimeError, match="no staged frame"):
                op.publish()
            return op.summary()
        _both(case)

    def test_lru_drop_returns_owner(self):
        def case(ns):
            op = ns["Offload"](max_pages=2)
            drops = [op.put(r, 0, ns["frame"](1.0)) for r in "abc"]
            assert drops == [[], [], [("a", 0)]]
            assert op.pages_dropped == 1 and op.frames_held() == 2
            assert not op.holds("a", 0) and op.holds("b", 0) and op.holds("c", 0)
            return drops
        _both(case)

    def test_touch_rescues_near_recall_frames(self):
        def case(ns):
            op = ns["Offload"](max_pages=2)
            op.put("a", 0, ns["frame"](1.0))
            op.put("b", 0, ns["frame"](1.0))
            assert op.touch("a") == 1
            assert op.put("c", 0, ns["frame"](1.0)) == [("b", 0)]
            assert op.holds("a", 0)
            return op.summary()
        _both(case)

    def test_get_pops_and_prices_recall(self):
        def case(ns):
            op = ns["Offload"](max_pages=4)
            fr = ns["frame"](2.0)
            nbytes = sum(int(v.nbytes) for v in fr.values())
            op.put("a", 1, fr)
            assert op.bytes_out == nbytes and op.pages_out == 1
            got = op.get("a", 1)
            np.testing.assert_array_equal(np.asarray(got["k"]), np.asarray(fr["k"]))
            assert op.pages_in == 1 and op.bytes_in == nbytes
            assert op.get("a", 1) is None and op.frames_held() == 0
            return _np(got), op.summary()
        got = {name: case(ns) for name, ns in PKGS.items()}
        for key in ("k", "v"):
            np.testing.assert_array_equal(got["torch"][0][key], got["jax"][0][key])
        assert got["torch"][1] == got["jax"][1]

    def test_drop_discards_every_frame_of_owner(self):
        def case(ns):
            op = ns["Offload"](max_pages=8)
            op.put("a", 0, ns["frame"](1.0))
            op.put("a", 1, ns["frame"](1.0))
            op.put("b", 0, ns["frame"](1.0))
            assert op.drop("a") == 2
            assert op.frames_held() == 1 and op.holds("b", 0)
            return op.summary()
        _both(case)

    def test_budget_from_env(self, monkeypatch):
        assert _both(lambda ns: ns["offload_pages"]()) == 16      # the conftest pin
        monkeypatch.setenv("PADDLE_TPU_KV_OFFLOAD_PAGES", "3")
        assert _both(lambda ns: ns["Offload"]().max_pages) == 3


# ---------------------------------------------------------------------------
# parking: swap_out / swap_in, shared pages never copy
# ---------------------------------------------------------------------------
class TestParkPlan:
    def test_private_pages_free_and_refill(self):
        def case(ns):
            pool = ns["Pool"](num_pages=8, page_tokens=8)
            pool.alloc("a", 3)
            assert pool.swap_out("a") == [None, None, None]
            assert pool.pages_free == 7 and pool.is_parked("a")
            assert pool.parked_plan("a") == [None, None, None]
            table, refill = pool.swap_in("a")
            assert [j for j, _ in refill] == [0, 1, 2]
            assert pool.table("a") == table and len(table) == 3
            pool.free("a")
            pool.check_leaks()
            return table, refill
        _both(case)

    def test_shared_page_retains_ref_never_copies(self):
        def case(ns):
            pool = ns["Pool"](num_pages=8, page_tokens=8)
            pages = pool.alloc("a", 2)
            pool.incref(pages)
            assert pool.swap_out("a") == pages
            assert all(pool.refcount(p) == 2 for p in pages)
            table, refill = pool.swap_in("a")
            assert table == pages and refill == []
            pool.free("a")
            assert pool.decref(pages) == 2
            pool.check_leaks()
            return pages
        _both(case)

    def test_swap_in_all_or_nothing(self):
        def case(ns):
            pool = ns["Pool"](num_pages=4, page_tokens=8)
            pool.alloc("a", 3)
            pool.swap_out("a")
            pool.alloc("b", 2)
            with pytest.raises(ns["Exhausted"]):
                pool.swap_in("a")
            assert pool.is_parked("a")
            pool.free("b")
            _, refill = pool.swap_in("a")
            assert len(refill) == 3
            pool.free("a")
            pool.check_leaks()
            return refill
        _both(case)

    def test_drop_parked_releases_shared_refs(self):
        def case(ns):
            pool = ns["Pool"](num_pages=8, page_tokens=8)
            pages = pool.alloc("a", 2)
            pool.incref(pages)
            pool.swap_out("a")
            assert pool.drop_parked("a") == 0
            assert all(pool.refcount(p) == 1 for p in pages)
            assert pool.decref(pages) == 2
            pool.check_leaks()
            return pages
        _both(case)

    def test_park_bookkeeping_is_loud(self):
        def case(ns):
            pool = ns["Pool"](num_pages=4, page_tokens=8)
            pool.alloc("a", 1)
            pool.swap_out("a")
            with pytest.raises(AssertionError, match="parked"):
                pool.check_leaks()
            with pytest.raises(KeyError):
                pool.swap_out("a")
            with pytest.raises(KeyError):
                pool.swap_in("missing")
            with pytest.raises(KeyError):
                pool.drop_parked("missing")
            pool.drop_parked("a")
            pool.check_leaks()
            return pool.pages_free
        _both(case)


# ---------------------------------------------------------------------------
# the engines, JAX against the port
# ---------------------------------------------------------------------------
class TestPrefixEngine:
    @pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
    def test_hits_are_token_exact_vs_reprefill_oracle(self, pair, kv_dtype):
        """Requests sharing a system prompt hit the cache; their streams
        equal the JAX engine's with a cache and the port's without one."""
        jm, tm = pair
        rng = np.random.default_rng(0)
        sys_prompt = list(rng.integers(1, 96, 17))
        prompts = [np.asarray(sys_prompt + list(rng.integers(1, 96, n)), np.int32)
                   for n in (6, 9, 4)]
        phases = [prompts[:1], prompts[1:]]
        je = JaxEngine(jm, prefix_cache=True, kv_dtype=kv_dtype, **KW)
        te = ServingEngine(tm, prefix_cache=True, kv_dtype=kv_dtype, **KW)
        want, got = _serve_phases(je, phases, 5), _serve_phases(te, phases, 5)
        oracle = _serve_phases(ServingEngine(tm, kv_dtype=kv_dtype, **KW), [prompts], 5)
        for g, w, o in zip(got, want, oracle):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, o)
        s = te.prefix.summary()
        assert s == je.prefix.summary()
        assert s["hits"] == 2 and s["misses"] == 1
        assert s["tokens_saved"] >= 2 * (len(sys_prompt) // te.page_tokens) * 8
        te.pool.check_leaks(allow_shared=True)
        te.prefix.clear()
        te.pool.check_leaks()

    def test_eviction_interplay_token_exact_no_leaks(self, pair):
        """Preemption under pool pressure composes with the trie's pins:
        streams equal the JAX engine's and the cacheless engine's, and the
        only references left at quiesce are the trie's."""
        jm, tm = pair
        rng = np.random.default_rng(2)
        shared = list(rng.integers(1, 96, 9))
        prompts = [np.asarray(shared + list(rng.integers(1, 96, n)), np.int32)
                   for n in (5, 7, 3)]
        phases = [prompts[:1], prompts[1:]]
        kw = dict(max_batch=3, page_tokens=4, num_pages=12, max_pages_per_seq=8,
                  prefix_cache=16)
        je, te = JaxEngine(jm, **kw), ServingEngine(tm, **kw)
        want, got = _serve_phases(je, phases, 12), _serve_phases(te, phases, 12)
        assert te.meter.summary()["evictions"] >= 1
        assert te.meter.evictions_total == je.meter.evictions_total
        assert te.prefix.summary() == je.prefix.summary()
        roomy = dict(kw, num_pages=32, prefix_cache=None)
        oracle = _serve_phases(ServingEngine(tm, **roomy), [prompts], 12)
        for g, w, o in zip(got, want, oracle):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, o)
        te.pool.check_leaks(allow_shared=True)
        te.prefix.clear()
        te.pool.check_leaks()

    def test_options_and_env(self, pair, monkeypatch):
        _, tm = pair
        assert ServingEngine(tm, **KW).prefix is None
        assert ServingEngine(tm, prefix_cache=5, **KW).prefix.max_pages == 5
        own = ServingEngine(tm, **KW)
        pc = PrefixCache(own.pool, max_pages=3)
        assert ServingEngine(tm, prefix_cache=pc, **KW).prefix is pc
        monkeypatch.setenv("PADDLE_TPU_PREFIX_CACHE", "1")
        e = ServingEngine(tm, **KW)
        assert isinstance(e.prefix, PrefixCache) and e.prefix.max_pages == 8  # conftest pin
        assert ServingEngine(tm, prefix_cache=False, **KW).prefix is None


def _page_bytes(eng, pages):
    """Host copies of ``pages`` across every layer and plane, one dict a
    page, as numpy arrays."""
    if isinstance(eng, JaxEngine):
        return [{k: np.asarray(v) for k, v in eng._export_page(p).items()} for p in pages]
    return [{k: v.numpy().copy() for k, v in f.items()} for f in eng._export_pages(pages)]


def _watch_first_victim(eng):
    """Record the first offload victim's pages before its swap-out and
    after its first recall."""
    snap = {}
    offload, recall = eng._offload, eng._recall

    def _offload(victim):
        if not snap:
            snap["rid"] = victim.rid
            snap["rid_order"] = sorted(r.rid for r in eng._active.values()).index(victim.rid)
            snap["before"] = _page_bytes(eng, eng.pool.table(victim.rid))
        offload(victim)

    def _recall(r, rows):
        out = recall(r, rows)
        if out == "recalled" and r.rid == snap.get("rid") and "after" not in snap:
            snap["after"] = _page_bytes(eng, eng.pool.table(r.rid))
        return out

    eng._offload, eng._recall = _offload, _recall
    return snap


def _offload_prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, 20).astype(np.int32) for _ in range(2)]


class TestOffloadEngine:
    @pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
    def test_offload_recall_token_exact_zero_recompute(self, pair, kv_dtype):
        """Two 20-token prompts admit (3 pages each of 8) and outgrow the
        pool at 20 new tokens: preemption swaps through the host tier and
        recalls with nothing replayed.  Streams equal the JAX engine's and
        those of the port's engine with room for both; the offload counters
        and bytes equal the JAX engine's."""
        jm, tm = pair
        prompts = _offload_prompts(7)
        je = JaxEngine(jm, offload=True, kv_dtype=kv_dtype, **OFFLOAD_KW)
        te = ServingEngine(tm, offload=True, kv_dtype=kv_dtype, **OFFLOAD_KW)
        want, got = _serve_phases(je, [prompts], 20), _serve_phases(te, [prompts], 20)
        roomy = ServingEngine(tm, kv_dtype=kv_dtype, **dict(OFFLOAD_KW, num_pages=32))
        for g, w, o in zip(got, want, _serve_phases(roomy, [prompts], 20)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, o)
        s, js = te.meter.summary(), je.meter.summary()
        keys = ("kv_offloads", "kv_recalls", "kv_offload_stalls", "kv_offload_bytes_out",
                "kv_recall_bytes_in", "kv_recall_bytes_per_token", "evictions")
        assert {k: s[k] for k in keys} == {k: js[k] for k in keys}
        assert s["kv_offloads"] >= 1 and s["kv_recalls"] >= 1
        assert s["kv_offload_stalls"] == 0 and s["evictions"] == 0
        assert s["kv_recall_bytes_per_token"] > 0 and s["kv_offload_bytes_out"] > 0
        assert te.offload.frames_held() == 0
        assert te.offload.summary() == je.offload.summary()
        te.pool.check_leaks()

    def test_lru_drop_downgrades_to_replay_token_exact(self, pair):
        """A 2-frame tier cannot hold one victim's 3 spilled pages: its own
        frames drop, and its recall becomes a re-prefill (an offload
        stall), still token-exact to the JAX engine."""
        jm, tm = pair
        prompts = _offload_prompts(8)
        je = JaxEngine(jm, offload=JaxOffloadPool(max_pages=2), **OFFLOAD_KW)
        te = ServingEngine(tm, offload=OffloadPool(max_pages=2), **OFFLOAD_KW)
        want, got = _serve_phases(je, [prompts], 20), _serve_phases(te, [prompts], 20)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        s = te.meter.summary()
        assert s["kv_offloads"] >= 1 and s["kv_offload_stalls"] >= 1
        assert te.offload.pages_dropped >= 1
        assert te.offload.summary() == je.offload.summary()
        assert s["evictions"] == je.meter.summary()["evictions"]
        te.pool.check_leaks()

    def test_pages_restore_bit_for_bit(self, pair):
        """The first victim's pages after its recall hold the bytes they
        held before its swap-out (every layer and plane, int8 scales
        included), in both packages; and the port's bytes are the JAX
        engine's (int8 values within one step of the quantizer, whose f32
        inputs differ in the last bits between the packages)."""
        jm, tm = pair
        prompts = _offload_prompts(7)
        snaps = {}
        for name, eng in (("jax", JaxEngine(jm, offload=True, kv_dtype="int8", **OFFLOAD_KW)),
                          ("torch", ServingEngine(tm, offload=True, kv_dtype="int8",
                                                  **OFFLOAD_KW))):
            snaps[name] = _watch_first_victim(eng)
            _serve_phases(eng, [prompts], 20)
        (jb, ja), (tb, ta) = ([snaps[n][k] for k in ("before", "after")] for n in ("jax", "torch"))
        assert snaps["torch"]["rid_order"] == snaps["jax"]["rid_order"]
        assert len(tb) == len(jb) >= 3
        for before, after, ref, ref_after in zip(tb, ta, jb, ja):
            assert sorted(before) == sorted(ref) == ["k", "ks", "v", "vs"]
            for key in before:
                assert before[key].shape == ref[key].shape == (2, 8, 2, 16)[:5 - len(key)]
                np.testing.assert_array_equal(after[key], before[key], err_msg=key)
                np.testing.assert_array_equal(ref_after[key], ref[key], err_msg=key)
                np.testing.assert_allclose(before[key].astype(np.float32),
                                           ref[key].astype(np.float32), rtol=0,
                                           atol=1 if key in ("k", "v") else 1e-6)

    def test_options_and_env(self, pair, monkeypatch):
        _, tm = pair
        assert ServingEngine(tm, **KW).offload is None
        assert ServingEngine(tm, offload=4, **KW).offload.max_pages == 4
        op = OffloadPool(max_pages=3)
        assert ServingEngine(tm, offload=op, **KW).offload is op
        monkeypatch.setenv("PADDLE_TPU_KV_OFFLOAD", "1")
        e = ServingEngine(tm, **KW)
        assert isinstance(e.offload, OffloadPool) and e.offload.max_pages == 16  # conftest pin
        assert ServingEngine(tm, offload=False, **KW).offload is None
