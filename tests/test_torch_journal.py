"""The port's serving journal, crash recovery and scheduler against the JAX
package, on the CPU (the counterparts of ``test_serving_resilience.py``'s
``TestJournal``, ``TestJournalRecovery``, ``TestCircuitBreaker``,
``TestDeadlines``, ``TestDeferral``, ``TestIdleBackoff`` and
``TestSLOMeterBounded``).

- Journal units: the same records through both packages'
  ``ServingJournal`` fold to equal states (the wall-clock submit stamp
  aside), a journal written by either package folds in the other, and the
  two ``TokenSink`` files are byte-equal.
- Recovery on ``llama_tiny`` (2 layers, vocab 96, f32, the JAX model's
  weights carried across): an engine abandoned mid-stream and recovered
  into a fresh one gives the JAX engine's streams, with every token in the
  sink exactly once, in-process and across the packages (a journal the
  JAX engine wrote, recovered by the port's engine, and the reverse).
- The reference injects storage and step failures through its chaos seam
  (``faults.inject``), which waits for ROADMAP A7; here the same failures
  come through ``monkeypatch``: a storage open that fails N times, or an
  engine method that raises.  The reference's telemetry events and
  Prometheus gauges wait for A8; the counters they narrate are read from
  the meter instead.

Engine sizes are explicit: ``tests/conftest.py`` pins the serving
environment variables for the whole suite.
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.checkpoint import faults
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import Deadline as JaxDeadline
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import ServingJournal as JaxJournal
from paddle_tpu.serving import TokenSink as JaxTokenSink
from paddle_tpu.serving.engine import Request as JaxRequest

from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed.checkpoint import storage
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.serving import (CircuitBreaker, Deadline, Overloaded,
                                      ServingEngine, ServingJournal, SLOMeter,
                                      TokenSink)
from paddle_tpu_torch.serving.engine import Request

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

TINY = dict(num_hidden_layers=2, vocab_size=96, max_position_embeddings=128)
KW = dict(max_batch=2, page_tokens=8, num_pages=24, max_pages_per_seq=4)


class FakeClock:
    """Deterministic monotonic clock for deadline tests."""

    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


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


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _solo(model, prompt, max_new):
    ids, _ = model.generate(np.asarray(prompt)[None], max_new_tokens=max_new)
    return ids.numpy()[0]


def _flaky_writes(monkeypatch, times: int):
    """The next ``times`` file writes of the port's storage seam raise
    ``OSError`` (what the reference injects with ``faults.inject(op=
    "serve_journal", mode="error", times=...)``)."""
    left = {"n": int(times)}

    def flaky_open(path, mode="r", *a, **k):
        if "w" in mode and left["n"] > 0:
            left["n"] -= 1
            raise OSError("injected storage flake")
        return open(path, mode, *a, **k)

    monkeypatch.setattr(storage, "open", flaky_open, raising=False)
    return left


def _state(st):
    """A folded journal as plain data, the wall-clock submit stamps aside."""
    reqs = {rid: {k: v for k, v in rec.items() if k != "submit_wall"}
            for rid, rec in st.requests.items()}
    return dict(requests=reqs, delivered=st.delivered, finished=sorted(st.finished),
                shed=st.shed, open=st.open_rids(), truncated=st.truncated,
                segments=st.segments_read)


# ---------------------------------------------------------------------------
class TestJournal:
    def test_segments_fold_roundtrip(self, tmp_path):
        """The same records through both journals fold to one state, and
        each package folds the other's segments to it."""
        for name, (J, D) in {"jax": (JaxJournal, JaxDeadline),
                             "torch": (ServingJournal, Deadline)}.items():
            j = J(str(tmp_path / name))
            j.submit(0, [1, 2, 3], 4, None, None)
            j.flush()
            j.deliver(0, 0, 11)
            j.deliver(0, 1, 12)
            j.flush()
            j.finish(0)
            j.submit(1, [4, 5], 4, 2, D(ttft_s=2.0))
            j.shed(2, "ttft_expired")
            j.flush()
        states = [_state(J(str(tmp_path / d)).load_state())
                  for J in (JaxJournal, ServingJournal) for d in ("jax", "torch")]
        assert all(s == states[0] for s in states)
        st = ServingJournal(str(tmp_path / "torch")).load_state()
        assert st.delivered[0] == [11, 12] and 0 in st.finished
        assert st.requests[1]["deadline"]["ttft_s"] == 2.0
        assert st.shed[2] == "ttft_expired"
        assert st.open_rids() == [1] and not st.truncated
        assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "torch"))

    def test_corrupt_segment_stops_fold_at_boundary(self, tmp_path):
        states = []
        for J in (JaxJournal, ServingJournal):
            root = tmp_path / J.__module__.split(".")[0]
            j = J(str(root))
            j.submit(0, [1, 2], 4, None, None)
            j.deliver(0, 0, 9)
            j.flush()
            j.deliver(0, 1, 10)
            j.flush()
            segs = sorted(os.listdir(root))
            (root / segs[-1]).write_bytes(b'[{"t": "deliver", "rid"')  # torn
            st = ServingJournal(str(root)).load_state()
            assert st.truncated
            assert st.delivered[0] == [9], "the fold stops at the previous boundary"
            states.append(_state(st))
        assert states[0] == states[1]

    def test_submit_durable_unwind_preserves_other_pending(self, tmp_path, monkeypatch):
        """A failed submit flush drops exactly its own record: buffered
        deliver records survive the unwind (the JAX journal through the
        reference's injector, the port's through a flaky open)."""
        jj = JaxJournal(str(tmp_path / "jax"))
        jj.deliver(0, 0, 1)
        with faults.inject(op="serve_journal", mode="error", times=4):
            with pytest.raises(OSError):
                jj.submit_durable(1, [1, 2], 4, None, None)
            jj.flush()
        j = ServingJournal(str(tmp_path / "torch"))
        j.deliver(0, 0, 1)
        _flaky_writes(monkeypatch, 4)
        with pytest.raises(OSError):
            j.submit_durable(1, [1, 2], 4, None, None)
        assert j.pending == 1
        j.flush()
        st = ServingJournal(str(tmp_path / "torch")).load_state()
        assert 1 not in st.requests and st.delivered[0] == [1]
        assert _state(st) == _state(ServingJournal(str(tmp_path / "jax")).load_state())

    def test_token_sink_exactly_once_across_reopen(self, tmp_path):
        for Sink in (JaxTokenSink, TokenSink):
            path = str(tmp_path / f"{Sink.__module__.split('.')[0]}.jsonl")
            s1 = Sink(path)
            s1(0, 0, 5)
            s1(0, 1, 6)
            s1(1, 0, 7)
            s1(0, 1, 99)                    # duplicate: dropped, value ignored
            assert s1.dropped == 1
            s1.close()
            s2 = Sink(path)                 # restart: high-water marks reload
            s2(0, 1, 6)
            s2(0, 2, 8)
            with pytest.raises(ValueError, match="gap"):
                s2(1, 5, 0)
            s2.close()
            assert TokenSink.collect(path) == JaxTokenSink.collect(path) == {0: [5, 6, 8], 1: [7]}
        assert (tmp_path / "paddle_tpu.jsonl").read_bytes() == \
            (tmp_path / "paddle_tpu_torch.jsonl").read_bytes()

    def test_submit_flush_failure_leaves_no_phantom(self, model, tmp_path, monkeypatch):
        """An admission whose durability flush fails leaves no queue entry
        and no buffered record, and the engine keeps serving."""
        eng = ServingEngine(model, journal=str(tmp_path / "j"), **KW)
        _flaky_writes(monkeypatch, 4)
        with pytest.raises(OSError):
            eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3, rid=5)
        assert len(eng._queue) == 0 and eng.journal.pending == 0
        assert 5 not in eng.journal.load_state().requests
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
        assert list(eng.run()) == [rid]

    def test_quarantine_unshadows_later_segments(self, tmp_path):
        for J in (JaxJournal, ServingJournal):
            root = tmp_path / J.__module__.split(".")[0]
            j = J(str(root))
            j.submit(0, [1, 2], 8, None, None)
            j.flush()                                   # seg_0
            j.deliver(0, 0, 9)
            j.flush()                                   # seg_1
            j.deliver(0, 1, 10)
            j.flush()                                   # seg_2
            segs = sorted(p for p in os.listdir(root) if p.endswith(".json"))
            (root / segs[1]).write_bytes(b"garbage")    # seg_1 torn
            j2 = ServingJournal(str(root))
            st = j2.load_state()
            assert st.truncated and st.delivered[0] == []
            j2.deliver(0, 0, 9)
            j2.flush()
            st3 = J(str(root)).load_state()
            assert not st3.truncated and st3.delivered[0] == [9]
        assert sorted(os.listdir(tmp_path / "paddle_tpu")) == \
            sorted(os.listdir(tmp_path / "paddle_tpu_torch"))

    def test_journal_flush_flake_absorbed_by_step_loop(self, model, tmp_path, monkeypatch):
        """A segment write that fails through its retries is a step
        failure: the records stay buffered, the next step flushes them,
        nothing is lost or duplicated."""
        sink = TokenSink(str(tmp_path / "out.jsonl"))
        eng = ServingEngine(model, journal=str(tmp_path / "j"), on_token=sink, **KW)
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
        left = _flaky_writes(monkeypatch, 4)    # defeats one whole flush
        outs = eng.run()
        assert left["n"] == 0
        np.testing.assert_array_equal(outs[rid], _solo(model, np.arange(1, 6), 4))
        assert TokenSink.collect(sink.path)[rid] == list(outs[rid])
        st = eng.journal.load_state()
        assert st.delivered[rid] == list(outs[rid]) and rid in st.finished

    def test_ship_sees_each_segment_before_its_tokens(self, model, tmp_path):
        """``journal_ship(seq, data)`` receives every flushed segment, in
        order, before the sink sees a token the segment covers; a refused
        ship removes the local segment and keeps the records pending."""
        shipped, seen = [], []

        def ship(seq, data):
            shipped.append((seq, json.loads(data)))

        def sink(rid, idx, tok):
            covered = {(r["rid"], r["idx"]) for _, recs in shipped for r in recs
                       if r["t"] == "deliver"}
            assert (rid, idx) in covered
            seen.append(tok)

        eng = ServingEngine(model, journal=str(tmp_path / "j"), journal_ship=ship,
                            on_token=sink, **KW)
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
        outs = eng.run()
        assert seen == list(outs[rid])
        assert [s for s, _ in shipped] == list(range(len(shipped)))
        j = ServingJournal(str(tmp_path / "k"), ship=lambda s, d: 1 / 0)
        j.deliver(0, 0, 1)
        with pytest.raises(ZeroDivisionError):
            j.flush()
        assert j.pending == 1 and j.segments() == []


# ---------------------------------------------------------------------------
def _crash_and_recover(writer, reader, prompts, jdir, spath, steps=2, max_new=6):
    """``writer()`` makes the first engine (given its journal dir and sink);
    it serves ``steps`` steps and is abandoned mid-stream; ``reader()``
    makes a fresh engine on the same journal that recovers and runs.
    Returns (rids, recover info, outputs, sink streams)."""
    w_eng, w_sink = writer(jdir, spath)
    rids = [w_eng.submit(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(steps):
        w_eng.step()
    before = TokenSink.collect(spath)
    assert before, "some tokens must be out before the crash"
    assert not w_eng._results, "nothing should have finished yet"
    w_sink.close()                  # the process dies here
    r_eng, r_sink = reader(jdir, spath)
    info = r_eng.recover()
    outs = r_eng.run()
    r_sink.close()
    r_eng.pool.check_leaks()
    return rids, info, outs, TokenSink.collect(spath)   # raises on a duplicate


def _maker(cls, sink_cls, model):
    def make(jdir, spath):
        sink = sink_cls(spath)
        return cls(model, journal=jdir, on_token=sink, **KW), sink
    return make


class TestJournalRecovery:
    def _prompts(self):
        rng = np.random.default_rng(11)
        return [rng.integers(1, 96, n).astype(np.int32) for n in (5, 9, 7)]

    def _want(self, jm, prompts):
        eng = JaxEngine(jm, **KW)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        outs = eng.run()
        return [list(outs[r]) for r in rids]

    def test_in_process_replay_exactly_once(self, pair, tmp_path):
        """An engine abandoned mid-stream, recovered into a fresh one:
        every request completes with the JAX engine's stream (crashed and
        recovered the same way, and uninterrupted), every token in the sink
        exactly once."""
        jm, tm = pair
        prompts = self._prompts()
        want = self._want(jm, prompts)
        runs = {}
        for name, cls, sink, m in (("jax", JaxEngine, JaxTokenSink, jm),
                                   ("torch", ServingEngine, TokenSink, tm)):
            make = _maker(cls, sink, m)
            runs[name] = _crash_and_recover(make, make, prompts, str(tmp_path / name / "j"),
                                            str(tmp_path / f"{name}.jsonl"))
        for name, (rids, info, outs, streams) in runs.items():
            assert info["replayed"] == 3 and info["finished"] == 0, name
            for w, rid in zip(want, rids):
                assert list(outs[rid]) == w and streams[rid] == w, (name, rid)
        assert (tmp_path / "jax.jsonl").read_text().count("\n") == \
            (tmp_path / "torch.jsonl").read_text().count("\n") == 18

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_journal_recovers_across_packages(self, pair, tmp_path, writer):
        """A journal the JAX engine wrote, recovered by the port's engine,
        gives the JAX engine's uninterrupted streams; and the reverse."""
        jm, tm = pair
        prompts = self._prompts()
        want = self._want(jm, prompts)
        engines = {"jax": _maker(JaxEngine, JaxTokenSink, jm),
                   "torch": _maker(ServingEngine, TokenSink, tm)}
        reader = "torch" if writer == "jax" else "jax"
        rids, info, outs, streams = _crash_and_recover(
            engines[writer], engines[reader], prompts, str(tmp_path / "j"),
            str(tmp_path / "out.jsonl"))
        assert info["replayed"] == 3
        for w, rid in zip(want, rids):
            assert list(outs[rid]) == w and streams[rid] == w, rid

    def test_final_step_flush_failure_retried_before_exit(self, model, tmp_path, monkeypatch):
        """A flush that fails on the step retiring the LAST request is
        retried by run() before it declares quiescence."""
        sink = TokenSink(str(tmp_path / "out.jsonl"))
        eng = ServingEngine(model, journal=str(tmp_path / "j"), on_token=sink, **KW)
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
        _flaky_writes(monkeypatch, 4)
        outs = eng.run()
        assert list(outs[rid])
        assert TokenSink.collect(sink.path)[rid] == list(outs[rid])
        st = eng.journal.load_state()
        assert rid in st.finished and st.delivered[rid] == list(outs[rid])

    def test_replayed_deadline_keeps_aging_across_crash(self, pair, tmp_path):
        """A total_s budget that ran out while the process was down sheds
        at recovery (the journal's wall-clock stamp ages the request), in
        both packages; each recovers the other's journal the same way."""
        jm, tm = pair
        for name, cls, m, D in (("jax", JaxEngine, jm, JaxDeadline),
                                ("torch", ServingEngine, tm, Deadline)):
            jdir = str(tmp_path / name)
            rid = cls(m, journal=jdir, **KW).submit(
                np.arange(1, 6, dtype=np.int32), max_new_tokens=4,
                deadline=D(total_s=30.0))
            seg = sorted((tmp_path / name).glob("seg_*.json"))[0]
            doc = json.loads(seg.read_text())
            doc[0]["submit_wall"] -= 100.0       # the outage, 100 s long
            seg.write_text(json.dumps(doc))
            for reader, rm in ((ServingEngine, tm), (JaxEngine, jm)):
                copy = shutil.copytree(jdir, tmp_path / f"{name}-{reader.__module__}")
                eng = reader(rm, journal=str(copy), **KW)
                assert eng.recover()["replayed"] == 1
                assert rid not in eng.run()
                assert eng.shed[rid] == "total_expired"

    def test_recover_restores_finished_and_shed(self, pair, tmp_path):
        jm, tm = pair
        runs = {}
        for name, cls, m, D in (("jax", JaxEngine, jm, JaxDeadline),
                                ("torch", ServingEngine, tm, Deadline)):
            jdir = str(tmp_path / name)
            clock = FakeClock()
            eng1 = cls(m, journal=jdir, now=clock, **KW)
            r_done = eng1.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
            r_shed = eng1.submit(np.arange(1, 8, dtype=np.int32), max_new_tokens=2,
                                 deadline=D(ttft_s=1.0))
            clock.advance(5.0)              # r_shed's budget dies in the queue
            outs1 = eng1.run()
            assert r_done in outs1 and r_shed in eng1.shed
            eng2 = ServingEngine(tm, journal=jdir, **KW)
            info = eng2.recover()
            assert info["replayed"] == 0
            assert sorted(info["known_rids"]) == sorted([r_done, r_shed])
            np.testing.assert_array_equal(eng2._results[r_done], outs1[r_done])
            assert eng2.shed[r_shed] == "ttft_expired"
            runs[name] = (list(outs1[r_done]), info["finished"], info["shed"])
        assert runs["torch"] == runs["jax"]

    def test_recover_needs_a_journal_and_writes_the_report(self, model, tmp_path,
                                                           monkeypatch):
        with pytest.raises(RuntimeError, match="journal"):
            ServingEngine(model, **KW).recover()
        jdir = str(tmp_path / "j")
        ServingEngine(model, journal=jdir, **KW).submit(np.arange(1, 6), max_new_tokens=2)
        monkeypatch.setenv("PADDLE_TPU_RESUME_REPORT", str(tmp_path / "resume"))
        eng = ServingEngine(model, journal=jdir, **KW)
        assert eng.recover()["replayed"] == 1
        assert json.loads((tmp_path / "resume.0").read_text()) == \
            {"rank": 0, "source": "journal", "replayed": 1}
        eng.run()


# ---------------------------------------------------------------------------
class _Crash(Exception):
    """The process dying (what the reference's injector raises as
    ``InjectedCrash``): never absorbed by the step loop."""


def _failing(monkeypatch, eng, name, exc, times):
    """Make ``eng.<name>`` raise ``exc`` on its next ``times`` calls
    (all of them for ``times`` < 0) before doing its work."""
    real, left = getattr(eng, name), {"n": times}

    def wrapped(*a, **k):
        if left["n"] != 0:
            left["n"] -= 1
            raise exc
        return real(*a, **k)

    monkeypatch.setattr(eng, name, wrapped)
    return left


class TestCircuitBreaker:
    def test_state_machine(self):
        clock = FakeClock()
        br = CircuitBreaker(threshold=2, cooldown_s=1.0, now=clock)
        assert br.allow() and br.state == "closed"
        br.note_failure()
        assert br.state == "closed" and br.allow()
        br.note_failure()
        assert br.state == "open" and not br.allow()
        assert br.retry_after_s() == pytest.approx(1.0)
        clock.advance(0.5)
        assert not br.allow()
        clock.advance(0.6)
        assert br.allow() and br.state == "half_open"
        br.note_failure()
        assert br.state == "open"
        clock.advance(1.1)
        assert br.allow()
        br.note_success()
        assert br.state == "closed" and br.open_count == 2

    def test_step_failures_open_breaker_and_pause_admission(self, model, monkeypatch):
        eng = ServingEngine(model, **KW)
        eng.admission.breaker = CircuitBreaker(threshold=3, cooldown_s=60.0)
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
        left = _failing(monkeypatch, eng, "_decode_step", OSError("flake"), 3)
        for _ in range(3):          # prefill ok; 3 decode steps flake
            eng.step()
        assert left["n"] == 0 and eng.admission.breaker.state == "open"
        with pytest.raises(Overloaded) as ei:
            eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
        assert ei.value.reason == "breaker_open"
        eng.step()                  # a successful step closes the breaker
        assert eng.admission.breaker.state == "closed"
        rid2 = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
        outs = eng.run()
        np.testing.assert_array_equal(outs[rid], _solo(model, np.arange(1, 6), 4))
        assert rid2 in outs
        eng.pool.check_leaks()

    def test_injected_crash_propagates(self, model, monkeypatch):
        eng = ServingEngine(model, **KW)
        eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
        _failing(monkeypatch, eng, "_prefill", _Crash(), 1)
        with pytest.raises(_Crash):
            eng.run()

    def test_persistent_failure_eventually_raises(self, model, monkeypatch):
        eng = ServingEngine(model, **KW)
        eng._max_step_failures = 3
        eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
        _failing(monkeypatch, eng, "_prefill", OSError("down"), -1)
        with pytest.raises(OSError, match="down"):
            eng.run()
        assert eng.admission.breaker.state == "open"


# ---------------------------------------------------------------------------
class TestDeadlines:
    def _engine(self, model, clock, **kw):
        return ServingEngine(model, now=clock, **dict(KW, **kw))

    def test_expired_ttft_is_shed_not_served(self, model):
        clock = FakeClock()
        eng = self._engine(model, clock)
        rid_dead = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3,
                              deadline=Deadline(ttft_s=1.0))
        rid_ok = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=3)
        clock.advance(2.0)
        outs = eng.run()
        assert rid_dead not in outs and eng.shed[rid_dead] == "ttft_expired"
        assert rid_ok in outs and len(outs[rid_ok]) == 3
        assert eng.meter.shed_total == 1
        assert eng.meter.shed_reasons == {"ttft_expired": 1}
        eng.pool.check_leaks()

    def test_expired_total_is_shed(self, model):
        clock = FakeClock()
        eng = self._engine(model, clock)
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3,
                         deadline=Deadline(total_s=5.0))
        clock.advance(6.0)
        eng.run()
        assert eng.shed[rid] == "total_expired"

    def test_unreachable_ttft_shed_predictively(self, model):
        clock = FakeClock()
        eng = self._engine(model, clock)
        eng.meter._ft_window.append(5.0)    # measured: prefill takes ~5 s
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3,
                         deadline=Deadline(ttft_s=8.0))
        clock.advance(4.0)                  # 4 s left < the 5 s estimate
        eng.run()
        assert eng.shed[rid] == "ttft_unreachable"

    def test_met_deadline_not_shed_and_miss_rate_zero(self, model):
        clock = FakeClock()
        eng = self._engine(model, clock)
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3,
                         deadline=Deadline(ttft_s=60.0, total_s=600.0))
        outs = eng.run()
        np.testing.assert_array_equal(outs[rid], _solo(model, np.arange(1, 6), 3))
        assert eng.shed == {}
        assert eng.meter.summary()["deadline_miss_rate"] == 0.0

    def test_active_request_finishing_late_counts_miss(self, model):
        clock = FakeClock()
        eng = self._engine(model, clock)
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3,
                         deadline=Deadline(total_s=1.0))
        eng.step()                  # admitted and prefilled in time
        clock.advance(5.0)          # ... but decode drags past total_s
        outs = eng.run()
        assert rid in outs
        assert eng.meter.summary()["deadline_miss_rate"] == 1.0
        assert eng.meter.deadline_misses_total == 1
        eng.pool.check_leaks()

    def test_slo_aware_preemption_evicts_most_slack(self, model):
        """With deadlines the victim is the request with the MOST slack,
        even when it is the oldest admission."""
        clock = FakeClock()
        eng = self._engine(model, clock, page_tokens=4, num_pages=6, max_pages_per_seq=6)
        victims = []
        evict = eng._evict
        eng._evict = lambda v: (victims.append(v.rid), evict(v))
        rng = np.random.default_rng(3)
        p_old = rng.integers(1, 96, 5).astype(np.int32)
        p_young = rng.integers(1, 96, 5).astype(np.int32)
        r_old = eng.submit(p_old, max_new_tokens=8, deadline=Deadline(total_s=500.0))
        eng.step()
        clock.advance(1.0)
        r_young = eng.submit(p_young, max_new_tokens=8, deadline=Deadline(total_s=30.0))
        outs = eng.run()
        assert victims and victims[0] == r_old
        np.testing.assert_array_equal(outs[r_old], _solo(model, p_old, 8))
        np.testing.assert_array_equal(outs[r_young], _solo(model, p_young, 8))
        eng.pool.check_leaks()


# ---------------------------------------------------------------------------
class TestDeferral:
    def test_long_head_deferred_under_pool_pressure(self, model):
        eng = ServingEngine(model, max_batch=3, page_tokens=4, num_pages=6, max_pages_per_seq=6)
        rng = np.random.default_rng(5)
        p_busy = rng.integers(1, 96, 9).astype(np.int32)    # 3 pages
        p_long = rng.integers(1, 96, 11).astype(np.int32)   # 3 pages
        p_short = rng.integers(1, 96, 5).astype(np.int32)   # 2 pages
        r_busy = eng.submit(p_busy, max_new_tokens=3)
        eng.step()                  # busy admitted: 2 pages free
        r_long = eng.submit(p_long, max_new_tokens=2)
        r_short = eng.submit(p_short, max_new_tokens=6)
        eng.step()
        active = {r.rid for r in eng._active.values()}
        assert r_short in active and r_long not in active
        assert eng.meter.defers_total >= 1 and eng._queue[0].defers >= 1
        outs = eng.run()
        for p, rid in ((p_busy, r_busy), (p_long, r_long), (p_short, r_short)):
            np.testing.assert_array_equal(outs[rid], _solo(model, p, len(outs[rid])),
                                          err_msg=f"rid {rid}")
        eng.pool.check_leaks()

    def test_defer_budget_restores_fifo(self, model):
        eng = ServingEngine(model, max_batch=3, page_tokens=4, num_pages=6, max_pages_per_seq=6)
        eng._defer_max = 1
        rng = np.random.default_rng(6)
        r_busy = eng.submit(rng.integers(1, 96, 9).astype(np.int32), max_new_tokens=8)
        eng.step()
        r_long = eng.submit(rng.integers(1, 96, 11).astype(np.int32), max_new_tokens=2)
        r_s1 = eng.submit(rng.integers(1, 96, 5).astype(np.int32), max_new_tokens=2)
        r_s2 = eng.submit(rng.integers(1, 96, 5).astype(np.int32), max_new_tokens=2)
        eng.step()                  # bypass 1 admits s1
        active = {r.rid for r in eng._active.values()}
        assert r_s1 in active or r_s1 in eng._results
        assert eng._queue[0].rid == r_long and eng._queue[0].defers == 1
        eng.step()                  # budget spent: s2 must NOT bypass
        active = {r.rid for r in eng._active.values()}
        assert r_s2 not in active and r_s2 not in eng._results
        outs = eng.run()
        assert sorted(outs) == sorted([r_busy, r_long, r_s1, r_s2])
        eng.pool.check_leaks()


# ---------------------------------------------------------------------------
class TestIdleBackoff:
    def test_idle_engine_does_not_spin(self, model):
        eng = ServingEngine(model, **KW)
        t = threading.Thread(target=eng.serve_forever, daemon=True)
        t.start()
        time.sleep(0.3)
        assert eng.steps_total == 0, "an idle engine must not step"
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
        deadline = time.time() + 60
        while rid not in eng._results and time.time() < deadline:
            time.sleep(0.02)
        assert rid in eng._results
        s0 = eng.steps_total
        assert s0 > 0
        time.sleep(0.3)             # drained: the counter stays flat
        assert eng.steps_total == s0
        eng.stop()
        t.join(timeout=10)
        assert not t.is_alive()
        eng.pool.check_leaks()

    def test_forever_mode_not_killed_by_quiesce_guard(self, model):
        eng = ServingEngine(model, **KW)
        t = threading.Thread(target=lambda: eng.run(forever=True, max_steps=2), daemon=True)
        t.start()
        rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=6)
        deadline = time.time() + 60
        while rid not in eng._results and time.time() < deadline:
            time.sleep(0.02)
        assert rid in eng._results and len(eng._results[rid]) == 6
        eng.stop()
        t.join(timeout=10)
        assert not t.is_alive()


class TestSLOMeterBounded:
    def test_memory_bounded_and_clocks_dropped(self):
        clock = FakeClock()
        m = SLOMeter(now=clock, window=8)
        for rid in range(50):
            m.submit(rid)
            m.admit(rid, queue_depth=0, pages=1)
            m.first_token(rid)
            clock.advance(0.01)
            m.finish(rid, n_tokens=4)
        assert len(m._window) == 8 and len(m._ft_window) <= 8
        assert m._clocks == {}, "finished clocks must be dropped"
        s = m.summary()
        assert s["requests_finished"] == 50 and s["ttft_ms_p99"] is not None

    def test_shed_drops_clock_and_counts(self):
        m = SLOMeter(window=8)
        m.submit("a")
        m.shed("a", reason="ttft_expired")
        assert m._clocks == {} and m.shed_total == 1
        assert m.summary()["shed_reasons"] == {"ttft_expired": 1}
