"""In-memory peer-replicated snapshots of the port (ROADMAP A7a), from the
reference's ``tests/test_snapshot.py``: the double-buffered capture, the
cadence and kill switch, restore with reshard; the ``SnapshotStore`` TCP
depot and the KV fallback over a ``TCPStore``; the replicator loading
standalone; the resume ladder (own RAM, depot copy, peer replica, disk);
and the ``TrainStep(snapshotter=)`` hook, its restored weights held
against the JAX package's ``TrainStep`` on the same weights and batches.
The cases that need the elastic supervisor, the gang, the rewind ledger or
``FileStore`` wait for ROADMAP A7b (listed there).  A depot's socket waits
carry their own time limits (the clients' ``timeout``).
"""

import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed.checkpoint import (Snapshotter, faults, mark_local_shard,
                                                     save_state_dict)
from paddle_tpu_torch.distributed.checkpoint.replicator import (KVTransport, SnapshotClient,
                                                                SnapshotStore)
from paddle_tpu_torch.distributed.checkpoint.snapshot import (SnapshotRestoreError,
                                                              _restore_into, resume)
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import SGD

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPLICATOR_PY = os.path.join(REPO, "paddle_tpu_torch", "distributed", "checkpoint",
                             "replicator.py")
STORE_PY = os.path.join(REPO, "paddle_tpu_torch", "distributed", "store.py")


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")
    yield
    faults.reset()
    ptt.set_device(None)


def _tensor_state(vals, step):
    return {"acc": torch.tensor(np.asarray(vals, np.float32)), "step": torch.tensor(step)}


def _zero_state(n=4):
    return _tensor_state(np.zeros(n, np.float32), 0)


@pytest.fixture
def depot():
    store = SnapshotStore()
    yield store
    store.close()


def _client(depot):
    return SnapshotClient("127.0.0.1", depot.port, timeout=10.0)


def _snapper(vals, step, *, rank=0, world=1, transport=None, every=2):
    return Snapshotter(lambda: _tensor_state(vals, step), rank=rank, world_size=world,
                       every=every, transport=transport, sync=True)


class TestCapture:
    def test_capture_restore_round_trip(self):
        s = _snapper([1, 2, 3, 4], 6)
        assert s.snapshot_now(6)
        tgt = _zero_state()
        assert s.restore_own(tgt) == 6
        assert (tgt["acc"].numpy() == [1, 2, 3, 4]).all() and int(tgt["step"]) == 6

    def test_capture_is_a_copy(self):
        """The optimizers update in place: a capture holds the values at
        the trigger, not the tensor."""
        acc = torch.ones(4)
        s = Snapshotter(lambda: {"acc": acc}, every=1, transport=None, sync=True)
        assert s.snapshot_now(1)
        acc.add_(5.0)
        tgt = {"acc": torch.zeros(4)}
        s.restore_own(tgt)
        assert (tgt["acc"] == 1.0).all()

    def test_double_buffer_survives_injected_capture_crash(self):
        box = {"v": [1.0, 1.0, 1.0, 1.0]}
        s = Snapshotter(lambda: _tensor_state(box["v"], 2), every=2, transport=None,
                        sync=True)
        assert s.snapshot_now(2)
        box["v"] = [9.0, 9.0, 9.0, 9.0]
        with faults.inject(op="snap", pattern="capture_*", mode="crash"):
            assert not s.snapshot_now(4)
        assert s.capture_failures == 1
        tgt = _zero_state()
        assert s.restore_own(tgt) == 2 and (tgt["acc"].numpy() == 1.0).all()
        assert s.snapshot_now(4) and s.latest_step() == 4

    def test_on_step_cadence_and_kill_switch(self, monkeypatch):
        s = _snapper([0, 0, 0, 0], 0, every=3)
        assert [st for st in range(1, 10) if s.on_step(st)] == [3, 6, 9] and s.captures == 3
        monkeypatch.setenv("PADDLE_TPU_SNAP", "0")
        s2 = _snapper([0, 0, 0, 0], 0, every=1)
        assert not s2.on_step(1) and s2.captures == 0

    def test_restore_reshards_onto_a_block(self):
        """A whole capture restored into a process's block (a column
        half), and a block the capture does not cover raises."""
        src = torch.arange(16, dtype=torch.float32).reshape(4, 4)
        s = Snapshotter(lambda: {"w": src}, every=1, transport=None, sync=True)
        assert s.snapshot_now(1)
        half = mark_local_shard(torch.zeros(4, 2), (0, 2), (4, 4))
        assert s.restore_own({"w": half}) == 1
        assert torch.equal(half, src[:, 2:])
        part = Snapshotter(lambda: {"w": mark_local_shard(src[:2].clone(), (0, 0), (4, 4))},
                           every=1, transport=None, sync=True)
        part.snapshot_now(1)
        with pytest.raises(SnapshotRestoreError, match="do not cover"):
            part.restore_own({"w": torch.zeros(4, 4)})

    def test_bf16_state_restores_bit_equal(self):
        w = torch.randn(3, 5).to(torch.bfloat16)
        s = Snapshotter(lambda: {"w": w}, every=1, transport=None, sync=True)
        s.snapshot_now(1)
        tgt = {"w": torch.zeros(3, 5, dtype=torch.bfloat16)}
        s.restore_own(tgt)
        assert torch.equal(tgt["w"], w)

    def test_restore_missing_key_raises(self):
        s = _snapper([1, 1, 1, 1], 3)
        s.snapshot_now(3)
        with pytest.raises(SnapshotRestoreError):
            _restore_into({"other": torch.zeros(4)}, s.latest())

    def test_invalidate_clears_buffers(self):
        s = _snapper([1, 1, 1, 1], 3)
        s.snapshot_now(3)
        s.invalidate()
        assert s.latest() is None and s.restore_own(_zero_state()) is None

    def test_ship_in_flight_skips_instead_of_stalling(self):
        class SlowTransport:
            def __init__(self):
                self.gate = threading.Event()
                self.puts = 0

            def put(self, *a, **kw):
                self.puts += 1
                self.gate.wait(10)

        tr = SlowTransport()
        s = Snapshotter(lambda: _tensor_state([1, 1, 1, 1], 1), every=1, transport=tr,
                        sync=False, world_size=1)
        assert s.snapshot_now(1)
        t0 = time.time()
        assert not s.snapshot_now(2)
        assert time.time() - t0 < 1.0 and s.ship_skips == 1
        tr.gate.set()
        s.wait(10)
        assert tr.puts == 1

    def test_persistent_ship_failure_disables_replication(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_SNAP_MAX_SHIP_FAILURES", "2")

        class DeadTransport:
            def put(self, *a, **kw):
                raise OSError("depot gone")

        s = Snapshotter(lambda: _tensor_state([1, 1, 1, 1], 1), every=1,
                        transport=DeadTransport(), sync=True)
        assert s.snapshot_now(1) and s.snapshot_now(2)
        assert s.ship_failures == 2 and s._replication_dead
        assert s.snapshot_now(3) and s.ship_failures == 2 and s.latest_step() == 3


class TestSnapshotStoreTransport:
    def test_put_fetch_prefers_own_copy(self, depot):
        c = _client(depot)
        c.put(0, 0, 4, 4, b"primary")
        c.put(0, 1, 4, 4, b"replica")
        meta, payload = c.fetch(0)
        assert payload == b"primary" and meta["holder"] == 0
        assert c.drop_holder(0) == 1
        meta, payload = c.fetch(0)
        assert payload == b"replica" and meta["holder"] == 1

    def test_put_replicated_one_wire_transfer_fills_both_slots(self, depot):
        c = _client(depot)
        c.put_replicated(2, [2, 0], 6, 6, b"blob")
        assert {(e["src"], e["holder"]) for e in c.index()} == {(2, 2), (2, 0)}
        meta, payload = c.fetch(2)
        assert payload == b"blob" and meta["holder"] == 2

    def test_corrupt_copy_falls_over_to_next_holder(self, depot):
        c = _client(depot)
        c.put_replicated(0, [0, 1], 4, 4, b"payload")
        with depot._lock:
            depot._copies[(0, 0, 4)] = dict(depot._copies[(0, 0, 4)], payload=b"corrupt!")
        meta, payload = c.fetch(0, gen=4)
        assert payload == b"payload" and meta["holder"] == 1
        with depot._lock:
            depot._copies[(0, 1, 4)] = dict(depot._copies[(0, 1, 4)], payload=b"corrupt!")
        assert c.fetch(0, gen=4) is None

    def test_crc_rejected_on_ingest(self, depot):
        c = _client(depot)
        with pytest.raises(OSError):
            c.put(0, 0, 2, 2, b"payload", crc=123)
        assert c.fetch(0) is None

    def test_complete_generations_exclude_torn(self, depot):
        c = _client(depot)
        for rank in range(3):
            c.put(rank, rank, 10, 10, b"g10")
        c.put(0, 0, 20, 20, b"g20")
        c.put(1, 1, 20, 20, b"g20")
        assert [g["gen"] for g in c.complete_generations(3)] == [10]
        c.put(2, 2, 20, 30, b"g20-late")
        assert [g["gen"] for g in c.complete_generations(3)] == [10]

    def test_retention_keeps_two_generations(self, depot):
        c = _client(depot)
        for gen in (2, 4, 6):
            c.put(0, 0, gen, gen, b"x%d" % gen)
        assert sorted({e["gen"] for e in c.index()}) == [4, 6]

    def test_max_step_and_resume_reports(self, depot):
        c = _client(depot)
        assert c.max_step() is None
        c.put(0, 0, 8, 8, b"x")
        assert c.max_step() == 8
        c.report_resume(0, 2, "peer", 8, 1)
        c.report_resume(1, 2, "memory", 8, 1)
        reps = c.resume_reports(2)
        assert reps[0]["source"] == "peer" and reps[1]["source"] == "memory"
        assert c.resume_reports(3) == {}

    def test_shipped_snapshot_restores_from_the_depot(self, depot):
        """A Snapshotter ships through the depot; a fresh process's resume
        finds the copy there (rung 2) and checks its fingerprints."""
        c = _client(depot)
        s = _snapper([4, 3, 2, 1], 8, transport=c, every=1)
        assert s.snapshot_now(8)
        tgt = _zero_state()
        info = resume(tgt, None, transport=c, rank=0, world_size=1, ledger=None)
        assert info.source == "memory" and info.step == 8
        assert (tgt["acc"].numpy() == [4, 3, 2, 1]).all()


class TestKVFallbackTransport:
    @pytest.fixture
    def kv(self):
        master = TCPStore("127.0.0.1", 0, is_master=True, world_size=1, timeout=20.0)
        yield master
        master.close()

    def test_protocol_round_trip(self, kv):
        t = KVTransport(kv)
        t.put(0, 0, 4, 4, b"own")
        t.put(0, 1, 4, 4, b"rep")
        t.put(1, 1, 4, 4, b"r1")
        meta, payload = t.fetch(0)
        assert payload == b"own" and meta["holder"] == 0
        assert [g["gen"] for g in t.complete_generations(2)] == [4]
        assert t.max_step() == 4
        assert t.drop_holder(0) == 1
        meta, payload = t.fetch(0)
        assert payload == b"rep" and meta["holder"] == 1
        t.report_resume(1, 1, "disk", 0, 4)
        assert t.resume_reports(1)[1]["source"] == "disk"

    def test_kv_retention(self, kv):
        t = KVTransport(kv)
        for gen in (2, 4, 6):
            t.put(0, 0, gen, gen, b"x")
        assert sorted(t._copy_gens(0, 0)) == [4, 6]


_STANDALONE = textwrap.dedent("""
    import importlib.util, sys

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        m = importlib.util.module_from_spec(spec)
        sys.modules[name] = m
        spec.loader.exec_module(m)
        return m

    rep = load("pt_rep", sys.argv[1])
    store_mod = load("pt_store", sys.argv[2])
    assert "torch" not in sys.modules and "jax" not in sys.modules
    depot = rep.SnapshotStore()
    c = rep.SnapshotClient("127.0.0.1", depot.port, timeout=10.0)
    c.put(0, 0, 6, 6, b"alpha")
    c.put(0, 1, 6, 6, b"alpha")
    meta, payload = c.fetch(0)
    assert payload == b"alpha" and meta["step"] == 6
    assert c.complete_generations(1)[0]["gen"] == 6
    kv_master = store_mod.TCPStore("127.0.0.1", 0, is_master=True, world_size=1,
                                   timeout=10.0)
    t = rep.KVTransport(kv_master)
    t.put(1, 1, 2, 2, b"beta")
    meta, payload = t.fetch(1)
    assert payload == b"beta" and meta["gen"] == 2 and t.max_step() == 2
    assert "torch" not in sys.modules and "jax" not in sys.modules
    print("STANDALONE_OK", flush=True)
""")


def test_replicator_loads_standalone(tmp_path):
    """The replicator and the store load by path, without the package:
    chaos children stay light."""
    script = tmp_path / "standalone.py"
    script.write_text(_STANDALONE)
    out = subprocess.run([sys.executable, str(script), REPLICATOR_PY, STORE_PY],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "STANDALONE_OK" in out.stdout


class TestResumeLadder:
    def _seed_gen(self, client, world, step, vals_of):
        for rank in range(world):
            snap = {"shards": {"acc": [((0,), np.asarray(vals_of(rank), np.float32))],
                               "step": [((), np.asarray(step, np.int64))]},
                    "shapes": {"acc": ((4,), "float32"), "step": ((), "int64")},
                    "step": step, "gen": step, "rank": rank}
            payload = pickle.dumps(snap)
            client.put(rank, rank, step, step, payload)
            client.put(rank, (rank + 1) % world, step, step, payload)

    def test_peer_replica_after_holder_drop(self, depot):
        c = _client(depot)
        self._seed_gen(c, 4, 10, lambda r: [r] * 4)
        c.drop_holder(2)
        tgt = _zero_state()
        info = resume(tgt, None, transport=c, rank=2, world_size=4, ledger=None)
        assert info.source == "peer" and info.step == 10
        assert (tgt["acc"].numpy() == 2.0).all()
        info1 = resume(_zero_state(), None, transport=c, rank=1, world_size=4, ledger=None)
        assert info1.source == "memory" and info1.step == 10

    def test_disk_fallback_with_unrecoverable_event(self, depot, tmp_path):
        rec = telemetry.get_flight_recorder()
        since = time.perf_counter_ns()
        c = _client(depot)
        self._seed_gen(c, 2, 10, lambda r: [r] * 4)
        c.drop_holder(0)
        c.drop_holder(1)
        save_state_dict(_tensor_state([7, 7, 7, 7], 6), os.path.join(str(tmp_path), "step_6"))
        tgt = _zero_state()
        info = resume(tgt, str(tmp_path), transport=c, rank=0, world_size=2, ledger=None,
                      step_key="step")
        assert info.source == "disk" and info.step == 6
        assert (tgt["acc"].numpy() == 7.0).all()
        kinds = [e["kind"] for e in rec.events(since_mono_ns=since)]
        assert "snapshot_unrecoverable" in kinds

    def test_own_ram_must_match_agreed_generation(self, depot):
        c = _client(depot)
        self._seed_gen(c, 2, 10, lambda r: [3] * 4)
        s = _snapper([5, 5, 5, 5], 12, rank=0, world=2, transport=c)
        s.snapshot_now(12)
        tgt = _zero_state()
        info = resume(tgt, None, snapshotter=s, transport=c, rank=0, world_size=2,
                      ledger=None)
        assert info.source == "memory" and info.step == 10
        assert (tgt["acc"].numpy() == 3.0).all() and info.steps_lost == 2

    def test_nothing_anywhere_reports_none(self, tmp_path):
        assert resume(_zero_state(), str(tmp_path), transport=None,
                      ledger=None).source == "none"


class TestTrainStepHook:
    def _pair(self):
        paddle.seed(0)
        jm = jnn.Linear(4, 4)
        tm = tnn.Linear(4, 4)
        load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
        return jm, tm

    def test_cadence_and_restore(self):
        """Snapshots every 4 steps; steps 5-6 move the weights on; the
        restore gives step 4's weights, which equal the JAX package's
        TrainStep at step 4."""
        jm, model = self._pair()
        opt = SGD(0.1, parameters=model.parameters())
        snap = Snapshotter(lambda: {"model": model.state_dict()}, every=4, transport=None,
                           sync=True)
        step = TrainStep(model, lambda m, x, y: ((m(x) - y) ** 2).mean(), opt,
                         snapshotter=snap)
        jstep = paddle.jit.TrainStep(jm, lambda m, x, y: ((m(x) - y) ** 2).mean(),
                                     paddle.optimizer.SGD(0.1, parameters=jm.parameters()))
        rng = np.random.default_rng(0)
        batches = [(rng.standard_normal((2, 4)).astype("f4"),
                    rng.standard_normal((2, 4)).astype("f4")) for _ in range(6)]
        for x, y in batches[:4]:
            step(torch.from_numpy(x), torch.from_numpy(y))
            jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        assert snap.captures == 1 and snap.latest_step() == 4
        w4 = model.weight.detach().clone()
        np.testing.assert_allclose(w4.numpy(), np.asarray(jm.weight.numpy()),
                                   rtol=2e-5, atol=1e-6)
        for x, y in batches[4:]:
            step(torch.from_numpy(x), torch.from_numpy(y))
        assert snap.captures == 1 and not torch.equal(model.weight, w4)
        assert snap.restore_own({"model": model.state_dict()}) == 4
        assert torch.equal(model.weight.detach(), w4)

    def test_attach_detach(self):
        _, model = self._pair()
        opt = SGD(0.1, parameters=model.parameters())
        step = TrainStep(model, lambda m, x, y: ((m(x) - y) ** 2).mean(), opt)
        snap = Snapshotter(lambda: {"model": model.state_dict()}, every=1, transport=None,
                           sync=True)
        step.attach_snapshotter(snap)
        x, y = torch.ones(2, 4), torch.ones(2, 4)
        step(x, y)
        assert snap.captures == 1
        step.attach_snapshotter(None)
        step(x, y)
        assert snap.captures == 1

    def test_a_failed_capture_never_stops_the_step(self):
        _, model = self._pair()
        opt = SGD(0.1, parameters=model.parameters())

        def broken():
            raise RuntimeError("no state")

        snap = Snapshotter(broken, every=1, transport=None, sync=True)
        step = TrainStep(model, lambda m, x, y: ((m(x) - y) ** 2).mean(), opt,
                         snapshotter=snap)
        step(torch.ones(2, 4), torch.ones(2, 4))
        assert snap.capture_failures == 1 and opt._step_count == 1
