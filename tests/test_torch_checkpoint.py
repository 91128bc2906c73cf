"""The distributed checkpoint of the port (ROADMAP A7a) against the JAX
package's: the reference's ``tests/test_dist_checkpoint.py`` (save under one
placement, load under another, on a single-controller mesh of 8 CPU
members; the ZeRO training state from dp 2 x sharding 4 at stage 3 onto dp 4
x sharding 2 at stage 2, the next loss against the JAX package's), the
chaos suite of ``tests/test_checkpoint_faults.py`` (commit protocol, a crash
mid-save, corruption, retries, async failures surfaced, the seeded
injector, the rotation's recovery, latest / GC, the preemption guard), a
committed checkpoint crossing the packages both ways (f32, and bf16 where
``ml_dtypes`` is installed), equal fingerprints, the asynchronous save
against an in-place update, and blocks of a tensor saved by two gloo
processes and loaded under another split.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed.health import sdc as jsdc
from paddle_tpu.distributed import topology as jtopo

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.distributed.auto_parallel import (ProcessMesh, Replicate, Shard,
                                                        shard_tensor)
from paddle_tpu_torch.distributed.checkpoint import (AsyncSaveError,
                                                     CheckpointCorruptionError,
                                                     CheckpointError, faults,
                                                     gc_checkpoints, is_committed,
                                                     latest_checkpoint, load_state_dict,
                                                     mark_local_shard, save_state_dict)
from paddle_tpu_torch.distributed.checkpoint.commit import COMMITTED_MARKER
from paddle_tpu_torch.distributed.checkpoint.save_state_dict import _wait_pending
from paddle_tpu_torch.distributed.fleet.elastic import ELASTIC_EXIT_CODE, PreemptionGuard
from paddle_tpu_torch.distributed.health import sdc

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    ptt.set_device("cpu")
    yield
    faults.reset()
    jck.faults.reset()
    jtopo.set_hybrid_communicate_group(None)
    topology.set_hybrid_communicate_group(None)
    ptt.set_device(None)


def _mesh(shape, names):
    return ProcessMesh(np.arange(8).reshape(shape), dim_names=list(names),
                       devices=["cpu"] * 8)


def _sharded(src, mesh_shape=(8,), names="x", spec=None):
    return shard_tensor(src, _mesh(mesh_shape, names), spec or [Shard(0), Replicate()])


def _src(seed=0, shape=(16, 8)):
    return np.random.default_rng(seed).standard_normal(shape).astype("float32")


# ---------------------------------------------------------------------------
# tests/test_dist_checkpoint.py
# ---------------------------------------------------------------------------
class TestRoundTrip:
    def test_same_sharding_roundtrip(self, tmp_path):
        src = np.arange(64, dtype="float32").reshape(16, 4)
        save_state_dict({"w": _sharded(src)}, str(tmp_path / "ck"))
        dst = _sharded(np.zeros_like(src))
        load_state_dict({"w": dst}, str(tmp_path / "ck"))
        np.testing.assert_array_equal(dst.numpy(), src)

    def test_nested_and_scalar_leaves(self, tmp_path):
        src = _src(0, (8, 8))
        save_state_dict({"model": {"w": _sharded(src)}, "opt": {"step": torch.tensor(7)}},
                        str(tmp_path / "ck"))
        dst = _sharded(np.zeros_like(src), spec=[Replicate(), Shard(1)])
        step = torch.tensor(0)
        load_state_dict({"model": {"w": dst}, "opt": {"step": step}}, str(tmp_path / "ck"))
        np.testing.assert_array_equal(dst.numpy(), src)
        assert int(step) == 7

    def test_async_save_then_load(self, tmp_path):
        src = _src(4, (16, 4))
        save_state_dict({"w": _sharded(src)}, str(tmp_path / "ck"), async_save=True)
        dst = _sharded(np.zeros_like(src), spec=[Replicate(), Replicate()])
        load_state_dict({"w": dst}, str(tmp_path / "ck"))   # waits for the writer
        np.testing.assert_array_equal(dst.numpy(), src)

    def test_missing_key_raises(self, tmp_path):
        t = _sharded(np.ones((8, 2), "float32"))
        save_state_dict({"a": t}, str(tmp_path / "ck"))
        with pytest.raises(KeyError):
            load_state_dict({"b": t}, str(tmp_path / "ck"))


class TestReshardOnLoad:
    @pytest.mark.parametrize("save_spec,load_spec", [
        ([Shard(0), Shard(1)], [Shard(1), Shard(0)]),
        ([Shard(0), Replicate()], [Replicate(), Shard(1)]),
        ([Replicate(), Replicate()], [Shard(0), Shard(1)]),
    ])
    def test_mesh_change_2d(self, tmp_path, save_spec, load_spec):
        src = _src(1, (16, 8))
        save_state_dict({"w": _sharded(src, (4, 2), ("a", "b"), save_spec)},
                        str(tmp_path / "ck"))
        dst = _sharded(np.zeros_like(src), (2, 4), ("c", "d"), load_spec)
        load_state_dict({"w": dst}, str(tmp_path / "ck"))
        np.testing.assert_array_equal(dst.numpy(), src)

    def test_dp2mp2_to_dp4(self, tmp_path):
        src = _src(2, (8, 16))
        save_state_dict({"w": _sharded(src, (2, 2, 2), ("dp", "mp", "extra"),
                                       [Shard(0), Shard(1)])}, str(tmp_path / "ck"))
        dst = _sharded(np.zeros_like(src), (8,), ("dp",), [Replicate(), Shard(0)])
        load_state_dict({"w": dst}, str(tmp_path / "ck"))
        np.testing.assert_array_equal(dst.numpy(), src)


def _zero_run(package, degrees, stage, X, Y, weights=None, devices=True):
    """A ZeRO ``DistributedTrainStep`` of the reference's small model under
    ``degrees`` (fleet.init), its weights from ``weights`` when given."""
    s = package.fleet.DistributedStrategy()
    s.hybrid_configs = degrees
    if devices:
        package.fleet.init(is_collective=True, strategy=s, devices=["cpu"] * 8)
    else:
        package.fleet.init(is_collective=True, strategy=s)
    hcg = package.get_hybrid_communicate_group()
    nn_, F_ = (tnn, F) if package is dist else (jnn, JF)
    paddle.seed(11)
    m = nn_.Sequential(nn_.Linear(16, 32), nn_.GELU(), nn_.Linear(32, 16))
    if weights is not None:
        load_numpy_state_dict(m, weights)
    opt_mod = ptt.optimizer if package is dist else paddle.optimizer
    o = opt_mod.AdamW(1e-2, parameters=m.parameters())
    step = package.DistributedTrainStep(m, lambda mm, a, b: F_.mse_loss(mm(a), b), o, hcg,
                                        sharding_stage=stage)
    return m, o, step


class TestTrainingStateRoundTrip:
    def test_model_and_optimizer_reshard(self, tmp_path):
        """ZeRO-3 parameters and moments of dp 2 x sharding 4 round-trip onto
        dp 4 x sharding 2 at stage 2; the next loss equals the uninterrupted
        run's, and the JAX package's on the same weights and batches."""
        X = _src(30, (16, 16))
        Y = X * 0.5
        jm, _, jstep = _zero_run(jdist, {"dp_degree": 2, "sharding_degree": 4}, 3,
                                 X, Y, devices=False)
        weights = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        m1, o1, step1 = _zero_run(dist, {"dp_degree": 2, "sharding_degree": 4}, 3, X, Y,
                                  weights)
        Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
        for _ in range(3):
            step1(Xt, Yt)
            jstep(paddle.to_tensor(X), paddle.to_tensor(Y))
        save_state_dict({"model": m1.state_dict(), "opt": o1.state_dict()},
                        str(tmp_path / "ck"))
        ref_next = float(step1(Xt, Yt))
        np.testing.assert_allclose(ref_next, float(jstep(paddle.to_tensor(X),
                                                         paddle.to_tensor(Y))), rtol=1e-4)
        m2, o2, step2 = _zero_run(dist, {"dp_degree": 4, "sharding_degree": 2}, 2, X, Y,
                                  weights)
        step2(Xt, Yt)          # states on the new layout
        target = {"model": m2.state_dict(), "opt": o2.state_dict()}
        load_state_dict(target, str(tmp_path / "ck"))
        m2.set_state_dict(target["model"])
        o2.set_state_dict(target["opt"])
        np.testing.assert_allclose(float(step2(Xt, Yt)), ref_next, rtol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_checkpoint_faults.py
# ---------------------------------------------------------------------------
class TestCommitProtocol:
    def test_committed_layout(self, tmp_path):
        path = str(tmp_path / "step_1")
        save_state_dict({"w": _sharded(_src())}, path)
        assert is_committed(path)
        names = sorted(os.listdir(path))
        assert COMMITTED_MARKER in names and "metadata" in names and "rank_0.distcp" in names
        assert not os.path.exists(path + ".staging")
        marker = json.load(open(os.path.join(path, COMMITTED_MARKER)))
        assert "rank_0.distcp" in marker["files"] and marker["committed_at"] <= time.time()

    def test_resave_same_path_overwrites_atomically(self, tmp_path):
        path = str(tmp_path / "ck")
        a, b = _src(1), _src(2)
        save_state_dict({"w": _sharded(a)}, path)
        save_state_dict({"w": _sharded(b)}, path)
        dst = _sharded(np.zeros_like(b))
        load_state_dict({"w": dst}, path)
        np.testing.assert_array_equal(dst.numpy(), b)

    def test_keep_n_on_save(self, tmp_path):
        for i in range(5):
            save_state_dict({"w": _sharded(_src(i))}, str(tmp_path / f"step_{i}"), keep_n=2)
        assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]


class TestCrashMidSave:
    def test_truncated_shard_leaves_staging_and_resume_lands_on_last_good(self, tmp_path):
        root = str(tmp_path)
        good = _src(3)
        save_state_dict({"w": _sharded(good, (4, 2), ("a", "b"), [Shard(0), Shard(1)])},
                        os.path.join(root, "step_1"))
        with pytest.raises(faults.InjectedCrash):
            with faults.inject(op="write", pattern="*.distcp", mode="truncate"):
                save_state_dict({"w": _sharded(_src(4))}, os.path.join(root, "step_2"))
        assert os.path.isdir(os.path.join(root, "step_2.staging"))
        assert not os.path.isdir(os.path.join(root, "step_2"))
        assert latest_checkpoint(root) == os.path.join(root, "step_1")
        dst = _sharded(np.zeros_like(good), (2, 4), ("c", "d"), [Replicate(), Shard(1)])
        load_state_dict({"w": dst}, latest_checkpoint(root))
        np.testing.assert_array_equal(dst.numpy(), good)

    def test_crash_between_rename_and_marker_refused(self, tmp_path):
        root = str(tmp_path)
        save_state_dict({"w": _sharded(_src(5))}, os.path.join(root, "ok"))
        with pytest.raises(faults.InjectedCrash):
            with faults.inject(op="commit", mode="crash"):
                save_state_dict({"w": _sharded(_src(6))}, os.path.join(root, "dead"))
        assert os.path.isdir(os.path.join(root, "dead"))
        assert not is_committed(os.path.join(root, "dead"))
        assert latest_checkpoint(root) == os.path.join(root, "ok")
        with pytest.raises(CheckpointError, match="COMMITTED"):
            load_state_dict({"w": _sharded(np.zeros((16, 8), "float32"))},
                            os.path.join(root, "dead"))

    def test_missing_dir_message_mentions_staging(self, tmp_path):
        root = str(tmp_path)
        with pytest.raises(faults.InjectedCrash):
            with faults.inject(op="write", pattern="*.distcp", mode="crash"):
                save_state_dict({"w": _sharded(_src())}, os.path.join(root, "s"))
        with pytest.raises(FileNotFoundError, match="never finished"):
            load_state_dict({"w": _sharded(np.zeros((16, 8), "float32"))},
                            os.path.join(root, "s"))


class TestCorruption:
    def _flip_byte(self, path, at=20):
        data = open(path, "rb").read()
        open(path, "wb").write(data[:at] + bytes([data[at] ^ 0xFF]) + data[at + 1:])

    def test_bitflip_names_file_not_pickle(self, tmp_path):
        path = str(tmp_path / "ck")
        save_state_dict({"w": _sharded(_src(7))}, path)
        self._flip_byte(os.path.join(path, "rank_0.distcp"))
        with pytest.raises(CheckpointCorruptionError, match="rank_0.distcp"):
            load_state_dict({"w": _sharded(np.zeros((16, 8), "float32"))}, path)

    def test_truncation_after_commit_names_file(self, tmp_path):
        path = str(tmp_path / "ck")
        save_state_dict({"w": _sharded(_src(8))}, path)
        shard = os.path.join(path, "rank_0.distcp")
        data = open(shard, "rb").read()
        open(shard, "wb").write(data[:len(data) // 2])
        with pytest.raises(CheckpointCorruptionError, match="rank_0.distcp"):
            load_state_dict({"w": _sharded(np.zeros((16, 8), "float32"))}, path)

    def test_corrupt_metadata_clear_error(self, tmp_path):
        path = str(tmp_path / "ck")
        save_state_dict({"w": _sharded(_src(9))}, path)
        open(os.path.join(path, "metadata"), "wb").write(b"\x80garbage")
        with pytest.raises(CheckpointCorruptionError, match="metadata"):
            load_state_dict({"w": _sharded(np.zeros((16, 8), "float32"))}, path)

    def test_sdc_bitflip_caught_by_fingerprint(self, tmp_path):
        """A bit flipped after the fingerprint and before serialisation: the
        CRC is self-consistent, the value fingerprint is not."""
        path = str(tmp_path / "ck")
        with faults.inject(op="sdc", pattern="*", mode="bitflip", times=1):
            save_state_dict({"w": _sharded(_src(16))}, path)
        with pytest.raises(CheckpointCorruptionError, match="fingerprint"):
            load_state_dict({"w": _sharded(np.zeros((16, 8), "float32"))}, path)


class TestRetry:
    def test_flaky_writes_absorbed_by_backoff(self, tmp_path):
        path = str(tmp_path / "ck")
        src = _src(10)
        with faults.inject(op="write", pattern="*.distcp", mode="error", times=2) as spec:
            save_state_dict({"w": _sharded(src)}, path)
        assert spec.fired == 2 and is_committed(path)
        dst = _sharded(np.zeros_like(src), (2, 4), ("c", "d"), [Shard(1), Shard(0)])
        load_state_dict({"w": dst}, path)
        np.testing.assert_array_equal(dst.numpy(), src)
        kinds = [e["kind"] for e in telemetry.get_flight_recorder().events()]
        assert "checkpoint_io_retry" in kinds

    def test_exhausted_retries_raise(self, tmp_path):
        with pytest.raises(OSError):
            with faults.inject(op="write", pattern="*.distcp", mode="error", times=-1):
                save_state_dict({"w": _sharded(_src())}, str(tmp_path / "ck"))

    def test_flaky_reads_absorbed(self, tmp_path):
        path = str(tmp_path / "ck")
        src = _src(11)
        save_state_dict({"w": _sharded(src)}, path)
        dst = _sharded(np.zeros_like(src))
        with faults.inject(op="read", pattern="*.distcp", mode="error", times=1):
            load_state_dict({"w": dst}, path)
        np.testing.assert_array_equal(dst.numpy(), src)


class TestAsyncFailureSurfaced:
    def test_async_error_raises_at_next_save_and_hits_flight_recorder(self, tmp_path):
        scope = faults.scope(faults.FaultSpec(op="write", pattern="*.distcp", mode="error",
                                              times=-1))
        with scope:
            save_state_dict({"w": _sharded(_src(12))}, str(tmp_path / "doomed"),
                            async_save=True)
            with pytest.raises(AsyncSaveError, match="doomed"):
                _wait_pending()
        save_state_dict({"w": _sharded(_src(13))}, str(tmp_path / "ok"))
        assert is_committed(str(tmp_path / "ok"))
        kinds = [e["kind"] for e in telemetry.get_flight_recorder().events()]
        assert "checkpoint_save_failed" in kinds
        dump = telemetry.dump_flight_recorder(path=str(tmp_path / "dump.json"), reason="test")
        doc = json.load(open(dump))
        assert any(e["kind"] == "checkpoint_save_failed" for e in doc["events"])

    def test_async_error_raises_at_next_save_call(self, tmp_path):
        with faults.inject(op="write", pattern="*.distcp", mode="error", times=-1):
            save_state_dict({"w": _sharded(_src())}, str(tmp_path / "doomed"),
                            async_save=True)
            with pytest.raises(AsyncSaveError):
                save_state_dict({"w": _sharded(_src())}, str(tmp_path / "next"))

    def test_async_success_commits(self, tmp_path):
        path = str(tmp_path / "ck")
        src = _src(14)
        save_state_dict({"w": _sharded(src)}, path, async_save=True)
        dst = _sharded(np.zeros_like(src))
        load_state_dict({"w": dst}, path)
        np.testing.assert_array_equal(dst.numpy(), src)
        assert is_committed(path)


class TestInjector:
    def test_seeded_probability_is_reproducible(self):
        def campaign():
            spec = faults.FaultSpec(op="write", pattern="*", mode="error", times=-1, p=0.5,
                                    seed=42)
            fired = []
            with faults.scope(spec):
                for i in range(20):
                    try:
                        faults.fire("write", f"f{i}")
                        fired.append(0)
                    except OSError:
                        fired.append(1)
            return fired

        a, b = campaign(), campaign()
        assert a == b and 0 < sum(a) < 20

    def test_after_window_and_times(self):
        spec = faults.FaultSpec(op="write", pattern="*", mode="error", after=2, times=1)
        with faults.scope(spec):
            faults.fire("write", "a")
            faults.fire("write", "b")
            with pytest.raises(OSError):
                faults.fire("write", "c")
            faults.fire("write", "d")
        assert spec.fired == 1 and spec.matched == 4

    def test_delay_mode_sleeps(self):
        spec = faults.FaultSpec(op="read", pattern="*", mode="delay", delay_s=0.05, times=1)
        t0 = time.perf_counter()
        with faults.scope(spec):
            faults.fire("read", "x")
        assert time.perf_counter() - t0 >= 0.05

    def test_sigterm_mode_drives_preemption_guard(self, tmp_path):
        guard = PreemptionGuard()
        try:
            assert not guard.preempted
            with faults.inject(op="write", pattern="*.distcp", mode="sigterm"):
                save_state_dict({"w": _sharded(_src())}, str(tmp_path / "ck"))
            assert guard.preempted and is_committed(str(tmp_path / "ck"))
        finally:
            guard.uninstall()


class TestResaveRotationRecovery:
    def _committed(self, root, name, seed):
        path = os.path.join(root, name)
        save_state_dict({"w": _sharded(_src(seed))}, path)
        return path

    def _assert_loads(self, path, expect_seed):
        dst = _sharded(np.zeros((16, 8), "float32"))
        load_state_dict({"w": dst}, path)
        np.testing.assert_array_equal(dst.numpy(), _src(expect_seed))

    def test_died_between_rotation_renames(self, tmp_path):
        root = str(tmp_path)
        path = self._committed(root, "latest", seed=20)
        os.rename(path, path + ".trash.12345")
        assert latest_checkpoint(root) == path and is_committed(path)
        self._assert_loads(path, 20)

    def test_died_before_new_marker(self, tmp_path):
        root = str(tmp_path)
        path = self._committed(root, "latest", seed=21)
        os.rename(path, path + ".trash.12345")
        newer = self._committed(root, "incoming", seed=22)
        os.remove(os.path.join(newer, COMMITTED_MARKER))
        os.rename(newer, path)
        assert latest_checkpoint(root) == path
        self._assert_loads(path, 21)

    def test_died_before_trash_sweep(self, tmp_path):
        root = str(tmp_path)
        old = self._committed(root, "old_copy", seed=23)
        path = self._committed(root, "latest", seed=24)
        os.rename(old, path + ".trash.12345")
        assert latest_checkpoint(root) == path
        assert not os.path.exists(path + ".trash.12345")
        self._assert_loads(path, 24)

    def test_resave_crash_end_to_end(self, tmp_path):
        root = str(tmp_path)
        path = self._committed(root, "latest", seed=25)
        with pytest.raises(faults.InjectedCrash):
            with faults.inject(op="commit", mode="crash"):
                save_state_dict({"w": _sharded(_src(26))}, path)
        assert latest_checkpoint(root) == path
        self._assert_loads(path, 25)


class TestPreemptionPostMortem:
    def test_checkpoint_and_exit_dumps_flight_recorder(self, tmp_path):
        guard = PreemptionGuard(signals=(signal.SIGUSR2,))
        try:
            guard.trigger()
            path = str(tmp_path / "ckpts" / "preempt")
            with pytest.raises(SystemExit) as exc:
                guard.checkpoint_and_exit({"w": _sharded(_src(15))}, path)
            assert exc.value.code == ELASTIC_EXIT_CODE and is_committed(path)
            dumps = [f for f in os.listdir(tmp_path / "ckpts") if f.startswith("flight_preempt")]
            assert len(dumps) == 1
            doc = json.load(open(tmp_path / "ckpts" / dumps[0]))
            assert doc["reason"] == "preemption"
            assert any(e["kind"] == "preemption_exit" for e in doc["events"])
        finally:
            guard.uninstall()

    def test_exit_code_survives_save_failure(self, tmp_path):
        guard = PreemptionGuard(signals=(signal.SIGUSR2,))
        try:
            guard.trigger()
            with faults.inject(op="write", pattern="*.distcp", mode="error", times=-1):
                with pytest.raises(SystemExit) as exc:
                    guard.checkpoint_and_exit({"w": _sharded(_src())}, str(tmp_path / "doomed"))
            assert exc.value.code == ELASTIC_EXIT_CODE
            assert not is_committed(str(tmp_path / "doomed"))
        finally:
            guard.uninstall()


class TestLatestAndGC:
    def test_latest_orders_by_commit_time(self, tmp_path):
        for name in ("b", "a", "c"):
            save_state_dict({"w": _sharded(_src())}, str(tmp_path / name))
        assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "c")

    def test_latest_none_and_root_itself(self, tmp_path):
        assert latest_checkpoint(str(tmp_path)) is None
        path = str(tmp_path / "solo")
        save_state_dict({"w": _sharded(_src())}, path)
        assert latest_checkpoint(path) == path

    def test_gc_keeps_newest_and_sweeps_leftovers(self, tmp_path):
        root = str(tmp_path)
        for i in range(4):
            save_state_dict({"w": _sharded(_src(i))}, os.path.join(root, f"step_{i}"))
        with pytest.raises(faults.InjectedCrash):
            with faults.inject(op="write", pattern="*.distcp", mode="crash"):
                save_state_dict({"w": _sharded(_src())}, os.path.join(root, "step_9"))
        removed = gc_checkpoints(root, keep=2)
        assert sorted(os.path.basename(p) for p in removed) == \
            ["step_0", "step_1", "step_9.staging"]
        assert latest_checkpoint(root) == os.path.join(root, "step_3")


# ---------------------------------------------------------------------------
# across the packages; the async race; blocks from two processes
# ---------------------------------------------------------------------------
def _jsharded(src):
    pm = jdist.ProcessMesh(np.arange(8).reshape(4, 2), dim_names=["a", "b"])
    return jdist.shard_tensor(src, pm, [jdist.Shard(0), jdist.Shard(1)])


def test_f32_checkpoint_crosses_both_ways(tmp_path):
    """The reference's 4 x 2 sharded save loads in the port, and the port's
    save loads into the reference's sharded target; nested keys and an
    integer step cross too."""
    src = _src(40, (16, 8))
    jck.save_state_dict({"m": {"w": _jsharded(src)}, "step": paddle.to_tensor(5)},
                        str(tmp_path / "ref"))
    dst, step = _sharded(np.zeros_like(src), (2, 4), ("c", "d"), [Shard(1), Shard(0)]), \
        torch.tensor(0)
    load_state_dict({"m": {"w": dst}, "step": step}, str(tmp_path / "ref"))
    np.testing.assert_array_equal(dst.numpy(), src)
    assert int(step) == 5
    save_state_dict({"m": {"w": _sharded(src)}, "step": torch.tensor(6)},
                    str(tmp_path / "port"))
    jdst, jstep = _jsharded(np.zeros_like(src)), paddle.to_tensor(0)
    jck.load_state_dict({"m": {"w": jdst}, "step": jstep}, str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(jdst.numpy()), src)
    assert int(jstep) == 6


def test_bf16_checkpoint_crosses_both_ways(tmp_path):
    pytest.importorskip("ml_dtypes")
    src = torch.randn(6, 10, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    save_state_dict({"w": src}, str(tmp_path / "port"))
    jdst = paddle.zeros([6, 10], dtype="bfloat16")
    jck.load_state_dict({"w": jdst}, str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(jdst.astype("float32").numpy()),
                                  src.float().numpy())
    jck.save_state_dict({"w": jdst}, str(tmp_path / "ref"))
    dst = torch.zeros(6, 10, dtype=torch.bfloat16)
    load_state_dict({"w": dst}, str(tmp_path / "ref"))
    assert torch.equal(dst, src)


def test_fingerprints_equal_across_packages():
    rng = np.random.default_rng(7)
    arrays = {"a": rng.standard_normal((300, 41)).astype(np.float32),
              "b": rng.integers(0, 9, (17,)).astype(np.int64),
              "c": rng.standard_normal((5,)).astype(np.float64)}
    assert sdc.tree_fingerprints(arrays, 0xD5C) == jsdc.tree_fingerprints(arrays, 0xD5C)
    big = {f"k{i}": rng.standard_normal((1 << 20) + i).astype(np.float32) for i in range(5)}
    assert sdc.tree_fingerprints(big, 3) == jsdc.tree_fingerprints(big, 3)   # odd tails
    ml = pytest.importorskip("ml_dtypes")
    t = torch.randn(33).to(torch.bfloat16)
    bits = t.view(torch.int16).numpy().view(np.uint16)
    assert sdc.host_fingerprint(t, 5) == jsdc.host_fingerprint(bits.view(ml.bfloat16), 5)
    assert sdc.pack_digest([1.5, -2.0]) == jsdc.pack_digest([1.5, -2.0])


def test_async_save_holds_the_values_before_an_in_place_update(tmp_path):
    """An optimizer updates in place right after an asynchronous save: the
    checkpoint holds the values from before the update."""
    w = torch.from_numpy(_src(50, (64, 32)))
    before = w.clone()
    m = torch.zeros_like(w)
    save_state_dict({"w": w, "m": m}, str(tmp_path / "ck"), async_save=True)
    w.add_(1.0)
    m.fill_(3.0)
    dst, mdst = torch.empty_like(w), torch.empty_like(m)
    load_state_dict({"w": dst, "m": mdst}, str(tmp_path / "ck"))
    assert torch.equal(dst, before) and torch.equal(mdst, torch.zeros_like(m))


def test_local_blocks_of_two_processes_reshard(tmp_path):
    """Two gloo processes each save their half of rows (``mark_local_shard``)
    and a replicated step; one load takes the whole tensor, another the
    column halves."""
    payload = textwrap.dedent(f"""
        import os, sys, torch, torch.distributed as td
        sys.path.insert(0, {ROOT!r})
        from paddle_tpu_torch.distributed.checkpoint import (save_state_dict,
            load_state_dict, mark_local_shard)
        rank = int(os.environ["RANK"])
        td.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                              rank=rank, world_size=2, timeout=__import__("datetime").timedelta(seconds=60))
        full = torch.arange(48, dtype=torch.float32).reshape(6, 8)
        mine = mark_local_shard(full[3 * rank:3 * rank + 3].clone(), (3 * rank, 0), (6, 8))
        save_state_dict({{"w": mine, "step": torch.tensor(9)}}, {str(tmp_path / "ck")!r})
        col = mark_local_shard(torch.zeros(6, 4), (0, 4 * rank), (6, 8))
        step = torch.tensor(0)
        load_state_dict({{"w": col, "step": step}}, {str(tmp_path / "ck")!r})
        assert torch.equal(col, full[:, 4 * rank:4 * rank + 4]) and int(step) == 9, col
        td.destroy_process_group()
    """)
    script = tmp_path / "worker.py"
    script.write_text(payload)
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env={**os.environ, "RANK": str(r), "PORT": str(port)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert sorted(os.listdir(tmp_path / "ck")) == ["COMMITTED", "metadata", "rank_0.distcp",
                                                   "rank_1.distcp"]
    whole = torch.zeros(6, 8)
    load_state_dict({"w": whole}, str(tmp_path / "ck"))
    assert torch.equal(whole, torch.arange(48, dtype=torch.float32).reshape(6, 8))
