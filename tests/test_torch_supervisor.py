"""The restart layer of the port (ROADMAP A7b): the ``Supervisor`` and
``RestartPolicy``, ``emergency_handler``, the ``FleetSupervisor`` gang,
``rpc`` and elastic training over the TCP store, from the reference's
``tests/test_supervisor.py`` (all four classes), ``tests/test_fleet_gang.py``
(``TestSigstopCoordinatedAbort``, ``TestElasticDegrade`` and
``TestSigkillGangRestart``'s case), ``tests/test_rpc.py`` and
``tests/test_elastic_tcp_preemption.py``.  The child processes import the
port (``paddle_tpu_torch``) and run on the CPU; the light gang members load
the port's ``store.py`` and ``fault_domain.py`` standalone, importing no
torch.  Every wait on a child carries its own deadline."""

import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.distributed import CommWatchdog
from paddle_tpu_torch.distributed.auto_parallel import (ProcessMesh, Replicate, Shard,
                                                        shard_tensor)
from paddle_tpu_torch.distributed.checkpoint import (is_committed, latest_checkpoint,
                                                     load_state_dict, save_state_dict)
from paddle_tpu_torch.distributed.fleet.elastic import (ELASTIC_EXIT_CODE, ElasticManager,
                                                        ElasticStatus, FleetSupervisor,
                                                        GangPolicy, PreemptionGuard,
                                                        RestartPolicy, Supervisor,
                                                        emergency_handler)
from paddle_tpu_torch.distributed.store import TCPKVStore, TCPStore

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE_PY = os.path.join(REPO, "paddle_tpu_torch", "distributed", "store.py")
FD_PY = os.path.join(REPO, "paddle_tpu_torch", "distributed", "fleet", "fault_domain.py")
CHILD_ENV = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


@pytest.fixture(autouse=True)
def _on_cpu():
    paddle.set_device("cpu")
    yield
    paddle.set_device(None)


def _pm():
    return ProcessMesh(np.arange(8), dim_names=["x"], devices=["cpu"] * 8)


# -- tests/test_supervisor.py ---------------------------------------------------

class TestRestartPolicy:
    def test_backoff_grows_and_caps(self):
        p = RestartPolicy(backoff_base=1.0, backoff_cap=8.0, jitter=0.0)
        delays = [p.delay(i) for i in range(1, 7)]
        assert delays == [1.0, 2.0, 4.0, 8.0, 8.0, 8.0]

    def test_jitter_is_seeded_deterministic(self):
        p = RestartPolicy(backoff_base=1.0, jitter=0.5, seed=3)
        q = RestartPolicy(backoff_base=1.0, jitter=0.5, seed=3)
        assert [p.delay(i) for i in (1, 2, 3)] == \
            [q.delay(i) for i in (1, 2, 3)]
        r = RestartPolicy(backoff_base=1.0, jitter=0.5, seed=4)
        assert [p.delay(i) for i in (1, 2, 3)] != \
            [r.delay(i) for i in (1, 2, 3)]


def _fast_policy(max_restarts=5):
    return RestartPolicy(max_restarts=max_restarts, backoff_base=0.001,
                         backoff_cap=0.002)


class TestSupervisorInProcess:
    def test_restarts_until_success(self):
        runs = {"n": 0}

        def job():
            runs["n"] += 1
            if runs["n"] < 3:
                raise SystemExit(ELASTIC_EXIT_CODE)

        sup = Supervisor(job, policy=_fast_policy())
        assert sup.run() == 0
        assert sup.restarts == 2
        assert sup.exit_codes == [ELASTIC_EXIT_CODE, ELASTIC_EXIT_CODE, 0]

    def test_gives_up_after_max_restarts(self):
        sup = Supervisor(lambda: (_ for _ in ()).throw(
            SystemExit(ELASTIC_EXIT_CODE)), policy=_fast_policy(2))
        assert sup.run() == ELASTIC_EXIT_CODE
        assert sup.restarts == 2
        assert len(sup.exit_codes) == 3  # initial + 2 restarts

    def test_non_restart_code_is_fatal(self):
        runs = {"n": 0}

        def job():
            runs["n"] += 1
            raise SystemExit(7)

        sup = Supervisor(job, policy=_fast_policy())
        assert sup.run() == 7
        assert runs["n"] == 1 and sup.restarts == 0

    def test_gc_between_restarts(self, tmp_path):
        root = str(tmp_path)
        pm = _pm()

        def mk(i):
            t = shard_tensor(np.full((8, 4), float(i), "float32"), pm,
                             [Shard(0), Replicate()])
            save_state_dict({"w": t}, os.path.join(root, f"step_{i}"))

        for i in range(4):
            mk(i)
        runs = {"n": 0}

        def job():
            runs["n"] += 1
            if runs["n"] == 1:
                raise SystemExit(ELASTIC_EXIT_CODE)

        sup = Supervisor(job, policy=_fast_policy(), ckpt_root=root, keep_n=2)
        assert sup.run() == 0
        remaining = sorted(os.listdir(root))
        assert remaining == ["step_2", "step_3"]


class TestWatchdogEmergencyPath:
    def test_hang_saves_committed_emergency_checkpoint(self, tmp_path):
        """CommWatchdog timeout → flight-recorder dump (watchdog) →
        emergency checkpoint (handler) — all observable in-process with
        hard_exit=False; latest_checkpoint then resumes from it."""
        root = str(tmp_path)
        pm = _pm()
        src = np.arange(32, dtype="float32").reshape(8, 4)
        state = {"w": shard_tensor(src, pm, [Shard(0), Replicate()]),
                 "step": torch.tensor(17, dtype=torch.int64)}
        infos = []

        def on_timeout(info):
            infos.append(info)
            emergency_handler(lambda: state, root, hard_exit=False)(info)

        wd = CommWatchdog(timeout=0.2, poll_interval=0.05,
                          on_timeout=on_timeout)
        with wd.watch("hung_allreduce"):
            time.sleep(0.7)
        wd.stop()
        assert len(infos) == 1
        assert "flight_recorder_dump" in infos[0]  # dump happened first

        latest = latest_checkpoint(root)
        assert latest is not None and is_committed(latest)
        assert os.path.basename(latest).startswith("emergency_")
        dst = {"w": shard_tensor(np.zeros_like(src), pm,
                                 [Replicate(), Shard(1)]),
               "step": torch.tensor(0, dtype=torch.int64)}
        load_state_dict(dst, latest)
        np.testing.assert_array_equal(dst["w"].numpy(), src)
        assert int(dst["step"]) == 17


CHILD_SCRIPT = """
import os, sys
import torch
from paddle_tpu_torch.distributed.checkpoint import (latest_checkpoint,
    load_state_dict, save_state_dict)
from paddle_tpu_torch.distributed.fleet.elastic import ELASTIC_EXIT_CODE

root, total, crash_at, log = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]

start = 0
acc = torch.zeros(4)
resume = latest_checkpoint(root)
if resume:
    state = {"acc": acc, "step": torch.tensor(0, dtype=torch.int64)}
    load_state_dict(state, resume)
    start = int(state["step"])

for step in range(start, total):
    acc = acc + float(step + 1)          # deterministic "training"
    with open(log, "a") as f:
        f.write(f"{step}:{float(acc[0]):.1f}\\n")
    save_state_dict({"acc": acc, "step": torch.tensor(step + 1, dtype=torch.int64)},
                    os.path.join(root, f"step_{step + 1}"), keep_n=3)
    if step + 1 == crash_at and not os.path.exists(root + "/.crashed"):
        open(root + "/.crashed", "w").write("1")
        os._exit(ELASTIC_EXIT_CODE)      # simulated mid-run death
"""


class TestSupervisorSubprocessEndToEnd:
    def test_crash_relaunch_resume_completes(self, tmp_path):
        """Full cycle under real process isolation: child dies with 101 at
        step 3, the supervisor relaunches it, the relaunch resumes from
        latest_checkpoint and the combined trajectory equals an
        uninterrupted run's."""
        script = tmp_path / "child.py"
        script.write_text(textwrap.dedent(CHILD_SCRIPT))
        root, log = str(tmp_path / "ckpts"), str(tmp_path / "log.txt")
        os.makedirs(root)
        env = {**os.environ, **CHILD_ENV}
        sup = Supervisor([sys.executable, str(script), root, "6", "3", log],
                         policy=_fast_policy(), env=env,
                         ckpt_root=root, keep_n=3, child_timeout=120)
        assert sup.run() == 0
        assert sup.restarts == 1
        lines = [l for l in open(log).read().splitlines() if l]
        steps = [int(l.split(":")[0]) for l in lines]
        assert steps == [0, 1, 2, 3, 4, 5]  # resumed at 3, no replays/gaps
        # accumulator trajectory = cumulative sum 1..6, bit-exact across
        # the crash/resume boundary
        vals = [float(l.split(":")[1]) for l in lines]
        assert vals == [1.0, 3.0, 6.0, 10.0, 15.0, 21.0]
        assert sorted(os.listdir(root))[-1] == "step_6"
        assert len([d for d in os.listdir(root)
                    if d.startswith("step_")]) == 3  # keep_n retention


# -- tests/test_fleet_gang.py -------------------------------------------------

def _readline(proc, timeout):
    """One line of ``proc``'s output, or raise after ``timeout`` seconds."""
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        if not sel.select(timeout):
            raise TimeoutError(f"no output from pid {proc.pid} in {timeout} s")
        return proc.stdout.readline()
    finally:
        sel.close()


def _fast_gang_policy(max_gang_restarts=1, **kw):
    return GangPolicy(max_gang_restarts=max_gang_restarts,
                      backoff=RestartPolicy(backoff_base=0.01,
                                            backoff_cap=0.02), **kw)


# -- SIGSTOP: hang → lease expiry → poison → bounded gang exit ---------------

# torch-free gang member: loads the store client and the fault domain
# standalone (importlib), heartbeats + stamps steps forever; rank 0 runs
# the lease monitor. The ONLY way out is the poison poll's exit-101.
_LIGHT_MEMBER = textwrap.dedent("""
    import importlib.util, sys, time

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        m = importlib.util.module_from_spec(spec)
        sys.modules[name] = m
        spec.loader.exec_module(m)
        return m

    store_mod = load("pt_store", sys.argv[1])
    fd_mod = load("pt_fd", sys.argv[2])
    assert "torch" not in sys.modules  # the light member must stay light
    port, rank, world = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
    client = store_mod.TCPStore("127.0.0.1", port, timeout=30.0)
    d = fd_mod.FaultDomain(client, rank, world, monitor=(rank == 0),
                           hb_interval=0.1, hb_ttl=0.6, poison_poll=0.1,
                           abort_deadline=5.0)
    d.start()
    d.gang_barrier(timeout=15.0)
    print("READY", rank, flush=True)
    step = 0
    while True:
        step += 1
        d.note_step(step)
        time.sleep(0.05)
""")


class TestSigstopCoordinatedAbort:
    def test_stuck_rank_lease_expires_and_gang_exits_bounded(self, tmp_path):
        world = 4
        master = TCPStore("127.0.0.1", 0, is_master=True, world_size=world,
                          timeout=30.0)
        script = tmp_path / "member.py"
        script.write_text(_LIGHT_MEMBER)
        procs = []
        try:
            for rank in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), STORE_PY, FD_PY,
                     str(master.port), str(rank), str(world)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            for pr in procs:
                assert _readline(pr, 30).startswith("READY")

            t0 = time.time()
            os.kill(procs[2].pid, signal.SIGSTOP)  # rank 2 wedges mid-step

            # every OTHER member must exit 101 within the detection bound:
            # ttl (0.6) + monitor/poll latency + margin — and certainly
            # well under the formerly-infinite hang
            for rank in (0, 1, 3):
                rc = procs[rank].wait(timeout=20)
                assert rc == 101, (rank, rc, procs[rank].stdout.read())
            assert time.time() - t0 < 15

            # the pill names the culprit
            import json

            doc = json.loads(master.get("fleet/default/poison/0"))
            assert doc["reason"] == "lease_expired"
            assert doc["culprit"] == 2

            # un-wedged, the stuck rank sees the pill and leaves the same way
            os.kill(procs[2].pid, signal.SIGCONT)
            assert procs[2].wait(timeout=20) == 101
        finally:
            for pr in procs:
                if pr.poll() is None:
                    try:
                        os.kill(pr.pid, signal.SIGCONT)
                    except OSError:
                        pass
                    pr.kill()
            master.close()


# -- SIGKILL mid-step: gang restart + bit-exact resume -----------------------

# real training-shaped gang member (imports the port: checkpoints + the
# fault domain via the launcher env contract). Deterministic "training":
# acc_{s+1} = acc_s + (s+1); rank 0 commits a checkpoint only AFTER the
# whole gang passed the step barrier. Rank 2 is SIGKILLed entering
# `kill_at` on the first epoch; survivors wedge on that step's barrier —
# their poison poll converts the hang into exit 101.
_TRAIN_MEMBER = textwrap.dedent("""
    import os, sys
    import torch
    from paddle_tpu_torch.distributed.checkpoint import (latest_checkpoint,
        load_state_dict, save_state_dict)
    from paddle_tpu_torch.distributed.fleet import fault_domain as fd_mod

    root, total, kill_at, log_dir = sys.argv[1:5]
    total, kill_at = int(total), int(kill_at)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    epoch = int(os.environ["PADDLE_TPU_GANG_EPOCH"])
    d = fd_mod.init_from_env()      # lease + poison poll + gang barrier
    assert d is not None and d.rank == rank

    start = 0
    acc = torch.zeros(4)
    resume = latest_checkpoint(root)
    if resume:
        state = {"acc": acc, "step": torch.tensor(0, dtype=torch.int64)}
        load_state_dict(state, resume)
        start = int(state["step"])
    log = open(os.path.join(log_dir, f"losses.{rank}"), "a")
    for step in range(start, total):
        if epoch == 1 and rank == 2 and step == kill_at:
            os.kill(os.getpid(), 9)          # SIGKILL mid-step
        acc = acc + float(step + 1)
        log.write(f"{epoch}:{step}:{float(acc[0]):.1f}\\n")
        log.flush()
        d.note_step(step)
        # the stand-in collective: the gang completes the step together
        d._store.barrier(f"step/{epoch}/{step}", d.world_size,
                         timeout=60.0, rank=rank)
        if rank == 0:
            save_state_dict(
                {"acc": acc, "step": torch.tensor(step + 1, dtype=torch.int64)},
                os.path.join(root, f"step_{step + 1}"), keep_n=3)
    d.stop()
    print("DONE", rank, flush=True)
""")


class TestSigkillGangRestart:
    def test_kill_restart_resume_identical_trajectory(self, tmp_path):
        total, kill_at, world = 6, 3, 4
        script = tmp_path / "member.py"
        script.write_text(_TRAIN_MEMBER)
        root = tmp_path / "ckpts"
        root.mkdir()
        sup = FleetSupervisor(
            str(script), [str(root), str(total), str(kill_at),
                          str(tmp_path)],
            nproc_per_node=world, log_dir=str(tmp_path / "log"),
            policy=_fast_gang_policy(max_gang_restarts=2, degrade=False),
            ckpt_root=str(root), keep_n=3,
            # workers run script-mode (script dir on sys.path, not cwd)
            env={"PYTHONPATH": REPO + os.pathsep +
                 os.environ.get("PYTHONPATH", "")})
        assert sup.run() == 0
        assert sup.epoch == 2          # one gang relaunch
        assert sup.world_size == world  # no degrade
        assert sup.exit_codes[0] != 0 and sup.exit_codes[-1] == 0

        # per-rank loss trajectories: deterministic cumulative sum — steps
        # replayed across the crash/resume boundary must be bit-identical,
        # every rank must cover every step, and nothing else may appear
        expect = {}
        acc = 0.0
        for s in range(total):
            acc += s + 1
            expect[s] = acc
        for rank in range(world):
            lines = [l for l in
                     (tmp_path / f"losses.{rank}").read_text().splitlines()
                     if l]
            seen = {}
            epochs = set()
            for line in lines:
                ep, step, val = line.split(":")
                epochs.add(int(ep))
                step, val = int(step), float(val)
                assert val == expect[step], (rank, step, val)
                seen.setdefault(step, set()).add(val)
            assert sorted(seen) == list(range(total)), (rank, sorted(seen))
            # replays recompute the SAME value (one distinct loss per step)
            assert all(len(v) == 1 for v in seen.values())
            assert epochs == {1, 2}, (rank, epochs)  # both gang launches ran

        # the relaunch resumed from a committed checkpoint, not from scratch:
        # epoch-2 lines start at (or before) the kill step, never at 0 twice
        r2 = [l for l in
              (tmp_path / "losses.2").read_text().splitlines() if l]
        epoch2_steps = [int(l.split(":")[1]) for l in r2
                        if l.startswith("2:")]
        assert epoch2_steps[0] > 0            # resumed, not restarted
        assert epoch2_steps[0] <= kill_at     # from a pre-kill checkpoint


# -- persistent rank loss: elastic degrade to a smaller world ----------------

# torch-free member for the degrade path: rank 3 ("the bad host") dies
# instantly whenever the gang runs at world 4; at world 3 everyone
# completes a few steps and exits 0.
_FLAKY_MEMBER = textwrap.dedent("""
    import os, sys, time
    out_dir = sys.argv[1]
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    epoch = os.environ.get("PADDLE_TPU_GANG_EPOCH", "0")
    if world == 4 and rank == 3:
        sys.exit(1)                      # persistently missing host
    for step in range(3):
        time.sleep(0.02)
    with open(os.path.join(out_dir, f"done.{epoch}.{rank}"), "w") as f:
        f.write(str(world))
""")


class TestElasticDegrade:
    def test_persistent_loss_degrades_world_and_completes(self, tmp_path):
        script = tmp_path / "member.py"
        script.write_text(_FLAKY_MEMBER)
        sup = FleetSupervisor(
            str(script), [str(tmp_path)],
            nproc_per_node=4, log_dir=str(tmp_path / "log"),
            policy=_fast_gang_policy(max_gang_restarts=1, degrade=True,
                                     min_procs=2))
        assert sup.run() == 0
        # epoch 1 (world 4) fails, epoch 2 (world 4, last restart) fails,
        # degrade → epoch 3 at world 3 completes at reduced DP
        assert sup.degrades == 1
        assert sup.world_size == 3
        assert sup.epoch == 3
        done = sorted(p.name for p in tmp_path.glob("done.3.*"))
        assert done == ["done.3.0", "done.3.1", "done.3.2"]
        assert all((tmp_path / d).read_text() == "3" for d in done)

    def test_gang_restart_budget_env_knob(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_GANG_RESTARTS", "7")
        assert GangPolicy().max_gang_restarts == 7

    def test_supervisor_loop_with_stub_launcher(self):
        """World/epoch bookkeeping without real processes: budget per world
        size, degrade resets it, env contract stamped per attempt."""
        calls = []

        def fake_launch(argv, env):
            calls.append((argv, dict(env)))
            return 0 if len(calls) >= 4 else 101

        sup = FleetSupervisor(
            "train.py", nproc_per_node=4,
            policy=_fast_gang_policy(max_gang_restarts=1, degrade=True,
                                     min_procs=2, degrade_step=2),
            launch_fn=fake_launch)
        assert sup.run() == 0
        nprocs = [a[a.index("--nproc_per_node") + 1] for a, _ in calls]
        assert nprocs == ["4", "4", "2", "2"]
        epochs = [e["PADDLE_TPU_GANG_EPOCH"] for _, e in calls]
        assert epochs == ["1", "2", "3", "4"]
        assert all(e["PADDLE_TPU_GANG_BARRIER"] == "1" for _, e in calls)
        assert sup.degrades == 1 and sup.gang_restarts == 1

    def test_fatal_code_is_not_restarted(self):
        calls = []

        def fake_launch(argv, env):
            calls.append(1)
            return 7

        sup = FleetSupervisor("train.py", nproc_per_node=2,
                              policy=_fast_gang_policy(),
                              fatal_codes=(7,), launch_fn=fake_launch)
        assert sup.run() == 7
        assert calls == [1]

    def test_giveup_at_the_floor(self):
        def fake_launch(argv, env):
            return 101

        sup = FleetSupervisor(
            "train.py", nproc_per_node=2,
            policy=_fast_gang_policy(max_gang_restarts=1, degrade=True,
                                     min_procs=2), launch_fn=fake_launch)
        assert sup.run() == 101
        assert sup.degrades == 0  # floor: 2 - 1 < min_procs
        assert sup.epoch == 2     # initial + one restart, then give up


# -- tests/test_rpc.py ------------------------------------------------------------

WORKER = textwrap.dedent("""
    import os, sys
    import paddle_tpu_torch.distributed.rpc as rpc

    def add(a, b):
        return a + b

    def whoami():
        return rpc.get_current_worker_info().name

    def boom():
        raise ValueError("remote boom")

    name = sys.argv[1]
    endpoint = sys.argv[2]
    rpc.init_rpc(name, rank=int(sys.argv[3]), world_size=2,
                 master_endpoint=endpoint)
    infos = rpc.get_all_worker_infos()
    assert [w.name for w in infos] == ["worker0", "worker1"], infos
    peer = "worker1" if name == "worker0" else "worker0"
    assert rpc.rpc_sync(peer, add, args=(2, 3)) == 5
    fut = rpc.rpc_async(peer, whoami)
    assert fut.wait() == peer
    try:
        rpc.rpc_sync(peer, boom)
        raise SystemExit("expected remote exception")
    except ValueError as e:
        assert "remote boom" in str(e)
    assert rpc.get_worker_info(peer).rank != rpc.get_current_worker_info().rank
    rpc.shutdown()
    print("RPC_OK", name)
""")


def test_two_worker_rpc(tmp_path):
    """Two workers meet through a store the test hosts (both join it as
    clients, so no port is chosen free and then raced for)."""
    script = tmp_path / "rpc_worker.py"
    script.write_text(WORKER)
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=2, timeout=60.0)
    env = {**os.environ, **CHILD_ENV}
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"worker{i}", f"127.0.0.1:{master.port}",
         str(i)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        master.close()
    assert all(p.returncode == 0 for p in procs), outs
    for i, out in enumerate(outs):
        assert f"RPC_OK worker{i}" in out, out


def test_errors_without_init():
    import paddle_tpu_torch.distributed.rpc as rpc

    with pytest.raises(RuntimeError, match="init_rpc"):
        rpc.rpc_sync("nobody", max, args=(1, 2))
    with pytest.raises(RuntimeError, match="init_rpc"):
        rpc.get_current_worker_info()
    rpc.shutdown()  # no-op before init


# -- tests/test_elastic_tcp_preemption.py --------------------------------------

class TestElasticOverTCP:
    """ElasticManager with the TCP KV backend: the FileStore contract
    without any shared filesystem (verdict #5 done-criterion)."""

    @pytest.fixture
    def tcp_kv(self):
        master = TCPStore("127.0.0.1", 0, is_master=True, timeout=20.0)
        yield lambda: TCPKVStore(
            TCPStore("127.0.0.1", master.port, timeout=10.0), prefix="el")
        master.close()

    def test_membership_and_restart_detection(self, tcp_kv):
        m1 = ElasticManager(tcp_kv(), job_id="j", np="1:2", host="node-a",
                            ttl=2.0)
        m2 = ElasticManager(tcp_kv(), job_id="j", np="1:2", host="node-b",
                            ttl=2.0)
        assert m1.hosts() == ["node-a", "node-b"]
        world = m1.commit_world()
        assert world == ["node-a", "node-b"]
        assert m1.watch_once() == ElasticStatus.HOLD  # steady state
        # peer leaves (still >= np_min) → RESTART with survivors
        m2.exit()
        assert m1.watch_once() == ElasticStatus.RESTART
        m1.exit(completed=True)
        m3 = ElasticManager(tcp_kv(), job_id="j", np=1, host="node-c", ttl=2.0)
        assert m3.watch_once() == ElasticStatus.COMPLETED
        m3.exit()

    def test_scale_up_detected(self, tcp_kv):
        m1 = ElasticManager(tcp_kv(), job_id="j2", np="1:3", host="a", ttl=2.0)
        m1.commit_world()
        assert m1.watch_once() == ElasticStatus.HOLD
        m2 = ElasticManager(tcp_kv(), job_id="j2", np="1:3", host="b", ttl=2.0)
        assert m1.watch_once() == ElasticStatus.RESTART  # joiner → rescale
        m1.exit(); m2.exit()


class TestMultiNodeLaunchRendezvous:
    def test_two_pod_launch_over_master(self, tmp_path):
        """Two `launch` pods (nnodes=2) rendezvous through --master, get
        distinct auto-assigned node ranks, and the env contract reaches the
        workers."""
        import socket as socketlib

        with socketlib.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        script = tmp_path / "worker.py"
        script.write_text(textwrap.dedent("""
            import os, sys
            need = ["PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                    "PADDLE_MASTER", "PADDLE_NODE_RANK", "PADDLE_NNODES"]
            vals = {k: os.environ[k] for k in need}
            assert vals["PADDLE_TRAINERS_NUM"] == "2", vals
            assert vals["PADDLE_NNODES"] == "2", vals
            print("WORKER_OK", vals["PADDLE_TRAINER_ID"],
                  vals["PADDLE_NODE_RANK"])
        """))
        env = {**os.environ, **CHILD_ENV}
        pods = [subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nnodes", "2", "--master", f"127.0.0.1:{port}",
             "--job_id", "rdzv_test",
             "--log_dir", str(tmp_path / f"log{i}"), str(script)],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for i in range(2)]
        try:
            outs = [p.communicate(timeout=120)[0].decode() for p in pods]
        finally:
            for p in pods:
                if p.poll() is None:
                    p.kill()
        assert all(p.returncode == 0 for p in pods), outs
        ranks = set()
        for i in range(2):
            log = tmp_path / f"log{i}"
            # the worker's log; beside it the launcher's own flight-recorder
            # dump and the merged black box (the observability epilogue)
            files = [f for f in os.listdir(log) if f.startswith("workerlog")]
            assert len(files) == 1
            assert "blackbox_merged.json" in os.listdir(log)
            content = (log / files[0]).read_text()
            assert "WORKER_OK" in content, content
            ranks.add(content.split()[1])
        assert ranks == {"0", "1"}


TRAIN_SCRIPT = """
import os, signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.distributed.checkpoint import save_state_dict, load_state_dict
from paddle_tpu_torch.distributed.fleet.elastic import PreemptionGuard
from paddle_tpu_torch.optimizer import Adam

paddle.set_device("cpu")

ckpt = sys.argv[1]
total_steps = int(sys.argv[2])
preempt_at = int(sys.argv[3])  # -1: never (baseline / resumed run)
trace_path = sys.argv[4]

paddle.seed(0)
model = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
opt = Adam(1e-2, parameters=model.parameters())
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
y = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))

start = 0
state = {"model": model.state_dict(), "opt": opt.state_dict(),
         "step": torch.tensor(0, dtype=torch.int64)}
if os.path.exists(os.path.join(ckpt, "metadata")):
    load_state_dict(state, ckpt)
    model.set_state_dict(state["model"])
    opt.set_state_dict(state["opt"])
    start = int(state["step"])

guard = PreemptionGuard()
losses = []
for step in range(start, total_steps):
    loss = F.mse_loss(model(x), y)
    loss.backward()
    opt.step(); opt.clear_grad()
    losses.append(f"{step}:{float(loss):.6f}")
    if step + 1 == preempt_at:
        os.kill(os.getpid(), signal.SIGTERM)  # deliver the notice mid-run
    if guard.preempted:
        with open(trace_path, "a") as f:
            f.write("\\n".join(losses) + "\\n")
        state = {"model": model.state_dict(), "opt": opt.state_dict(),
                 "step": torch.tensor(step + 1, dtype=torch.int64)}
        guard.checkpoint_and_exit(state, ckpt)
with open(trace_path, "a") as f:
    f.write("\\n".join(losses) + "\\n")
"""


class TestPreemptionResume:
    def test_kill_and_resume_matches_uninterrupted(self, tmp_path):
        """Verdict #7 done-criterion: SIGTERM mid-run → async ckpt → restart
        resumes to the SAME loss trajectory as an uninterrupted run."""
        script = tmp_path / "train.py"
        script.write_text(TRAIN_SCRIPT)
        env = {**os.environ, **CHILD_ENV}

        def run(ckpt, steps, preempt_at, trace):
            return subprocess.run(
                [sys.executable, str(script), str(ckpt), str(steps),
                 str(preempt_at), str(trace)], env=env, timeout=120,
                capture_output=True, text=True)

        base = run(tmp_path / "ckpt_base", 8, -1, tmp_path / "base.txt")
        assert base.returncode == 0, base.stderr

        r1 = run(tmp_path / "ckpt", 8, 4, tmp_path / "trace.txt")
        assert r1.returncode == ELASTIC_EXIT_CODE, (r1.returncode, r1.stderr)
        assert os.path.exists(tmp_path / "ckpt" / "metadata")
        r2 = run(tmp_path / "ckpt", 8, -1, tmp_path / "trace.txt")
        assert r2.returncode == 0, r2.stderr

        def parse(p):
            return {int(l.split(":")[0]): float(l.split(":")[1])
                    for l in open(p).read().split() if l}

        base_losses = parse(tmp_path / "base.txt")
        resumed = parse(tmp_path / "trace.txt")
        assert sorted(resumed) == sorted(base_losses) == list(range(8))
        for s in range(8):
            np.testing.assert_allclose(resumed[s], base_losses[s], rtol=1e-4,
                                       err_msg=f"step {s}")

    def test_guard_flag_and_uninstall(self):
        guard = PreemptionGuard(signals=(signal.SIGUSR1,))
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.1)
        assert guard.preempted
        guard.uninstall()
        assert signal.getsignal(signal.SIGUSR1) != guard._on_signal
