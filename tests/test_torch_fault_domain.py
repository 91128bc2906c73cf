"""The fleet fault domain of the port (ROADMAP A7b), from the reference's
``tests/test_fault_domain.py`` (lease TTL math, the heartbeat over both
store backends, the lease monitor, the poison protocol, the coordinated
abort wired into ``CommWatchdog`` and ``HealthGuard``, the gang barrier's
deadline) and ``tests/test_elastic_watchdog.py``'s ``FileStore`` and
``ElasticManager`` cases, over the port's ``TCPStore``.  Beyond them:
``CommWatchdog(fault_domain="current")`` against the process-global
domain, ``init_parallel_env`` joining the domain in two gloo processes
that the launcher starts with its default (the fault domain on), and the
launcher tearing the pod down on a pill a rank wrote."""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

import paddle_tpu_torch.telemetry as telemetry
from paddle_tpu_torch.distributed import CommWatchdog
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticLevel, ElasticManager,
                                                        ElasticStatus, FileStore)
from paddle_tpu_torch.distributed.fleet.fault_domain import (FaultDomain,
                                                       HeartbeatLease,
                                                       LeaseMonitor,
                                                       heartbeat_interval,
                                                       lease_expired)
from paddle_tpu_torch.distributed.health import HealthGuard, HealthPolicy
from paddle_tpu_torch.distributed.store import TCPStore


@pytest.fixture
def master():
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=4, timeout=20.0)
    yield s
    s.close()


def _wait_for(cond, timeout=10.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


class TestLeaseTTLMath:
    def test_interval_is_a_third_of_ttl(self):
        assert heartbeat_interval(9.0) == 3.0
        assert heartbeat_interval(9.0, interval=1.0) == 1.0

    def test_interval_floor(self):
        # three missable beats per ttl, but never a busy-loop
        assert heartbeat_interval(0.06) == 0.05
        assert heartbeat_interval(10.0, interval=0.001) == 0.05
        assert heartbeat_interval(10.0, interval=0.2, min_interval=0.5) == 0.5

    def test_expiry(self):
        assert not lease_expired(0.5, 1.0)
        assert lease_expired(1.5, 1.0)
        # a key that never existed is a JOIN problem, not a death
        assert not lease_expired(None, 1.0)


class TestHeartbeatLease:
    def test_filestore_backend_beats_and_stamps_steps(self, tmp_path):
        st = FileStore(str(tmp_path))
        lease = HeartbeatLease(st, "hb/0", ttl=5.0, interval=0.05,
                               payload={"rank": 0}).start()
        assert _wait_for(lambda: lease.beats >= 2)
        assert st.age("hb/0") < 1.0
        lease.note_step(7)
        assert _wait_for(lambda: (st.get("hb/0") or {}).get("step") == 7)
        doc = st.get("hb/0")
        assert doc["rank"] == 0 and doc["step_ts"] > 0
        lease.stop(release=True)
        assert st.get("hb/0") is None

    def test_raw_tcpstore_backend(self, master):
        lease = HeartbeatLease(master, "hb/3", ttl=5.0, interval=0.05,
                               payload={"rank": 3}).start()
        assert _wait_for(lambda: lease.beats >= 1)
        doc = json.loads(master.get("hb/3"))
        assert doc["rank"] == 3 and doc["ttl"] == 5.0
        lease.note_step(11)
        assert _wait_for(
            lambda: json.loads(master.get("hb/3")).get("step") == 11)
        assert master.age("hb/3") < 1.0
        lease.stop()

    def test_store_lost_fires_after_ttl_of_failures(self):
        class DeadKV:
            def put(self, k, v):
                raise OSError("store gone")

            def age(self, k):
                return None

        lost = []
        lease = HeartbeatLease(DeadKV(), "hb/0", ttl=0.1,
                               on_store_lost=lost.append)
        assert lease.beat_now() is False
        assert lost == []  # first failure starts the clock, nothing more
        time.sleep(0.15)
        assert lease.beat_now() is False
        assert len(lost) == 1 and isinstance(lost[0], OSError)
        assert lease.beat_now() is False  # fires ONCE
        assert len(lost) == 1


class TestLeaseMonitor:
    def test_dead_lease_is_poisoned_stragglers_are_not(self, master):
        """Load-proof by construction (the old version flaked under full-
        suite load: 0.4s TTLs + fixed sleeps meant a stalled beat thread
        could age a LIVE lease past expiry and poison the wrong rank).
        Live leases now carry a 30s TTL — only the lease we deliberately
        stop can ever expire (its ttl is shrunk via the payload right
        before the stop, since the monitor honors per-lease ttl) — and
        every phase gates on observed store/monitor state instead of
        sleeping a wall-clock budget."""
        poisons = []
        h0 = HeartbeatLease(master, "hb/0", ttl=30.0, interval=0.05).start()
        h1 = HeartbeatLease(master, "hb/1", ttl=30.0, interval=0.05).start()
        mon = LeaseMonitor(master, 2, ttl=30.0, straggler_after=0.3,
                           poison_fn=lambda **kw: poisons.append(kw))
        h0.note_step(1)
        h1.note_step(1)
        t1 = time.time()  # upper bound on h1's step-stamp age start
        assert _wait_for(  # both stamps visible in the store
            lambda: (json.loads(master.get("hb/0")).get("step") == 1
                     and json.loads(master.get("hb/1")).get("step") == 1))
        assert mon.scan_once() == {"dead": [], "stragglers": [], "slow": []}
        # rank 1 keeps heartbeating but stops stepping → straggler,
        # observed not poisoned; rank 0 keeps stepping.  Event-gated: step
        # h0 inside the poll until the monitor flags exactly rank 1.
        step = [1]

        def h1_flagged_straggler():
            step[0] += 1
            h0.note_step(step[0])
            if time.time() - t1 <= mon.straggler_after:
                return False  # h1's stamp cannot be stale yet
            found = mon.scan_once()
            assert found["dead"] == []  # 30s ttl: nothing may die here
            return found["stragglers"] == [1]

        assert _wait_for(h1_flagged_straggler, timeout=20, interval=0.05)
        assert poisons == []
        # rank 1's heartbeat dies entirely → dead → poisoned with culprit:
        # shrink ITS ttl (payload write confirmed in-store), then stop it
        h1.update_payload(ttl=0.4)
        assert _wait_for(
            lambda: json.loads(master.get("hb/1")).get("ttl") == 0.4)
        h1.stop()
        assert _wait_for(lambda: mon.scan_once()["dead"] == [1], timeout=20)
        assert poisons and poisons[0]["reason"] == "lease_expired"
        assert poisons[0]["culprit"] == 1
        # poisoning is once per dead rank, not once per scan
        mon.scan_once()
        assert len(poisons) == 1
        h0.stop()

    def test_never_registered_rank_is_not_poisoned(self, master):
        poisons = []
        mon = LeaseMonitor(master, 4, ttl=0.2,
                           poison_fn=lambda **kw: poisons.append(kw))
        h0 = HeartbeatLease(master, "hb/0", ttl=0.2, interval=0.05).start()
        time.sleep(0.3)
        assert mon.scan_once()["dead"] == []  # ranks 1-3 never joined
        assert poisons == []
        h0.stop()


class TestPoisonProtocol:
    def _domain(self, store, rank, world=2, **kw):
        kw.setdefault("hb_interval", 0.1)
        kw.setdefault("hb_ttl", 1.0)
        kw.setdefault("poison_poll", 0.05)
        kw.setdefault("monitor", False)
        return FaultDomain(store, rank, world, **kw)

    def test_first_writer_wins_and_check(self, master):
        aborts = []
        d = self._domain(master, 0, on_abort=aborts.append)
        assert d.check_poison() is None
        assert d.poison("watchdog_hang", culprit=0, detail="allreduce") is True
        assert d.poison("health_escalation", culprit=1) is False  # lost race
        doc = d.check_poison()
        assert doc["reason"] == "watchdog_hang" and doc["culprit"] == 0

    def test_epoch_scoping_isolates_pills(self, master):
        d1 = self._domain(master, 0, epoch=1)
        d2 = self._domain(master, 0, epoch=2)
        d1.poison("rank_exit", culprit=3)
        assert d1.check_poison() is not None
        assert d2.check_poison() is None  # the relaunched gang is clean
        d2.clear_poison(epoch=1)
        assert d1.check_poison() is None

    def test_poll_aborts_all_members(self, master):
        aborts = []
        c1 = TCPStore("127.0.0.1", master.port, timeout=10.0)
        d0 = self._domain(master, 0,
                          on_abort=lambda doc: aborts.append((0, doc)))
        d1 = self._domain(c1, 1,
                          on_abort=lambda doc: aborts.append((1, doc)))
        d0.start()
        d1.start()
        try:
            d1.poison("rank_exit", culprit=1, detail="exit -9")
            assert _wait_for(lambda: len(aborts) == 2, timeout=5)
            assert d0.aborted and d1.aborted
            assert {r for r, _ in aborts} == {0, 1}
            assert all(doc["culprit"] == 1 for _, doc in aborts)
        finally:
            d0.stop()
            d1.stop()
            c1.close()

    def test_monitor_converts_dead_lease_to_gang_abort(self, master):
        """The tentpole loop in-process: rank 1 goes silent → rank-0's
        monitor poisons → every member aborts within the poll bound."""
        aborts = []
        c1 = TCPStore("127.0.0.1", master.port, timeout=10.0)
        d0 = FaultDomain(master, 0, 2, hb_interval=0.05, hb_ttl=0.4,
                         poison_poll=0.05, monitor=True,
                         on_abort=lambda doc: aborts.append((0, doc)))
        d1 = FaultDomain(c1, 1, 2, hb_interval=0.05, hb_ttl=0.4,
                         poison_poll=0.05, monitor=False,
                         on_abort=lambda doc: aborts.append((1, doc)))
        d0.start()
        d1.start()
        try:
            d1.note_step(3)
            d1.lease.stop()  # alive process, dead heartbeat
            assert _wait_for(lambda: len(aborts) == 2, timeout=8)
            doc = d0.last_poison
            assert doc["reason"] == "lease_expired" and doc["culprit"] == 1
        finally:
            d0.stop()
            d1.stop()
            c1.close()

    def test_gang_barrier_deadline_names_missing_ranks(self, master):
        d = self._domain(master, 0, world=3)
        with pytest.raises(TimeoutError) as ei:
            d.gang_barrier(timeout=0.4)
        assert "missing ranks" in str(ei.value)
        assert "1" in str(ei.value) and "2" in str(ei.value)


class TestDetectorWiring:
    def test_watchdog_timeout_poisons_the_gang(self, master):
        aborts, infos = [], []
        fd = FaultDomain(master, 0, 2, hb_interval=0.1, hb_ttl=5.0,
                         poison_poll=0.05, monitor=False,
                         on_abort=aborts.append)
        fd.start()
        wd = CommWatchdog(timeout=0.2, poll_interval=0.05,
                          fault_domain=fd, on_timeout=infos.append)
        try:
            with wd.watch("hung_allreduce"):
                time.sleep(0.6)
            doc = fd.check_poison()
            assert doc is not None and doc["reason"] == "watchdog_hang"
            assert doc["culprit"] == 0
            assert infos and infos[0].get("poisoned") is True
            # ... and the poisoned member aborted through its poll
            assert _wait_for(lambda: fd.aborted, timeout=5)
        finally:
            wd.stop()
            fd.stop()

    def test_watchdog_loop_polls_poison_for_wedged_ranks(self, master):
        """A rank parked inside a watchdog-wrapped wait has no chance to
        call poll itself — the watchdog monitor loop must do it. The domain
        here is NOT started (no poll thread of its own), so only the
        watchdog loop can observe the pill."""
        aborts = []
        fd = FaultDomain(master, 1, 2, monitor=False, on_abort=aborts.append)
        wd = CommWatchdog(timeout=60.0, poll_interval=0.05, fault_domain=fd)
        wd.start()
        try:
            fd.poison("rank_exit", culprit=0)
            # ``aborted`` flips before the recorder dump and the handler run
            # on the watchdog's thread: wait for the handler itself
            assert _wait_for(lambda: aborts, timeout=5)
            assert fd.aborted and aborts[0]["culprit"] == 0
        finally:
            wd.stop()
            fd.stop()

    def test_health_escalation_poisons_current_domain(self, master):
        """The default exit path (SystemExit 101 for the supervisor) is
        gang-fatal: the pill lands before the raise so siblings rewind to
        the same checkpoint."""
        aborts = []
        fd = FaultDomain(master, 0, 2, monitor=False, on_abort=aborts.append)
        fd.start()  # registers as the process-current domain
        try:
            guard = HealthGuard(
                HealthPolicy(escalate_after=1, window=10, max_lag=0))
            with pytest.raises(SystemExit) as ei:
                guard.observe_host(1, float("nan"))
            assert ei.value.code == 101
            doc = fd.check_poison()
            assert doc is not None
            assert doc["reason"] == "health_escalation"
            assert doc["culprit"] == 0
        finally:
            fd.stop()

    def test_health_callable_handler_keeps_control_no_poison(self, master):
        """A callable on_escalate owns the recovery decision — the guard
        must NOT poison the gang out from under it."""
        fd = FaultDomain(master, 0, 2, epoch=9, monitor=False,
                         on_abort=lambda doc: None)
        fd.start()
        try:
            handled = []
            guard = HealthGuard(
                HealthPolicy(escalate_after=1, window=10, max_lag=0),
                on_escalate=handled.append)
            guard.observe_host(1, float("nan"))
            assert len(handled) == 1
            assert fd.check_poison() is None
        finally:
            fd.stop()


class TestElasticUnifiedHeartbeat:
    def test_manager_heartbeats_through_the_shared_lease(self, tmp_path):
        m = ElasticManager(FileStore(str(tmp_path)), job_id="j", np=1,
                           host="h0", ttl=1.0)
        assert isinstance(m._lease, HeartbeatLease)
        assert m.hosts() == ["h0"]
        age0 = m.store.age("j/nodes/h0")
        assert age0 < 1.0
        m.exit()
        assert m.store.get("j/nodes/h0") is None  # lease released

    def test_transitions_emit_elastic_events(self, tmp_path):
        rec = telemetry.get_flight_recorder()
        since = time.perf_counter_ns()  # the recorder's mono_ns clock
        m = ElasticManager(FileStore(str(tmp_path)), job_id="j", np=1,
                           host="h0", ttl=5.0)
        assert m.watch_once() == ElasticStatus.RESTART
        m.commit_world()
        assert m.watch_once() == ElasticStatus.HOLD  # steady: no event
        m.exit(completed=True)
        kinds = [e["kind"] for e in rec.events(since_mono_ns=since)]
        assert "elastic_restart" in kinds
        assert "elastic_exit" in kinds
        assert "elastic_hold" not in kinds


# -- tests/test_elastic_watchdog.py: the file store and the elastic manager --

class TestFileStore:
    def test_put_get_delete_keys(self, tmp_path):
        st = FileStore(str(tmp_path))
        st.put("job/nodes/a", {"x": 1})
        assert st.get("job/nodes/a") == {"x": 1}
        st.put("job/world", ["a"])
        assert sorted(st.keys("job/nodes/")) == ["job/nodes/a"]
        st.delete("job/nodes/a")
        assert st.get("job/nodes/a") is None

    def test_age_and_touch(self, tmp_path):
        st = FileStore(str(tmp_path))
        st.put("k", 1)
        assert st.age("k") < 5
        assert st.age("missing") == float("inf")


def mk_manager(tmp_path, host, np=1, ttl=60.0, **kw):
    return ElasticManager(FileStore(str(tmp_path)), job_id="j", np=np,
                          host=host, ttl=ttl, **kw)


class TestElasticManager:
    def test_np_parsing_and_level(self, tmp_path):
        m = mk_manager(tmp_path, "h0", np="2:4")
        assert (m.np_min, m.np_max) == (2, 4)
        assert m.elastic_level == ElasticLevel.ELASTIC
        m2 = mk_manager(tmp_path, "h1", np=2)
        assert m2.elastic_level == ElasticLevel.FAULT_TOLERANCE
        m.exit()
        m2.exit()

    def test_registration_and_membership(self, tmp_path):
        m0 = mk_manager(tmp_path, "h0", np=2)
        assert m0.hosts() == ["h0"]
        assert not m0.ready()
        assert m0.watch_once() == ElasticStatus.HOLD  # under-provisioned
        m1 = mk_manager(tmp_path, "h1", np=2)
        assert m0.hosts() == ["h0", "h1"]
        assert m0.ready()
        # quorum reached, no world committed yet → (re)start
        assert m0.watch_once() == ElasticStatus.RESTART
        m0.commit_world()
        assert m0.watch_once() == ElasticStatus.HOLD  # steady
        m0.exit()
        m1.exit()

    def test_peer_death_triggers_restart_and_pre_hook(self, tmp_path):
        saved = []
        m0 = mk_manager(tmp_path, "h0", np="1:2", ttl=0.6,
                        pre_hook=lambda: saved.append("ckpt"))
        m1 = mk_manager(tmp_path, "h1", np="1:2", ttl=0.6)
        m0.commit_world()
        assert m0.watch_once() == ElasticStatus.HOLD
        m1.exit()  # peer leaves (deletes its node key)
        status = m0.watch(interval=0.1, max_wait=5)
        assert status == ElasticStatus.RESTART
        assert saved == ["ckpt"]
        m0.exit()

    def test_scale_out_triggers_restart(self, tmp_path):
        m0 = mk_manager(tmp_path, "h0", np="1:4")
        m0.commit_world()
        assert m0.watch_once() == ElasticStatus.HOLD
        m1 = mk_manager(tmp_path, "h1", np="1:4")
        assert m0.watch_once() == ElasticStatus.RESTART
        # after restart the world is recommitted → steady again
        m0.commit_world()
        assert m0.watch_once() == ElasticStatus.HOLD
        m0.exit()
        m1.exit()

    def test_completed_flag(self, tmp_path):
        m0 = mk_manager(tmp_path, "h0", np=1)
        m0.commit_world()
        m0.exit(completed=True)
        m1 = mk_manager(tmp_path, "h1", np=1)
        assert m1.watch_once() == ElasticStatus.COMPLETED
        m1.exit()

    def test_hold_timeout_errors(self, tmp_path):
        m0 = mk_manager(tmp_path, "h0", np=3, timeout=0.5)
        m0.commit_world()
        assert m0.watch(interval=0.1) == ElasticStatus.ERROR
        m0.exit()

    def test_stale_heartbeat_counts_as_dead(self, tmp_path):
        st = FileStore(str(tmp_path))
        m0 = ElasticManager(st, job_id="j", np="1:2", host="h0", ttl=0.5)
        # fake peer that never heartbeats: backdate its mtime
        st.put("j/nodes/ghost", {"host": "ghost"})
        path = st._path("j/nodes/ghost")
        old = time.time() - 10
        os.utime(path, (old, old))
        assert m0.hosts() == ["h0"]  # ghost is stale
        m0.exit()


# -- the port's wiring: "current", the init_parallel_env join, the launcher --

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCurrentDomain:
    def test_watchdog_current_resolves_the_started_domain(self, master):
        """``CommWatchdog(fault_domain="current")`` resolves the
        process-global domain at every tick: a hang poisons the domain
        that ``start`` made current, and a pill from elsewhere aborts it
        through the watchdog's loop."""
        from paddle_tpu_torch.distributed.fleet import fault_domain as fd_mod

        infos, aborts = [], []
        wd = CommWatchdog(timeout=0.2, poll_interval=0.05, fault_domain="current",
                          on_timeout=infos.append)
        fd = FaultDomain(master, 0, 2, hb_interval=0.1, hb_ttl=5.0, poison_poll=30.0,
                         monitor=False, on_abort=aborts.append)
        fd.start()
        try:
            assert fd_mod.current() is fd and wd._resolve_domain() is fd
            with wd.watch("hung_allreduce"):
                time.sleep(0.6)
            assert infos and infos[0].get("poisoned") is True
            doc = fd.check_poison()
            assert doc["reason"] == "watchdog_hang" and doc["culprit"] == 0
            assert _wait_for(lambda: fd.aborted, timeout=5)
        finally:
            wd.stop()
            fd.stop()
        assert fd_mod.current() is None and wd._resolve_domain() is None


_JOIN_PAYLOAD = textwrap.dedent("""
    import os, time
    import torch
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import fault_domain

    ptt.set_device("cpu")
    assert os.environ.get("PADDLE_TPU_FLEET_STORE"), "no fleet store exported"
    assert os.environ.get("PADDLE_TPU_FLEET_MONITOR") == "launcher"
    dist.init_parallel_env()
    d = fault_domain.current()
    rank = dist.get_rank()
    assert d is not None and d.rank == rank and d.world_size == 2, d
    t = torch.full((2,), float(rank + 1))
    dist.all_reduce(t)
    assert t.tolist() == [3.0, 3.0], t
    # the lease carries the step notes the train step sends
    fault_domain.note_step_current(5, dt=0.01)
    deadline = time.time() + 20
    key = "fleet/%s/hb/%d" % (os.environ.get("PADDLE_JOB_ID", "default"), rank)
    while time.time() < deadline and d._store.age(key) is None:
        time.sleep(0.05)
    assert d._store.age(key) is not None
    dist.barrier()
    print("JOIN OK rank", rank, "beats", d.lease.beats, flush=True)
""")

_PILL_PAYLOAD = textwrap.dedent("""
    import os, time
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import fault_domain

    ptt.set_device("cpu")
    dist.init_parallel_env()
    if dist.get_rank() == 1:
        fault_domain.poison_current("health_escalation", detail="test pill")
    time.sleep(60)      # rank 0 wedges: only the pill ends it
""")


def _launch(tmp_path, payload, timeout=90, env=None):
    script = tmp_path / "payload.py"
    script.write_text(payload)
    full = os.environ.copy()
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
              "PADDLE_LOCAL_RANK", "PADDLE_NPROC_PER_NODE", "PADDLE_TPU_FAULT_DOMAIN",
              "PADDLE_TPU_FLEET_STORE"):
        full.pop(k, None)
    full.update(env or {})
    full["PYTHONPATH"] = ROOT + os.pathsep + full.get("PYTHONPATH", "")
    log_dir = tmp_path / "log"
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--nproc_per_node",
         "2", "--log_dir", str(log_dir), str(script)],
        env=full, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    logs = {p.name: p.read_text() for p in log_dir.glob("workerlog.*")}
    return proc, logs, log_dir


class TestLauncherFaultDomain:
    def test_default_on_and_init_parallel_env_joins(self, tmp_path):
        """The launcher's default (no flag, no variable) hosts the fleet
        store; each of two gloo workers joins the domain in
        ``init_parallel_env`` and heartbeats into its lease."""
        proc, logs, _ = _launch(tmp_path, _JOIN_PAYLOAD)
        assert proc.returncode == 0, f"{proc.stderr}\n{logs}"
        for name, text in logs.items():
            assert "JOIN OK rank" in text, f"{name}: {text[-2000:]}"

    def test_a_ranks_pill_tears_the_pod_down(self, tmp_path):
        """A pill written by a rank (here a health escalation) ends the
        wedged sibling: the pod exits 101 in bounded time and the launcher
        keeps the poison doc in ``poison.json``."""
        t0 = time.time()
        proc, logs, log_dir = _launch(tmp_path, _PILL_PAYLOAD, env={
            "PADDLE_TPU_TEARDOWN_GRACE": "2", "PADDLE_TPU_POISON_POLL": "0.1",
            "PADDLE_TPU_ABORT_DEADLINE": "3"})
        assert proc.returncode == 101, f"{proc.stderr}\n{logs}"
        assert time.time() - t0 < 45
        doc = json.load(open(log_dir / "poison.json"))
        assert doc["reason"] == "health_escalation" and doc["culprit"] == 1

    def test_fault_domain_off_exports_no_store(self, tmp_path):
        payload = textwrap.dedent("""
            import os
            assert "PADDLE_TPU_FLEET_STORE" not in os.environ
            print("OFF OK", flush=True)
        """)
        proc, logs, _ = _launch(tmp_path, payload, env={"PADDLE_TPU_FAULT_DOMAIN": "0"})
        assert proc.returncode == 0, f"{proc.stderr}\n{logs}"
        assert all("OFF OK" in t for t in logs.values()) and len(logs) == 2
