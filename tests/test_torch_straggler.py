"""The straggler ladder of the port (ROADMAP A7b), from the reference's
``tests/test_straggler.py``: straggler confirmation, chip-vs-link
localisation and the slow-rank remediation ladder, on the port's copies of
the framework-free modules (``distributed/retry``, ``fleet/fault_domain``,
``fleet/elastic/gang``, ``health/straggler``).

- per-rank step wall time rides the heartbeat payload as a ``step_dt_ema``
  and the ``LeaseMonitor`` flags a rank whose EMA exceeds the gang median
  by the straggler factor for N consecutive scans;
- the flagged rank and one healthy control rank publish micro-probe docs
  through the fleet store and classify deterministically: chip-slow,
  link-slow, or transient (chip first);
- sticky chip-slow answers with the quarantine path (poison
  ``straggler_suspect`` → exclude-list relaunch minus the slot); sticky
  link-slow with a device-order remap (``PADDLE_TPU_DEVICE_ORDER``);
- the backoff-with-jitter single home (``distributed/retry``) and the
  ``slow`` fault family;
- chaos: a 4-rank gang whose rank 2 turns 3x-slow mid-run is flagged,
  probe-confirmed sticky chip-slow and quarantined, and the relaunched
  3-rank gang's trajectory is step for step the analytic fault-free run.
  The reference's transient and link chaos runs are left out (their
  units above cover the verdicts); serving's latency-outlier ejection is
  held by ``test_torch_autoscale.py`` (the reference's
  ``test_straggler_serving.py``).
"""

import json
import os
import random
import textwrap
import time

import numpy as np
import pytest


from paddle_tpu_torch.distributed.checkpoint import faults
from paddle_tpu_torch.distributed.fleet import fault_domain as fd_mod
from paddle_tpu_torch.distributed.fleet.fault_domain import (HeartbeatLease,
                                                       LeaseMonitor)
from paddle_tpu_torch.distributed.fleet.elastic import (FleetSupervisor, GangPolicy,
                                                  RestartPolicy)
from paddle_tpu_torch.distributed.fleet.elastic.gang import ring_order_avoiding
from paddle_tpu_torch.distributed.health.straggler import (STRAGGLER_EXIT_CODE,
                                                     STRAGGLER_LINK_REASON,
                                                     STRAGGLER_POISON_REASON,
                                                     StragglerMonitor,
                                                     StragglerPolicy,
                                                     classify_probes,
                                                     pick_control,
                                                     ring_neighbors,
                                                     straggler_enabled)
from paddle_tpu_torch.distributed.retry import BackoffPolicy, retry_call

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- fakes -------------------------------------------------------------------

class KV:
    """put/touch/age KV with hand-cranked ages (fake clock)."""

    def __init__(self):
        self.data = {}
        self.ages = {}

    def put(self, k, v):
        self.data[k] = v
        self.ages[k] = 0.0

    def get(self, k):
        return self.data.get(k)

    def touch(self, k):
        self.ages[k] = 0.0

    def delete(self, k):
        self.data.pop(k, None)
        self.ages.pop(k, None)

    def keys(self, prefix=""):
        return [k for k in self.data if k.startswith(prefix)]

    def age(self, k):
        return self.ages.get(k)


class _Domain:
    """FaultDomain stand-in for StragglerMonitor units."""

    def __init__(self, kv, rank, world_size, epoch=0):
        self._kv = kv
        self.rank = rank
        self.world_size = world_size
        self.epoch = epoch
        self.steps = []
        self.poisons = []

    def note_step(self, step, dt=None):
        self.steps.append((step, dt))

    def poison(self, reason, culprit=None, detail="", **extra):
        self.poisons.append(dict(reason=reason, culprit=culprit,
                                 detail=detail, **extra))
        return True


# -- the backoff single home -------------------------------------------------

class TestBackoffPolicy:
    def test_delay_formula_seeded(self):
        p = BackoffPolicy(base=0.5, cap=60.0, jitter=0.25, seed=7)
        for attempt in range(6):
            u = random.Random(7 * 1_000_003 + attempt + 1).random()
            expect = min(60.0, 0.5 * 2 ** attempt) * (1 + 0.25 * u)
            assert p.delay(attempt) == pytest.approx(expect)

    def test_cap_and_zero_jitter(self):
        p = BackoffPolicy(base=1.0, cap=4.0, jitter=0.0)
        assert [p.delay(a) for a in range(5)] == [1.0, 2.0, 4.0, 4.0, 4.0]

    def test_supervisor_stream_unchanged(self):
        # RestartPolicy's historical 1-based restart_num stream must fall
        # out of the shared policy's 0-based delay(n - 1) unchanged
        rp = RestartPolicy(backoff_base=0.3, backoff_cap=10.0,
                           jitter=0.5, seed=11)
        bp = BackoffPolicy(base=0.3, cap=10.0, jitter=0.5, seed=11)
        for n in range(1, 6):
            assert rp.delay(n) == pytest.approx(bp.delay(n - 1))

    def test_explicit_rng_wins_over_seed(self):
        p = BackoffPolicy(base=1.0, cap=8.0, jitter=1.0, seed=3)
        u = random.Random(99).random()
        got = p.delay(0, rng=random.Random(99))
        assert got == pytest.approx(1.0 * (1 + u))


class TestRetryCall:
    def test_absorbs_then_succeeds(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("flake")
            return "ok"

        slept = []
        seen = []
        out = retry_call(flaky, attempts=5,
                         policy=BackoffPolicy(base=0.01, cap=0.02,
                                              jitter=0.0),
                         on_retry=lambda a, e, d: seen.append((a, d)),
                         sleep=slept.append)
        assert out == "ok" and calls["n"] == 3
        assert seen == [(0, 0.01), (1, 0.02)]
        assert slept == [0.01, 0.02]

    def test_exhausted_raises_last(self):
        def bad():
            raise OSError("always")

        with pytest.raises(OSError, match="always"):
            retry_call(bad, attempts=3, policy=None, sleep=lambda s: None)

    def test_raise_now_beats_retry_on(self):
        calls = {"n": 0}

        def gone():
            calls["n"] += 1
            raise FileNotFoundError("nope")

        # FileNotFoundError IS an OSError, but raise_now wins on the
        # first occurrence — a missing checkpoint must never be retried
        with pytest.raises(FileNotFoundError):
            retry_call(gone, attempts=5, retry_on=(OSError,),
                       raise_now=(FileNotFoundError,), policy=None)
        assert calls["n"] == 1

    def test_no_policy_means_immediate_retry(self):
        slept = []
        seen = []

        def bad():
            raise OSError("x")

        with pytest.raises(OSError):
            retry_call(bad, attempts=2, policy=None, sleep=slept.append,
                       on_retry=lambda a, e, d: seen.append(d))
        assert slept == [] and seen == [0.0]

    def test_bad_attempts_rejected(self):
        with pytest.raises(ValueError):
            retry_call(lambda: 1, attempts=0)


# -- the slow fault family ---------------------------------------------------

class TestSlowFaults:
    def test_slow_family_spec_matches_every_seam(self):
        with faults.inject(op="slow", pattern="*", mode="delay",
                           delay_s=0.0, times=-1) as spec:
            faults.fire("slow_step", "rank1")
            faults.fire("slow_collective", "link0-1")
            faults.fire("slow_serve", "r0/decode")
            faults.fire("write", "x.distcp")   # not a slow_* seam
        assert spec.fired == 3

    def test_full_path_glob_covers_step_and_probe(self):
        # "rank2*" must hit both the step seam ("rank2") and the probe
        # seam ("rank2/probe") — a sticky slow chip degrades its own
        # probe, which is what makes the probe CONFIRM it
        with faults.inject(op="slow_step", pattern="rank2*", mode="delay",
                           delay_s=0.0, times=-1) as spec:
            faults.fire("slow_step", "rank2")
            faults.fire("slow_step", "rank2/probe")
            faults.fire("slow_step", "rank3")
            faults.fire("slow_step", "rank3/probe")
        assert spec.fired == 2

    def test_delay_range_is_seeded_per_fire(self):
        lo, hi = 0.001, 0.004
        s1 = faults.FaultSpec(op="slow_step", mode="delay",
                              delay_s=(lo, hi), seed=9)
        s2 = faults.FaultSpec(op="slow_step", mode="delay",
                              delay_s=(lo, hi), seed=9)
        draws = []
        for fired in (1, 2, 3):
            s1.fired = s2.fired = fired
            d1, d2 = s1._delay(), s2._delay()
            assert d1 == d2 == random.Random(
                9 * 1_000_003 + fired).uniform(lo, hi)
            assert lo <= d1 <= hi
            draws.append(d1)
        assert len(set(draws)) == 3     # per-fire draws differ

    def test_scalar_delay_unchanged(self):
        s = faults.FaultSpec(op="slow_step", mode="delay", delay_s=0.125)
        s.fired = 5
        assert s._delay() == 0.125

    def test_bad_range_rejected(self):
        with pytest.raises(ValueError, match="lo <= hi"):
            faults.FaultSpec(op="slow_step", mode="delay",
                             delay_s=(0.5, 0.1))


# -- detect: heartbeat EMA + lease-monitor median flag -----------------------

class TestHeartbeatStepEMA:
    def _payload(self, kv, key):
        return kv.get(key)

    def test_ema_blends_at_alpha(self):
        kv = KV()
        l = HeartbeatLease(kv, "hb/0", ttl=5.0, payload={"rank": 0})
        l.note_step(1, dt=1.0)
        l.beat_now()
        assert self._payload(kv, "hb/0")["step_dt_ema"] == 1.0
        l.note_step(2, dt=2.0)
        l.beat_now()
        doc = self._payload(kv, "hb/0")
        assert doc["step"] == 2
        assert doc["step_dt_ema"] == pytest.approx(0.75 * 1.0 + 0.25 * 2.0)

    def test_no_dt_no_ema(self):
        kv = KV()
        l = HeartbeatLease(kv, "hb/1", ttl=5.0)
        l.note_step(3)
        l.beat_now()
        assert "step_dt_ema" not in kv.get("hb/1")

    def test_negative_dt_ignored(self):
        kv = KV()
        l = HeartbeatLease(kv, "hb/2", ttl=5.0)
        l.note_step(1, dt=0.5)
        l.note_step(2, dt=-1.0)
        l.beat_now()
        assert kv.get("hb/2")["step_dt_ema"] == 0.5


class TestLeaseMonitorSlowFlag:
    def _mon(self, kv, world=4, **kw):
        kw.setdefault("ttl", 10.0)
        kw.setdefault("slow_factor", 2.0)
        kw.setdefault("slow_scans", 2)
        kw.setdefault("straggler_after", 0.0)   # legacy path off here
        return LeaseMonitor(kv, world, **kw)

    def _leases(self, kv, emas):
        now = time.time()
        for rank, ema in emas.items():
            doc = {"rank": rank, "step": 10, "step_ts": now, "ttl": 10.0}
            if ema is not None:
                doc["step_dt_ema"] = ema
            kv.put(f"hb/{rank}", doc)

    def test_flags_after_consecutive_scans_once_per_episode(self):
        kv = KV()
        flagged = []
        mon = self._mon(kv, slow_fn=lambda r, e, m: flagged.append((r, e, m)))
        self._leases(kv, {0: 0.1, 1: 0.1, 2: 0.5, 3: 0.1})
        assert mon.scan_once()["slow"] == []      # streak 1: hysteresis
        assert flagged == []
        assert mon.scan_once()["slow"] == [2]     # streak 2: flagged
        assert len(flagged) == 1
        r, ema, median = flagged[0]
        assert r == 2 and ema == 0.5 and median == pytest.approx(0.1)
        # still slow on later scans: listed, but the flag fires once
        assert mon.scan_once()["slow"] == [2]
        assert len(flagged) == 1

    def test_one_scan_spike_resets_streak(self):
        kv = KV()
        flagged = []
        mon = self._mon(kv, slow_fn=lambda r, e, m: flagged.append(r))
        self._leases(kv, {0: 0.1, 1: 0.1, 2: 0.5, 3: 0.1})
        mon.scan_once()                            # streak 1
        self._leases(kv, {0: 0.1, 1: 0.1, 2: 0.1, 3: 0.1})
        mon.scan_once()                            # back under: reset
        self._leases(kv, {0: 0.1, 1: 0.1, 2: 0.5, 3: 0.1})
        assert mon.scan_once()["slow"] == []       # streak restarts at 1
        assert mon.scan_once()["slow"] == [2]
        assert flagged == [2]

    def test_uniformly_slow_gang_never_flags(self):
        kv = KV()
        flagged = []
        mon = self._mon(kv, slow_fn=lambda r, e, m: flagged.append(r))
        self._leases(kv, {r: 30.0 for r in range(4)})   # big model, cold
        for _ in range(5):
            assert mon.scan_once()["slow"] == []
        assert flagged == []

    def test_fewer_than_three_emas_no_median_no_flag(self):
        kv = KV()
        flagged = []
        mon = self._mon(kv, world=2,
                        slow_fn=lambda r, e, m: flagged.append(r))
        self._leases(kv, {0: 0.1, 1: 5.0})
        for _ in range(4):
            assert mon.scan_once()["slow"] == []
        assert flagged == []

    def test_recovery_unflags_and_requires_full_streak_again(self):
        kv = KV()
        flagged = []
        mon = self._mon(kv, slow_fn=lambda r, e, m: flagged.append(r))
        self._leases(kv, {0: 0.1, 1: 0.1, 2: 0.5, 3: 0.1})
        mon.scan_once()
        mon.scan_once()
        assert flagged == [2]
        self._leases(kv, {0: 0.1, 1: 0.1, 2: 0.1, 3: 0.1})
        assert mon.scan_once()["slow"] == []       # recovered
        self._leases(kv, {0: 0.1, 1: 0.1, 2: 0.5, 3: 0.1})
        assert mon.scan_once()["slow"] == []       # new episode: streak 1
        assert mon.scan_once()["slow"] == [2]
        assert flagged == [2, 2]                   # re-flag = new event

    def test_dead_rank_excluded_from_median(self):
        kv = KV()
        mon = self._mon(kv, poison_fn=lambda **kw: None)
        self._leases(kv, {0: 0.1, 1: 0.1, 2: 0.5, 3: 50.0})
        kv.ages["hb/3"] = 100.0                    # rank 3's lease expired
        out = mon.scan_once()
        assert out["dead"] == [3]
        out = mon.scan_once()
        # the dead rank's huge EMA must not drag the median up and mask
        # the live straggler
        assert out["slow"] == [2]

    def test_legacy_stale_step_straggler_path_still_works(self):
        kv = KV()
        mon = LeaseMonitor(kv, 4, ttl=10.0, straggler_after=5.0,
                           slow_scans=2)
        now = time.time()
        for rank in range(4):
            kv.put(f"hb/{rank}", {"rank": rank, "step": 20,
                                  "step_ts": now, "ttl": 10.0})
        kv.put("hb/2", {"rank": 2, "step": 3, "step_ts": now - 60.0,
                        "ttl": 10.0})
        out = mon.scan_once()
        assert out["stragglers"] == [2] and out["dead"] == []


# -- policy / probe classification -------------------------------------------

class TestStragglerPolicy:
    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_STRAGGLER_FACTOR", "3.5")
        monkeypatch.setenv("PADDLE_TPU_STRAGGLER_SCANS", "4")
        monkeypatch.setenv("PADDLE_TPU_STRAGGLER_EVERY", "16")
        monkeypatch.setenv("PADDLE_TPU_STRAGGLER_PROBE_TIMEOUT", "2.5")
        p = StragglerPolicy.from_env()
        assert (p.factor, p.scans, p.every, p.probe_timeout) == \
            (3.5, 4, 16, 2.5)

    def test_floors(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_STRAGGLER_FACTOR", "0.1")
        monkeypatch.setenv("PADDLE_TPU_STRAGGLER_SCANS", "0")
        monkeypatch.setenv("PADDLE_TPU_STRAGGLER_EVERY", "-3")
        p = StragglerPolicy.from_env()
        assert p.factor == 1.0 and p.scans == 1 and p.every == 1

    def test_enable_gate(self, monkeypatch):
        assert straggler_enabled()
        monkeypatch.setenv("PADDLE_TPU_STRAGGLER", "0")
        assert not straggler_enabled()


class TestClassifyProbes:
    def test_chip_named_from_probe_ratio(self):
        v, detail = classify_probes({"chip_s": 0.9, "link_s": {}},
                                    {"chip_s": 0.1}, 2.0)
        assert v == "chip" and detail["ratio"] == pytest.approx(9.0)

    def test_chip_checked_before_link(self):
        # a slow chip also slows its link probes: chip must win even when
        # the link ratios would clear the factor too
        v, _ = classify_probes(
            {"chip_s": 0.9, "link_s": {"1": 0.9, "3": 0.1}},
            {"chip_s": 0.1}, 2.0)
        assert v == "chip"

    def test_link_named_when_chip_exonerated(self):
        v, detail = classify_probes(
            {"chip_s": 0.1, "link_s": {"1": 0.8, "3": 0.05}},
            {"chip_s": 0.1}, 2.0)
        assert v == "link"
        assert detail["peer"] == 1
        assert detail["ratio"] == pytest.approx(16.0)

    def test_transient_when_nothing_clears_factor(self):
        v, _ = classify_probes(
            {"chip_s": 0.12, "link_s": {"1": 0.01, "3": 0.009}},
            {"chip_s": 0.1}, 2.0)
        assert v == "transient"

    def test_single_link_measurement_cannot_name_a_link(self):
        v, _ = classify_probes({"chip_s": 0.1, "link_s": {"1": 5.0}},
                               {"chip_s": 0.1}, 2.0)
        assert v == "transient"

    def test_ring_helpers(self):
        assert ring_neighbors(0, 4) == (3, 1)
        assert ring_neighbors(3, 4) == (2, 0)
        # control is never the flagged rank or a ring neighbor (neighbors
        # share the possibly-degraded link)
        assert pick_control(2, 4) == 0
        assert pick_control(0, 4) == 2
        # world 3: everyone is a neighbor; fall back to any other rank
        assert pick_control(1, 3) == 0


# -- the monitor: flag → probe → verdict → remediation -----------------------

class TestStragglerMonitorProtocol:
    def _mon(self, kv, rank, world=4, chip=0.05, links=None, **kw):
        dom = _Domain(kv, rank, world)
        pol = StragglerPolicy(factor=2.0, scans=2, every=2,
                              probe_timeout=2.0)
        links = links or {}
        mon = StragglerMonitor(
            pol, domain=dom,
            probe_fn=lambda r: chip,
            link_probe_fn=lambda r, p: links.get(p, 0.01), **kw)
        return mon, dom

    def _flag(self, kv, rank=2, seq=1):
        kv.put("straggler/flag/0", {"rank": rank, "seq": seq,
                                    "ema_s": 0.5, "median_s": 0.1})

    def test_chip_verdict_poisons_and_exits_101(self):
        kv = KV()
        self._flag(kv)
        kv.put("straggler/probe/0/1/0", {"rank": 0, "chip_s": 0.05})
        mon, dom = self._mon(kv, rank=2, chip=1.0)
        with pytest.raises(SystemExit) as ei:
            mon.on_step(2, dt=0.5)
        assert ei.value.code == STRAGGLER_EXIT_CODE == 101
        assert mon.chip_suspects == 1
        assert mon.last_verdict["verdict"] == "chip"
        assert dom.poisons[0]["reason"] == STRAGGLER_POISON_REASON
        assert dom.poisons[0]["culprit"] == 2
        assert dom.steps == [(2, 0.5)]     # the stamp rode the same hook

    def test_link_verdict_poisons_with_the_pair(self):
        kv = KV()
        self._flag(kv)
        kv.put("straggler/probe/0/1/0", {"rank": 0, "chip_s": 0.05})
        mon, dom = self._mon(kv, rank=2, chip=0.05,
                             links={1: 1.0, 3: 0.01})
        with pytest.raises(SystemExit) as ei:
            mon.on_step(2, dt=0.5)
        assert ei.value.code == 101
        assert mon.link_suspects == 1
        assert dom.poisons[0]["reason"] == STRAGGLER_LINK_REASON
        assert dom.poisons[0]["link"] == [1, 2]

    def test_transient_counted_never_poisons(self):
        kv = KV()
        self._flag(kv)
        kv.put("straggler/probe/0/1/0", {"rank": 0, "chip_s": 0.05})
        mon, dom = self._mon(kv, rank=2, chip=0.06)
        mon.on_step(2)                      # no raise
        assert mon.transients == 1 and dom.poisons == []
        # the episode is handled: the same seq never re-probes
        mon.on_step(4)
        assert mon.probes_run == 1

    def test_incomplete_gather_retries_next_poll(self):
        kv = KV()
        self._flag(kv)
        mon, dom = self._mon(kv, rank=2, chip=0.06)
        mon.policy.probe_timeout = 0.15
        t0 = time.monotonic()
        mon.on_step(2)                      # control never published
        assert time.monotonic() - t0 < 2.0
        assert mon.votes_incomplete == 1 and dom.poisons == []
        # our doc landed; once the (late) control doc appears, the next
        # cadence poll must retry the SAME episode and classify
        assert kv.get("straggler/probe/0/1/2")["chip_s"] == 0.06
        kv.put("straggler/probe/0/1/0", {"rank": 0, "chip_s": 0.05})
        mon.on_step(4)
        assert mon.probes_run == 2
        assert mon.last_verdict["verdict"] == "transient"

    def test_control_rank_observes_never_remediates(self):
        kv = KV()
        self._flag(kv)
        kv.put("straggler/probe/0/1/2",
               {"rank": 2, "chip_s": 1.0, "link_s": {}})
        mon, dom = self._mon(kv, rank=0, chip=0.05)
        mon.on_step(2)                      # no raise
        assert mon.last_verdict["verdict"] == "chip"
        assert dom.poisons == [] and mon.chip_suspects == 0
        # the control's own probe doc was published for the flagged side
        assert kv.get("straggler/probe/0/1/0")["rank"] == 0

    def test_bystander_never_probes(self):
        kv = KV()
        self._flag(kv, rank=2)              # control will be rank 0
        mon, _ = self._mon(kv, rank=1)
        mon.on_step(2)
        assert mon.probes_run == 0

    def test_cadence_polls_only_every_n_steps(self):
        kv = KV()
        mon, _ = self._mon(kv, rank=0)
        mon.policy.every = 4
        mon.on_step(2)
        assert mon.checks == 0
        mon.on_step(4)
        assert mon.checks == 1

    def test_disabled_still_stamps_steps(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_STRAGGLER", "0")
        kv = KV()
        self._flag(kv)
        mon, dom = self._mon(kv, rank=2, chip=1.0)
        assert not mon.active
        mon.on_step(2, dt=0.4)              # no probe, no exit
        assert mon.checks == 0 and mon.probes_run == 0
        assert dom.steps == [(2, 0.4)]

    def test_pre_dt_domain_fallback(self):
        class OldDomain(_Domain):
            def note_step(self, step):      # rolling upgrade: no dt kwarg
                self.steps.append(step)

        kv = KV()
        mon = StragglerMonitor(StragglerPolicy(), domain=OldDomain(kv, 0, 4))
        mon.on_step(1, dt=0.5)
        assert mon.domain.steps == [1]

    def test_on_suspect_raise_mode(self):
        from paddle_tpu_torch.distributed.health.ledger import HealthError

        kv = KV()
        self._flag(kv)
        kv.put("straggler/probe/0/1/0", {"rank": 0, "chip_s": 0.05})
        mon, dom = self._mon(kv, rank=2, chip=1.0, on_suspect="raise")
        with pytest.raises(HealthError, match="chip-slow"):
            mon.on_step(2)
        assert dom.poisons == []

    def test_resume_anchor_tracks_newest_checkpoint(self):
        mon = StragglerMonitor(StragglerPolicy(), rank=0, world_size=1)
        assert mon.resume_anchor() == 0
        mon.note_checkpoint(4)
        mon.note_checkpoint(8)
        assert mon.resume_anchor() == 8


class TestFaultDomainFlagBroadcast:
    def test_note_slow_rank_bumps_seq(self):
        d = fd_mod.FaultDomain(KV(), rank=None, world_size=4, monitor=False)
        assert d.straggler_flag() is None
        d._note_slow_rank(2, 0.5, 0.1)
        flag = d.straggler_flag()
        assert flag["rank"] == 2 and flag["seq"] == 1
        assert flag["ema_s"] == 0.5 and flag["median_s"] == 0.1
        d._note_slow_rank(2, 0.6, 0.1)
        assert d.straggler_flag()["seq"] == 2   # new episode, new seq

    def test_note_step_current_tolerates_pre_dt_domain(self):
        class Old:
            def __init__(self):
                self.steps = []

            def note_step(self, step):
                self.steps.append(step)

        old = Old()
        fd_mod.set_current(old)
        try:
            fd_mod.note_step_current(7, dt=0.25)
        finally:
            fd_mod.set_current(None)
        assert old.steps == [7]


# -- remediation: ring remap + supervisor quarantine --------------------------

def _assert_ring_avoids(order, n, pairs):
    assert sorted(order) == list(range(n))
    adj = {tuple(sorted((order[i], order[(i + 1) % n])))
           for i in range(n)}
    for a, b in pairs:
        assert tuple(sorted((a, b))) not in adj, (order, (a, b))


class TestRingOrderAvoiding:
    def test_no_pairs_is_identity(self):
        assert ring_order_avoiding(4, []) == [0, 1, 2, 3]

    def test_single_pair_routed_out(self):
        for n in (4, 5, 8):
            order = ring_order_avoiding(n, [(0, 1)])
            _assert_ring_avoids(order, n, [(0, 1)])

    def test_wraparound_edge_counts(self):
        order = ring_order_avoiding(4, [(0, 3)])
        _assert_ring_avoids(order, 4, [(0, 3)])

    def test_three_ring_is_unavoidable(self):
        assert ring_order_avoiding(3, [(0, 1)]) is None

    def test_multiple_pairs(self):
        pairs = [(0, 1), (2, 3)]
        order = ring_order_avoiding(5, pairs)
        _assert_ring_avoids(order, 5, pairs)

    def test_overconstrained_returns_none(self):
        # node 0's only allowed neighbor is 3: no 4-ring exists
        assert ring_order_avoiding(4, [(0, 1), (2, 3), (0, 2)]) is None


def _fast_policy(**kw):
    kw.setdefault("max_gang_restarts", 1)
    return GangPolicy(backoff=RestartPolicy(backoff_base=0.01,
                                            backoff_cap=0.02), **kw)


def _poison(argv, doc):
    log_dir = argv[argv.index("--log_dir") + 1]
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "poison.json"), "w") as f:
        json.dump(doc, f)


class TestSupervisorStragglerRemediation:
    def test_chip_suspect_excludes_slot_fresh_budget(self, tmp_path):
        calls = []

        def fake_launch(argv, env):
            calls.append((list(argv), dict(env)))
            if len(calls) == 1:
                _poison(argv, {"reason": STRAGGLER_POISON_REASON,
                               "culprit": 2, "step": 8})
                return 101
            return 0

        sup = FleetSupervisor("train.py", nproc_per_node=4,
                              log_dir=str(tmp_path / "log"),
                              policy=_fast_policy(), launch_fn=fake_launch)
        assert sup.run() == 0
        assert sup.excluded_slots == [2]
        assert sup.world_size == 3          # same topology minus one slot
        assert sup.gang_restarts == 0       # fresh budget, not a restart
        assert calls[1][1]["PADDLE_TPU_EXCLUDE_SLOTS"] == "2"
        assert "PADDLE_TPU_DEVICE_ORDER" not in calls[1][1]

    def test_link_poison_remaps_device_order_no_slot_lost(self, tmp_path):
        calls = []

        def fake_launch(argv, env):
            calls.append(dict(env))
            if len(calls) == 1:
                _poison(argv, {"reason": STRAGGLER_LINK_REASON,
                               "culprit": 2, "link": [1, 2], "step": 8})
                return 101
            return 0

        sup = FleetSupervisor("train.py", nproc_per_node=4,
                              log_dir=str(tmp_path / "log"),
                              policy=_fast_policy(), launch_fn=fake_launch)
        assert sup.run() == 0
        # the fix cost a permutation, not a slot
        assert sup.excluded_slots == [] and sup.world_size == 4
        assert sup.gang_restarts == 0       # remap resets the budget too
        assert sup.bad_link_slots == [[1, 2]]
        order = [int(t) for t in
                 calls[1]["PADDLE_TPU_DEVICE_ORDER"].split(",")]
        _assert_ring_avoids(order, 4, [(1, 2)])

    def test_link_poison_small_world_falls_back_to_exclusion(self, tmp_path):
        calls = []

        def fake_launch(argv, env):
            calls.append(dict(env))
            if len(calls) == 1:
                _poison(argv, {"reason": STRAGGLER_LINK_REASON,
                               "culprit": 1, "link": [0, 1], "step": 4})
                return 101
            return 0

        sup = FleetSupervisor("train.py", nproc_per_node=3,
                              log_dir=str(tmp_path / "log"),
                              policy=_fast_policy(), launch_fn=fake_launch)
        assert sup.run() == 0
        # on a 3-ring every pair is adjacent: no order avoids the link,
        # so the culprit's slot is excluded instead
        assert sup.excluded_slots == [1] and sup.world_size == 2
        assert sup.device_order is None
        assert calls[1]["PADDLE_TPU_EXCLUDE_SLOTS"] == "1"
        assert "PADDLE_TPU_DEVICE_ORDER" not in calls[1]

    def test_remap_recomputed_after_later_exclusion(self, tmp_path):
        calls = []

        def fake_launch(argv, env):
            calls.append(dict(env))
            if len(calls) == 1:
                _poison(argv, {"reason": STRAGGLER_LINK_REASON,
                               "culprit": 2, "link": [1, 2]})
                return 101
            if len(calls) == 2:
                _poison(argv, {"reason": STRAGGLER_POISON_REASON,
                               "culprit": 0})
                return 101
            return 0

        sup = FleetSupervisor("train.py", nproc_per_node=5,
                              log_dir=str(tmp_path / "log"),
                              policy=_fast_policy(max_gang_restarts=2),
                              launch_fn=fake_launch)
        assert sup.run() == 0
        assert sup.excluded_slots == [0] and sup.world_size == 4
        assert sup.bad_link_slots == [[1, 2]]
        env = calls[2]
        assert env["PADDLE_TPU_EXCLUDE_SLOTS"] == "0"
        # slots (1, 2) are dense ranks (0, 1) of the shrunken world; the
        # recomputed order must still keep them off the ring adjacency
        order = [int(t) for t in env["PADDLE_TPU_DEVICE_ORDER"].split(",")]
        _assert_ring_avoids(order, 4, [(0, 1)])


# -- chaos e2e: slow rank → flag → probe → quarantine → exact trajectory -----

# Training-shaped gang member under the real launcher/fault-domain stack.
# "Training" is the SDC suite's deterministic float32 recurrence — a slow
# chip computes CORRECT numbers, so EVERY logged step (both epochs, every
# rank) must stay bitwise-analytic; only the pace differs.  Rank 2 of gang
# epoch 1 is the degraded chip: from `slow_from` on, its compute path (and
# its micro-probe — same armed spec, "rank2/*") passes through a seeded
# delay fault.  dt is measured around COMPUTE ONLY and the monitor hook
# runs after the barrier: the barrier equalizes wall time across ranks, so
# timing it would make the whole gang look uniformly slow (which the
# median-relative detector correctly never flags).
_MEMBER = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    import paddle_tpu_torch  # noqa: F401  (package init: telemetry, env contract)
    from paddle_tpu_torch.distributed.checkpoint import faults
    from paddle_tpu_torch.distributed.fleet import fault_domain as fd_mod
    from paddle_tpu_torch.distributed.health.ledger import RewindLedger
    from paddle_tpu_torch.distributed.health.straggler import (StragglerMonitor,
                                                         StragglerPolicy)

    root, total, slow_from, kind, traj_dir = sys.argv[1:6]
    total, slow_from = int(total), int(slow_from)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    epoch = int(os.environ["PADDLE_TPU_GANG_EPOCH"])
    d = fd_mod.init_from_env()
    assert d is not None and d.rank == rank

    bad = epoch == 1 and rank == 2
    if bad and kind == "chip":
        # sticky: the chip stays slow, so the probe (rank2/probe) is as
        # degraded as the step path (rank2/work) — times=-1
        faults.scope(faults.FaultSpec(op="slow_step", pattern="rank2/*",
                                      mode="delay", delay_s=0.25,
                                      times=-1, after=slow_from)).__enter__()
    if bad and kind == "transient":
        # a 2-step load spike: the fault lifts before (or as) the probe
        # runs, so the ladder must classify transient and keep going
        faults.scope(faults.FaultSpec(op="slow_step", pattern="rank2/*",
                                      mode="delay", delay_s=0.25,
                                      times=2, after=slow_from)).__enter__()
    if bad and kind == "link":
        # one degraded ICI link: the 1-2 collective leg is slow; the chip
        # probe stays clean and only the link1-2 probe leg is degraded
        faults.scope(faults.FaultSpec(op="slow_collective",
                                      pattern="link1-2", mode="delay",
                                      delay_s=0.25, times=-1,
                                      after=slow_from)).__enter__()

    def compute(step, p):
        g = np.sin((np.arange(8, dtype=np.float32)
                    + np.float32(step)).astype(np.float32)).astype(np.float32)
        # chaos seams: a slow chip drags the whole step; a slow link
        # drags the ring-neighbor collective leg of this rank
        faults.fire("slow_step", "rank%d/work" % rank)
        for peer in ((rank - 1) % d.world_size, (rank + 1) % d.world_size):
            faults.fire("slow_collective",
                        "link%d-%d" % (min(rank, peer), max(rank, peer)))
        return (p - np.float32(0.1) * g).astype(np.float32)

    mon = StragglerMonitor(StragglerPolicy.from_env(), domain=d,
                           ledger=RewindLedger(root))

    start = 0
    for f in os.listdir(root):
        if f.startswith("state_") and f.endswith(".npy"):
            start = max(start, int(f[6:-4]))
    params = np.zeros(8, np.float32)
    if start:
        params = np.load(os.path.join(root, "state_%d.npy" % start))

    log = open(os.path.join(traj_dir, "traj.%d" % rank), "a")
    ring_pos = os.environ.get("PADDLE_TPU_RING_POS", "-")
    for step in range(start + 1, total + 1):
        t0 = time.perf_counter()
        params = compute(step, params)
        dt = time.perf_counter() - t0       # compute-only: barriers are
        log.write("%d:%d:%s:%s\\n" % (epoch, step,    # pace-equalizing
                                      params.tobytes().hex(), ring_pos))
        log.flush()
        if step % 2 == 0 and rank == 0:
            tmp = os.path.join(root, ".state_%d.tmp" % step)
            with open(tmp, "wb") as f:
                np.save(f, params)
            os.replace(tmp, os.path.join(root, "state_%d.npy" % step))
            mon.note_checkpoint(step)
        d._store.barrier("sstep/%d/%d" % (epoch, step), d.world_size,
                         timeout=60.0, rank=rank)
        # post-barrier: flag polls line up across ranks to within the
        # barrier-release skew (and an incomplete gather retries anyway)
        mon.on_step(step, dt=dt)   # sticky suspect: SystemExit(101) here
    d.stop()
    print("DONE", rank, flush=True)
""")


def _analytic_trajectory(total):
    params = np.zeros(8, np.float32)
    out = {}
    for step in range(1, total + 1):
        g = np.sin((np.arange(8, dtype=np.float32)
                    + np.float32(step)).astype(np.float32)).astype(np.float32)
        params = (params - np.float32(0.1) * g).astype(np.float32)
        out[step] = params.tobytes().hex()
    return out


def _read_traj(tmp_path, world):
    by_rank = {}
    for r in range(world):
        p = tmp_path / f"traj.{r}"
        rows = []
        if p.exists():
            for line in p.read_text().splitlines():
                if line:
                    e, s, h, pos = line.split(":")
                    rows.append((int(e), int(s), h, pos))
        by_rank[r] = rows
    return by_rank


def _run_member(tmp_path, *, kind, total, slow_from=4, world=4, **sup_kw):
    script = tmp_path / "member.py"
    script.write_text(_MEMBER)
    root = tmp_path / "ckpts"
    root.mkdir(exist_ok=True)
    sup_kw.setdefault("policy", _fast_policy(max_gang_restarts=2,
                                             degrade=False))
    sup = FleetSupervisor(
        str(script), [str(root), str(total), str(slow_from), kind,
                      str(tmp_path)],
        nproc_per_node=world, log_dir=str(tmp_path / "log"),
        env={"PYTHONPATH": REPO + os.pathsep +
             os.environ.get("PYTHONPATH", "")},
        **sup_kw)
    return sup, root


class TestSlowRankChaosE2E:
    def test_sticky_chip_flag_probe_quarantine_exact(self, tmp_path):
        total, world = 24, 4
        sup, root = _run_member(tmp_path, kind="chip", total=total,
                                world=world)
        assert sup.run() == 0

        # FLAGGED + CONFIRMED + QUARANTINED: the ladder named rank 2
        # sticky chip-slow and the relaunch ran the same topology minus
        # that slot — no degrade, no lost healthy host
        assert sup.epoch == 2
        assert sup.excluded_slots == [2]
        assert sup.world_size == world - 1
        assert sup.exit_codes[0] != 0 and sup.exit_codes[-1] == 0

        # the poison pill the launcher dumped names the straggler path
        pill = json.load(open(
            tmp_path / "log" / "epoch_1" / "poison.json"))
        assert pill["reason"] == STRAGGLER_POISON_REASON
        assert pill["culprit"] == 2

        # the ledger recorded the episode's window with the culprit
        from paddle_tpu_torch.distributed.health.ledger import RewindLedger
        entries = [e for e in RewindLedger(str(root)).entries()
                   if e["reason"] == "straggler"]
        assert len(entries) == 1 and entries[0]["culprit"] == 2

        # EXACT: a slow chip computes CORRECT numbers — every logged
        # step of BOTH epochs, on every rank, is bitwise-analytic
        expect = _analytic_trajectory(total)
        by_rank = _read_traj(tmp_path, world)
        for r in range(world):
            assert by_rank[r], r
            for e, s, h, _pos in by_rank[r]:
                assert h == expect[s], (r, e, s)
        # and the relaunched (3-rank) gang ran through to completion
        e2_steps = sorted(s for r in range(world)
                          for e, s, h, _ in by_rank[r] if e == 2)
        assert e2_steps and max(e2_steps) == total
        # epoch 2 has exactly world-1 writers
        e2_ranks = {r for r in range(world)
                    if any(e == 2 for e, *_ in by_rank[r])}
        assert len(e2_ranks) == world - 1
