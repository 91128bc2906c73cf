"""Silent-data-corruption defense of the port (ROADMAP A7b), from the
reference's ``tests/test_sdc.py``: fingerprinted steps, the cross-replica
vote, suspect quarantine and the pre-corruption rewind.

- the device lanes: ``_device_signs`` bit-equal to the reference's for the
  same ``(n, salt)``, the lanes within rounding of the reference's (torch
  and XLA reduce in different orders), bitwise reproducible on one device,
  moved by one flipped mantissa bit;
- the host fingerprints, the ``faults`` bitflip injector, ``SDCMonitor``'s
  vote, confirmation and quarantine, as the reference's;
- ``jit.TrainStep``'s probe carries the lanes on vote steps only (the
  host knows the cadence) and zeros otherwise, through a guarded
  ``DistributedTrainStep`` with its bucket taps too;
- checkpoint and snapshot fingerprints, the ``FleetSupervisor``'s
  exclude-list relaunch, and the chaos run: a 4-rank gang whose rank 2
  silently flips gradient bits must be noticed, named, quarantined and
  rewound to the pre-corruption generation, its trajectory then bitwise
  the analytic fault-free run.
"""

import json
import os
import pickle
import textwrap
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.health import sdc as jsdc

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.distributed.auto_parallel import (ProcessMesh, Replicate, Shard,
                                                        shard_tensor)
from paddle_tpu_torch.distributed.checkpoint import (CheckpointCorruptionError,
                                                     faults, load_state_dict,
                                                     save_state_dict)
from paddle_tpu_torch.distributed.checkpoint.snapshot import (
    SnapshotRestoreError, _restore_into, _snapshot_fingerprints)
from paddle_tpu_torch.distributed.fleet.elastic import (FleetSupervisor, GangPolicy,
                                                        RestartPolicy)
from paddle_tpu_torch.distributed.health import sdc
from paddle_tpu_torch.distributed.health.ledger import HealthError, RewindLedger
from paddle_tpu_torch.distributed.health.sdc import (LANES_PER_FP, SDC_EXIT_CODE,
                                                     SDC_POISON_REASON, SDCMonitor,
                                                     SDCPolicy, fingerprint_lanes,
                                                     host_fingerprint, pack_digest,
                                                     sdc_enabled, shard_fp_name,
                                                     tree_fingerprints,
                                                     verify_load_enabled)
from paddle_tpu_torch.distributed.overlap import GradientBucketer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import SGD

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    paddle.set_device("cpu")
    yield
    faults.reset()
    topology.set_hybrid_communicate_group(None)
    paddle.set_device(None)


# -- device-side fingerprints ------------------------------------------------

def _arrays(seed=0, shapes=((8, 4), (16,), (3, 3, 2))):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]


class TestDeviceFingerprints:
    def test_bitwise_deterministic(self):
        groups = [_arrays(0), _arrays(1)]
        d1 = pack_digest(fingerprint_lanes(groups, seed=0xD5C))
        d2 = pack_digest(fingerprint_lanes(groups, seed=0xD5C))
        assert d1 == d2
        assert len(fingerprint_lanes(groups, 0)) == LANES_PER_FP * len(groups)

    def test_seed_keys_the_projection(self):
        groups = [_arrays(0)]
        assert pack_digest(fingerprint_lanes(groups, 1)) != \
            pack_digest(fingerprint_lanes(groups, 2))

    def test_single_mantissa_flip_moves_the_digest(self):
        arrs = _arrays(3)
        clean = pack_digest(fingerprint_lanes([arrs], 0xD5C))
        host = arrs[0].numpy().copy()
        host.reshape(-1).view(np.uint32)[5] ^= np.uint32(1 << 22)
        flipped = [torch.from_numpy(host)] + arrs[1:]
        assert pack_digest(fingerprint_lanes([flipped], 0xD5C)) != clean

    def test_group_order_and_membership_matter(self):
        a, b = _arrays(0), _arrays(1)
        assert pack_digest(fingerprint_lanes([a, b], 7)) != \
            pack_digest(fingerprint_lanes([b, a], 7))

    def test_empty_arrays_are_skipped(self):
        lanes = fingerprint_lanes([[torch.zeros((0,))]], 0)
        assert [float(x) for x in lanes] == [0.0, 0.0]

    @pytest.mark.parametrize("n,salt", [(1, 0), (4099, 5), (70001, 0xD5C + 0x9E3779B9 * 3),
                                        (300, 2 ** 40 + 123), (65537, 0xFFFFFFFF)])
    def test_signs_bit_equal_reference(self, n, salt):
        """The counter hash in int64 masked to 32 bits is the reference's
        uint32 arithmetic to the bit, whole or from an offset."""
        want = np.asarray(jsdc._device_signs(n, salt))
        np.testing.assert_array_equal(sdc._device_signs(n, salt).numpy(), want)
        cut = n // 3
        parts = torch.cat([sdc._device_signs(cut, salt), sdc._device_signs(n - cut, salt,
                                                                            start=cut)])
        np.testing.assert_array_equal(parts.numpy(), want)

    def test_lanes_within_rounding_of_reference(self):
        """The same values through both packages: the abs-sums and the
        projections within f32 rounding of a sum over the elements."""
        groups = [_arrays(0), _arrays(1, ((40, 3), (7,))), [_arrays(2)[0]]]
        want = np.array([float(x) for x in jsdc.fingerprint_lanes(
            [[a.numpy() for a in g] for g in groups], 0xD5C)])
        got = np.array([float(x) for x in fingerprint_lanes(groups, 0xD5C)])
        scale = np.array([float(sum(a.abs().sum() for a in g)) for g in groups
                          for _ in range(2)])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale.max())
        np.testing.assert_allclose(got[1::2], want[1::2], rtol=2e-6)

    def test_chunks_keep_the_digest_deterministic(self, monkeypatch):
        """A tensor longer than one chunk: the same digest every time, and
        within rounding of the whole-tensor sum."""
        big = [torch.from_numpy(np.random.default_rng(4).standard_normal(5000)
                                .astype(np.float32))]
        whole = np.array([float(x) for x in fingerprint_lanes([big], 3)])
        monkeypatch.setattr(sdc, "_LANE_CHUNK", 1024)
        a = pack_digest(fingerprint_lanes([big], 3))
        assert a == pack_digest(fingerprint_lanes([big], 3))
        np.testing.assert_allclose(np.frombuffer(bytes.fromhex(a), np.float32), whole,
                                   rtol=1e-5, atol=1e-3)

    def test_bf16_and_none_members(self):
        x = _arrays(5)[0]
        lanes = fingerprint_lanes([[x.bfloat16(), None]], 9)
        want = fingerprint_lanes([[x.bfloat16().float()]], 9)
        assert pack_digest(lanes) == pack_digest(want)


class TestHostFingerprints:
    def test_deterministic_and_seed_keyed(self):
        a = np.random.default_rng(0).standard_normal((64, 3)).astype("float32")
        assert host_fingerprint(a, 5) == host_fingerprint(a.copy(), 5)
        assert host_fingerprint(a, 5) != host_fingerprint(a, 6)
        assert len(host_fingerprint(a, 5)) == 32    # struct.pack("<dd") hex

    def test_one_bit_flip_is_detected(self):
        a = np.random.default_rng(1).standard_normal(128).astype("float32")
        b = a.copy()
        b.view(np.uint32)[17] ^= np.uint32(1)       # least significant bit
        assert host_fingerprint(a) != host_fingerprint(b)

    def test_non_float_dtypes(self):
        ints = np.arange(32, dtype=np.int64)
        assert host_fingerprint(ints) == host_fingerprint(ints.copy())
        other = ints.copy()
        other[3] += 1
        assert host_fingerprint(ints) != host_fingerprint(other)

    def test_tree_fingerprints_key_separation(self):
        a = np.ones((4,), np.float32)
        # same payload under different keys must NOT produce the same
        # digest (swapped tensors can't cancel)
        fps = tree_fingerprints({"w": a, "b": a.copy()}, seed=9)
        assert fps["w"] != fps["b"]

    def test_shard_fp_name(self):
        assert shard_fp_name("model.w", (0, 128)) == "model.w@0,128"


# -- the bitflip injector ----------------------------------------------------

class TestBitflipInjector:
    def test_flips_exactly_one_element_copy_not_inplace(self):
        g = np.random.default_rng(2).standard_normal(64).astype("float32")
        orig = g.copy()
        with faults.inject(op="sdc", mode="bitflip", seed=11) as spec:
            out = faults.fire("sdc", "grad_rank2", data=g)
        np.testing.assert_array_equal(g, orig)      # input untouched
        assert spec.fired == 1
        diff = out != g
        assert diff.sum() == 1
        # mantissa-only: the changed bit pattern differs below the exponent
        xor = out.view(np.uint32) ^ g.view(np.uint32)
        delta = int(xor[diff.argmax()])
        assert delta != 0 and delta < (1 << 23)

    def test_seeded_and_advancing(self):
        g = np.random.default_rng(3).standard_normal(64).astype("float32")
        with faults.inject(op="sdc", mode="bitflip", seed=5, times=-1):
            a = faults.fire("sdc", "g", data=g)
            b = faults.fire("sdc", "g", data=g)
        with faults.inject(op="sdc", mode="bitflip", seed=5, times=-1):
            a2 = faults.fire("sdc", "g", data=g)
        np.testing.assert_array_equal(a, a2)        # reproducible campaign
        assert not np.array_equal(a, b)             # sticky: differs per fire

    def test_pattern_gates_the_op(self):
        g = np.ones(8, np.float32)
        with faults.inject(op="sdc", pattern="grad_rank2", mode="bitflip"):
            out = faults.fire("sdc", "grad_rank0", data=g)
        np.testing.assert_array_equal(out, g)       # wrong rank: no fire

    def test_nothing_armed_is_identity(self):
        g = np.ones(8, np.float32)
        assert faults.fire("sdc", "grad", data=g) is g


# -- SDCMonitor: vote / confirm / quarantine ---------------------------------

class _KV:
    def __init__(self):
        self.d = {}

    def put(self, k, v):
        self.d[k] = v

    def get(self, k):
        return self.d.get(k)


class _Domain:
    def __init__(self, kv, rank, world, epoch=0):
        self._kv = kv
        self.rank = rank
        self.world_size = world
        self.epoch = epoch
        self.poisoned = None

    def poison(self, reason, culprit=None, detail=""):
        self.poisoned = {"reason": reason, "culprit": culprit,
                         "detail": detail}


GOOD = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
BAD = np.asarray([1.0, 2.0, 3.0, 4.5], np.float32)


def _policy(**kw):
    kw.setdefault("every", 1)
    kw.setdefault("confirm", 2)
    kw.setdefault("max_lag", 0)
    kw.setdefault("vote_timeout", 2.0)
    return SDCPolicy(**kw)


def _prefill(kv, step, ranks, lanes, epoch=0):
    for r in ranks:
        kv.put(f"sdc/{epoch}/{step}/{r}", pack_digest(lanes))


class TestMonitorVote:
    def test_solo_mode_marks_clean(self):
        mon = SDCMonitor(_policy())
        mon.observe(3, GOOD)
        assert mon.checks == 1
        assert mon.last_clean_step == 3
        assert mon.mismatches == 0

    def test_cadence_gate(self):
        kv = _KV()
        mon = SDCMonitor(_policy(every=4), domain=_Domain(kv, 0, 3))
        mon.observe(3, GOOD)                 # off-cadence: counted, no vote
        assert mon.checks == 1 and not kv.d
        _prefill(kv, 4, (1, 2), GOOD)
        mon.observe(4, GOOD)                 # on-cadence: published + voted
        assert "sdc/0/4/0" in kv.d
        assert mon.last_clean_step == 4

    def test_unanimous_vote_is_clean(self):
        kv = _KV()
        mon = SDCMonitor(_policy(), domain=_Domain(kv, 0, 4))
        _prefill(kv, 2, (1, 2, 3), GOOD)
        mon.observe(2, GOOD)
        assert mon.mismatches == 0
        assert mon.last_clean_step == 2

    def test_majority_names_minority_self_not_judged(self):
        kv = _KV()
        mon = SDCMonitor(_policy(), domain=_Domain(kv, 0, 4))
        _prefill(kv, 2, (1, 3), GOOD)
        _prefill(kv, 2, (2,), BAD)           # rank 2 lies; we're in majority
        mon.observe(2, GOOD)
        assert mon.mismatches == 1
        assert mon.suspects == 0             # only the minority confirms
        assert mon.last_vote["step"] == 2
        assert mon.last_vote["groups"][pack_digest(BAD)] == [2]

    def test_tie_is_observed_not_poisoned(self):
        kv = _KV()
        dom = _Domain(kv, 0, 2)
        mon = SDCMonitor(_policy(), domain=dom)
        _prefill(kv, 2, (1,), BAD)
        mon.observe(2, GOOD)                 # 1-1: no strict majority
        assert mon.mismatches == 1
        assert mon.suspects == 0
        assert dom.poisoned is None

    def test_incomplete_vote_times_out(self):
        kv = _KV()
        mon = SDCMonitor(_policy(vote_timeout=0.15), domain=_Domain(kv, 0, 3))
        t0 = time.monotonic()
        mon.observe(2, GOOD)                 # ranks 1,2 never vote
        assert mon.votes_incomplete == 1
        assert time.monotonic() - t0 < 5.0

    def test_transient_when_replays_reproduce_majority(self):
        kv = _KV()
        dom = _Domain(kv, 0, 4)
        mon = SDCMonitor(_policy(), domain=dom,
                         replay_fn=lambda step: pack_digest(GOOD))
        _prefill(kv, 2, (1, 2, 3), GOOD)
        mon.observe(2, BAD)                  # we are the minority
        assert mon.transients == 1
        assert mon.suspects == 0
        assert dom.poisoned is None          # a cosmic ray is not a verdict

    def test_sticky_suspect_quarantines_with_ledger_window(self):
        kv = _KV()
        ledger = RewindLedger(None)
        seen = []
        mon = SDCMonitor(_policy(), domain=_Domain(kv, 0, 4), ledger=ledger,
                         replay_fn=lambda step: pack_digest(BAD),
                         on_suspect=seen.append)
        # clean vote at 4 anchors; generations at 2 and 4 committed
        mon.note_checkpoint(2)
        mon.note_checkpoint(4)
        _prefill(kv, 4, (1, 2, 3), GOOD)
        mon.observe(4, GOOD)
        assert mon.last_clean_step == 4
        _prefill(kv, 6, (1, 2, 3), GOOD)
        mon.observe(6, BAD)                  # sticky: replays still disagree
        assert mon.suspects == 1
        assert len(seen) == 1
        doc = seen[0]
        assert doc["reason"] == SDC_POISON_REASON
        assert doc["rank"] == 0 and doc["resume_step"] == 4
        entry = ledger.entries()[0]
        assert entry["window"] == [4, 6]
        assert entry["reason"] == "sdc" and entry["culprit"] == 0
        # the window poisons (anchor, step] — the anchor itself is clean
        assert ledger.poisoned(5) and ledger.poisoned(6)
        assert not ledger.poisoned(4)

    def test_no_replay_fn_is_conservatively_sticky(self):
        kv = _KV()
        seen = []
        mon = SDCMonitor(_policy(), domain=_Domain(kv, 0, 4),
                         on_suspect=seen.append)
        _prefill(kv, 2, (1, 2, 3), GOOD)
        mon.observe(2, BAD)
        assert mon.suspects == 1 and len(seen) == 1

    def test_replay_error_is_sticky(self):
        kv = _KV()
        seen = []

        def boom(step):
            raise RuntimeError("replay infra down")

        mon = SDCMonitor(_policy(), domain=_Domain(kv, 0, 4), replay_fn=boom,
                         on_suspect=seen.append)
        _prefill(kv, 2, (1, 2, 3), GOOD)
        mon.observe(2, BAD)
        assert mon.suspects == 1
        assert any(r.startswith("replay_error:")
                   for r in seen[0]["replays"])

    def test_on_suspect_raise(self):
        kv = _KV()
        mon = SDCMonitor(_policy(), domain=_Domain(kv, 0, 4),
                         on_suspect="raise")
        _prefill(kv, 2, (1, 2, 3), GOOD)
        with pytest.raises(HealthError, match="sticky"):
            mon.observe(2, BAD)

    def test_default_exit_poisons_domain_and_exits_101(self):
        kv = _KV()
        dom = _Domain(kv, 2, 4)
        mon = SDCMonitor(_policy(), domain=dom)
        _prefill(kv, 2, (0, 1, 3), GOOD, epoch=0)
        with pytest.raises(SystemExit) as e:
            mon.observe(2, BAD)
        assert e.value.code == SDC_EXIT_CODE == 101
        assert dom.poisoned["reason"] == SDC_POISON_REASON
        assert dom.poisoned["culprit"] == 2

    def test_clean_anchor_tracks_committed_generations(self):
        mon = SDCMonitor(_policy())
        mon.note_checkpoint(2)
        mon.note_checkpoint(6)
        mon.last_clean_step = 4
        assert mon.clean_anchor() == 2       # 6 is newer than the clean mark
        mon.last_clean_step = 6
        assert mon.clean_anchor() == 6
        assert SDCMonitor(_policy()).clean_anchor() == 0

    def test_max_lag_late_resolution_and_flush(self):
        mon = SDCMonitor(_policy(max_lag=2))
        probe = np.asarray([0.1, 1.0, 0.5, 1, 2, 3, 4], np.float32)
        for s in (1, 2, 3):
            mon.on_step(probe, step=s)
        assert mon.checks == 1               # only step 1 resolved so far
        mon.flush()
        assert mon.checks == 3

    def test_probe_without_lanes_is_ignored(self):
        mon = SDCMonitor(_policy())
        mon.on_step(np.asarray([0.1, 1.0, 0.5], np.float32), step=1)
        assert mon.checks == 0               # guard-only probe: no digest

    def test_env_gate_disables(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_SDC", "0")
        assert not sdc_enabled()
        mon = SDCMonitor(_policy())
        assert not mon.active
        mon.on_step(np.zeros(7, np.float32), step=1)
        assert mon.checks == 0

    def test_policy_from_env(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_SDC_EVERY", "5")
        monkeypatch.setenv("PADDLE_TPU_SDC_SEED", "99")
        p = SDCPolicy.from_env()
        assert p.every == 5 and p.seed == 99
        assert p.confirm == 2

    def test_telemetry_counters_and_stepmeter_summary(self):
        from paddle_tpu_torch import telemetry
        from paddle_tpu_torch.telemetry.stepmeter import StepMeter

        before = telemetry.counters().get("sdc_checks_total", 0)
        mon = SDCMonitor(_policy())
        mon.observe(1, GOOD)
        mon.observe(2, GOOD)
        assert telemetry.counters()["sdc_checks_total"] == before + 2
        meter = StepMeter("sdc_test", jsonl_path=False)
        meter.step(loss=1.0)
        out = meter.summary()
        assert out["sdc_checks"] >= 2        # schema-additive aggregate
        assert "sdc_mismatches" in out


# -- TrainStep integration: the lanes ride the probe ---------------------------

def _tiny_step():
    paddle.seed(0)
    model = nn.Linear(8, 4)
    opt = SGD(1e-2, parameters=model.parameters())
    return TrainStep(model, lambda m, x, y: F.mse_loss(m(x), y), opt), model


def _recording(mon):
    calls = []
    orig = mon.set_lane_labels
    mon.set_lane_labels = lambda labels: (calls.append(list(labels)), orig(labels))[1]
    return calls


class TestTrainStepIntegration:
    def test_lanes_ride_the_probe_no_recompile(self):
        step, model = _tiny_step()
        mon = SDCMonitor(_policy())
        calls = _recording(mon)
        step.attach_sdc_monitor(mon)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((16, 8)).astype("float32")
        y = rng.standard_normal((16, 4)).astype("float32")
        losses = [float(step(x, y)) for _ in range(6)]
        assert calls and all(c == ["grad", "params"] for c in calls)
        assert mon.checks == 6               # max_lag=0: every step resolved
        assert mon.last_clean_step == 6      # solo: clean by definition
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]

    def test_trace_signature_names_the_lane_layout(self):
        step, _ = _tiny_step()
        mon = SDCMonitor(_policy(seed=0xBEEF))
        step.attach_sdc_monitor(mon)
        step(np.ones((2, 8), np.float32), np.ones((2, 4), np.float32))
        assert mon.trace_signature() == {"seed": 0xBEEF, "labels": ["grad", "params"]}
        step.attach_sdc_monitor(None)
        assert step._sdc_monitor is None

    def test_probe_lanes_are_the_step_fingerprints(self):
        """On a vote step the probe's lanes are fingerprint_lanes of the
        gradient before the update and of the parameters after it; off the
        cadence they are zeros (no lane work)."""
        step, model = _tiny_step()
        mon = SDCMonitor(_policy(every=2, max_lag=5))
        step.attach_sdc_monitor(mon)
        seen = []
        orig = mon.on_step
        mon.on_step = lambda probe, step=None: (seen.append(probe.values()), orig(probe, step))[1]
        rng = np.random.default_rng(1)
        x = rng.standard_normal((4, 8)).astype("float32")
        y = rng.standard_normal((4, 4)).astype("float32")
        step(x, y)
        assert np.array_equal(seen[0][3:], np.zeros(4, np.float32))
        grads = []
        model.weight.register_hook(lambda g: grads.append(("w", g.clone())))
        model.bias.register_hook(lambda g: grads.append(("b", g.clone())))
        step(x, y)
        g = dict(grads)
        want = fingerprint_lanes([[g["w"], g["b"]], [model.weight.detach(),
                                                    model.bias.detach()]], mon.policy.seed)
        assert pack_digest(seen[1][3:]) == pack_digest(want)
        mon.flush()
        assert mon.checks == 2 and mon.last_clean_step == 2

    def test_two_runs_give_bitwise_equal_digests_and_a_flip_moves_them(self):
        def run(flip=False):
            step, model = _tiny_step()
            mon = SDCMonitor(_policy())
            step.attach_sdc_monitor(mon)
            digests = []
            orig = mon.observe
            mon.observe = lambda s, lanes: (digests.append(pack_digest(lanes[-4:])),
                                            orig(s, lanes))[1]
            rng = np.random.default_rng(2)
            x = rng.standard_normal((4, 8)).astype("float32")
            y = rng.standard_normal((4, 4)).astype("float32")
            step(x, y)
            if flip:
                with faults.inject(op="sdc", mode="bitflip", seed=3):
                    w = faults.fire("sdc", "param", data=model.weight.detach().numpy())
                with torch.no_grad():
                    model.weight.copy_(torch.from_numpy(w))
            step(x, y)
            return digests

        a, b, c = run(), run(), run(flip=True)
        assert a == b
        assert a[0] == c[0] and a[1] != c[1]

    def test_distributed_step_accepts_vote_flag_under_pins(self):
        """The guarded DistributedTrainStep at dp2 x sharding4 on one
        controller with every=2: the bucket taps lead the lanes,
        off-cadence steps do no lane work, vote steps resolve, it trains."""
        from paddle_tpu_torch import distributed as dist
        from paddle_tpu_torch.distributed import DistributedTrainStep

        s = dist.fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1,
                            "sharding_degree": 4}
        dist.fleet.init(is_collective=True, strategy=s, devices=["cpu"] * 8)
        paddle.seed(0)
        model = nn.Linear(16, 8)
        opt = SGD(1e-2, parameters=model.parameters())
        step = DistributedTrainStep(model, lambda m, x, y: F.mse_loss(m(x), y), opt,
                                    dist.get_hybrid_communicate_group(), sharding_stage=1)
        mon = SDCMonitor(_policy(every=2))
        calls = _recording(mon)
        step.attach_sdc_monitor(mon)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((16, 16)).astype("float32")
        y = rng.standard_normal((16, 8)).astype("float32")
        losses = [float(step(x, y)) for _ in range(6)]
        assert calls[0][-2:] == ["grad", "params"]
        assert calls[0][:-2] and all(c.startswith("bucket") for c in calls[0][:-2])
        assert mon.checks == 6 and mon.last_clean_step == 6
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]

    def test_snapshot_cadence_feeds_rewind_anchor(self):
        from paddle_tpu_torch.distributed.checkpoint import Snapshotter

        step, model = _tiny_step()
        mon = SDCMonitor(_policy())
        step.attach_sdc_monitor(mon)
        snap = Snapshotter(lambda: {"w": model.weight}, every=2, rank=0, world_size=1,
                           transport=None)
        step.attach_snapshotter(snap)
        rng = np.random.default_rng(1)
        x = rng.standard_normal((8, 8)).astype("float32")
        y = rng.standard_normal((8, 4)).astype("float32")
        for _ in range(4):
            step(x, y)
        assert 2 in mon._ckpt_steps and 4 in mon._ckpt_steps
        assert mon.clean_anchor() == 4


# -- bucketer tap: pre-reduce diagnostic groups ------------------------------

class TestBucketerFingerprintGroups:
    def test_groups_mirror_the_comm_plan(self):
        arrays = [np.full((i + 1,), float(i), np.float32) for i in range(4)]
        sizes = [a.nbytes for a in arrays]
        b = GradientBucketer(sizes, bucket_bytes=1 << 20,
                             skip=[False, True, False, False])
        labels, groups = b.fingerprint_groups(arrays)
        assert len(labels) == len(groups) == b.num_buckets + 1
        assert labels[-1] == "unbucketed1"
        assert groups[-1][0] is arrays[1]
        # every non-skipped tensor appears in exactly one bucket group
        flat = [id(a) for g in groups[:-1] for a in g]
        assert sorted(flat) == sorted(
            id(arrays[i]) for i in (0, 2, 3))

    def test_length_mismatch_is_loud(self):
        b = GradientBucketer([4, 4])
        with pytest.raises(ValueError, match="planned over"):
            b.fingerprint_groups([np.zeros(1, np.float32)])


# -- checkpoint integrity: fingerprints in committed metadata ----------------

def _mesh(shape, names):
    return ProcessMesh(np.arange(8).reshape(shape), dim_names=list(names),
                       devices=["cpu"] * 8)


def _sharded(src):
    return shard_tensor(src, _mesh((8,), "x"), [Shard(0), Replicate()])


def _src(seed=0, shape=(16, 8)):
    return np.random.default_rng(seed).standard_normal(shape).astype("float32")


class TestCheckpointFingerprints:
    def test_fingerprints_in_committed_metadata_round_trip(self, tmp_path):
        path = str(tmp_path / "ck")
        src = _src()
        save_state_dict({"w": _sharded(src)}, path)
        with open(os.path.join(path, "metadata"), "rb") as f:
            meta = pickle.loads(f.read())
        assert meta.tensor_fingerprints
        assert all(k.startswith("w@") for k in meta.tensor_fingerprints)
        assert all(len(v) == 32 for v in meta.tensor_fingerprints.values())
        dst = _sharded(np.zeros_like(src))
        load_state_dict({"w": dst}, path)    # verify-on-load passes
        np.testing.assert_array_equal(dst.numpy(), src)

    def test_bitflip_between_get_and_serialize_fails_load(self, tmp_path):
        path = str(tmp_path / "ck")
        src = _src(1)
        with faults.inject(op="sdc", pattern="ckpt_serialize/*",
                           mode="bitflip", seed=3) as spec:
            save_state_dict({"w": _sharded(src)}, path)
        assert spec.fired == 1               # corruption really happened
        dst = _sharded(np.zeros_like(src))
        # the shard CRC is computed over the ALREADY corrupted bytes, so
        # only the value fingerprint can catch this
        with pytest.raises(CheckpointCorruptionError,
                           match="PADDLE_TPU_SDC_VERIFY_LOAD"):
            load_state_dict({"w": dst}, path)

    def test_verify_load_escape_hatch(self, tmp_path, monkeypatch):
        path = str(tmp_path / "ck")
        src = _src(2)
        with faults.inject(op="sdc", pattern="ckpt_serialize/*",
                           mode="bitflip", seed=4):
            save_state_dict({"w": _sharded(src)}, path)
        monkeypatch.setenv("PADDLE_TPU_SDC_VERIFY_LOAD", "0")
        assert not verify_load_enabled()
        dst = _sharded(np.zeros_like(src))
        load_state_dict({"w": dst}, path)    # opted out: loads the damage
        assert (dst.numpy() != src).sum() == 1


class TestSnapshotFingerprints:
    def _snap(self, arr, step=5, gen=2):
        snap = {"shards": {"w": [((0, 0), arr)]},
                "shapes": {"w": (tuple(arr.shape), str(arr.dtype))},
                "step": step, "gen": gen}
        snap["fp"] = _snapshot_fingerprints(snap["shards"],
                                            SDCPolicy.from_env().seed)
        return snap

    def test_clean_restore(self):
        arr = _src(3, (4, 3))
        snap = self._snap(arr)
        state = {"w": torch.zeros((4, 3))}
        assert _restore_into(state, snap) == 5
        np.testing.assert_array_equal(state["w"].numpy(), arr)

    def test_corrupted_replica_fails_this_rung(self):
        arr = _src(4, (4, 3))
        snap = self._snap(arr)
        bad = arr.copy()
        bad.reshape(-1).view(np.uint32)[0] ^= np.uint32(1 << 20)
        snap["shards"]["w"] = [((0, 0), bad)]   # corrupted after capture
        state = {"w": torch.zeros((4, 3))}
        with pytest.raises(SnapshotRestoreError, match="fingerprint"):
            _restore_into(state, snap)

    def test_verify_load_escape_hatch(self, monkeypatch):
        arr = _src(5, (4, 3))
        snap = self._snap(arr)
        bad = arr.copy()
        bad.reshape(-1).view(np.uint32)[0] ^= np.uint32(1 << 20)
        snap["shards"]["w"] = [((0, 0), bad)]
        monkeypatch.setenv("PADDLE_TPU_SDC_VERIFY_LOAD", "0")
        state = {"w": torch.zeros((4, 3))}
        _restore_into(state, snap)
        np.testing.assert_array_equal(state["w"].numpy(), bad)


# -- FleetSupervisor: exclude-list relaunch ----------------------------------

def _fast_policy(**kw):
    kw.setdefault("max_gang_restarts", 1)
    return GangPolicy(backoff=RestartPolicy(backoff_base=0.01,
                                            backoff_cap=0.02), **kw)


def _poison(argv, culprit, step=8):
    log_dir = argv[argv.index("--log_dir") + 1]
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "poison.json"), "w") as f:
        json.dump({"reason": SDC_POISON_REASON, "culprit": culprit,
                   "step": step, "detail": "test"}, f)


class TestExcludeListRelaunch:
    def test_sdc_poison_quarantines_slot_fresh_budget(self, tmp_path):
        calls = []

        def fake_launch(argv, env):
            calls.append((list(argv), dict(env)))
            if len(calls) == 1:
                _poison(argv, culprit=2)
                return 101
            return 0

        sup = FleetSupervisor("train.py", nproc_per_node=4,
                              log_dir=str(tmp_path / "log"),
                              policy=_fast_policy(), launch_fn=fake_launch)
        assert sup.run() == 0
        assert sup.excluded_slots == [2]
        assert sup.world_size == 3           # same topology minus one slot
        assert sup.gang_restarts == 0        # fresh budget, not a restart
        assert "PADDLE_TPU_EXCLUDE_SLOTS" not in calls[0][1]
        assert calls[1][1]["PADDLE_TPU_EXCLUDE_SLOTS"] == "2"
        # nproc stays 4: exclusion is NOT a degrade
        nprocs = [a[a.index("--nproc_per_node") + 1] for a, _ in calls]
        assert nprocs == ["4", "4"]

    def test_dense_rank_maps_through_prior_exclusions(self, tmp_path):
        calls = []

        def fake_launch(argv, env):
            calls.append(dict(env))
            if len(calls) == 1:
                _poison(argv, culprit=1)     # slot 1
                return 101
            if len(calls) == 2:
                # dense rank 2 of the world missing slot 1 runs on slot 3
                _poison(argv, culprit=2)
                return 101
            return 0

        sup = FleetSupervisor("train.py", nproc_per_node=4,
                              log_dir=str(tmp_path / "log"),
                              policy=_fast_policy(max_gang_restarts=2),
                              launch_fn=fake_launch)
        assert sup.run() == 0
        assert sup.excluded_slots == [1, 3]
        assert sup.world_size == 2
        assert calls[2]["PADDLE_TPU_EXCLUDE_SLOTS"] == "1,3"

    def test_quarantine_refused_at_the_floor(self, tmp_path):
        def fake_launch(argv, env):
            _poison(argv, culprit=0)
            return 101

        sup = FleetSupervisor("train.py", nproc_per_node=2,
                              log_dir=str(tmp_path / "log"),
                              policy=_fast_policy(max_gang_restarts=1,
                                                  degrade=False, min_procs=2),
                              launch_fn=fake_launch)
        # excluding would drop below min_procs: the normal restart budget
        # burns instead, and the run gives up rather than shrinking
        assert sup.run() == 101
        assert sup.excluded_slots == []
        assert sup.world_size == 2

    def test_non_sdc_poison_is_a_plain_restart(self, tmp_path):
        calls = []

        def fake_launch(argv, env):
            calls.append(1)
            if len(calls) == 1:
                log_dir = argv[argv.index("--log_dir") + 1]
                os.makedirs(log_dir, exist_ok=True)
                with open(os.path.join(log_dir, "poison.json"), "w") as f:
                    json.dump({"reason": "lease_expired", "culprit": 2}, f)
                return 101
            return 0

        sup = FleetSupervisor("train.py", nproc_per_node=4,
                              log_dir=str(tmp_path / "log"),
                              policy=_fast_policy(), launch_fn=fake_launch)
        assert sup.run() == 0
        assert sup.excluded_slots == []
        assert sup.gang_restarts == 1        # a crash spends the budget


# -- chaos e2e: bitflip → vote → quarantine → rewind → exact trajectory ------

# Training-shaped gang member under the real launcher/fault-domain stack.
# "Training" is a deterministic float32 recurrence every DP replica computes
# identically (the pure-DP bitwise contract). Rank 2 of gang epoch 1 is the
# lying chip: from `corrupt_at` on, every gradient passes through an armed
# sdc/bitflip spec (times=-1: sticky — and the flip seed advances per fire,
# so replays cannot reproduce the majority). The voted digest carries a
# crc32 of the exact grad/param bytes in its lanes, so ANY flipped bit
# moves it. Checkpoints commit BEFORE the vote observes the step — the
# generation written in the detection-lag window really exists on disk, and
# only the rewind ledger keeps the relaunch from resuming into it.
_SDC_MEMBER = textwrap.dedent("""
    import os, sys, zlib
    import numpy as np
    import paddle_tpu_torch  # noqa: F401  (package init: telemetry, env contract)
    from paddle_tpu_torch.distributed.checkpoint import faults
    from paddle_tpu_torch.distributed.fleet import fault_domain as fd_mod
    from paddle_tpu_torch.distributed.health.ledger import RewindLedger
    from paddle_tpu_torch.distributed.health.sdc import (SDCMonitor, SDCPolicy,
                                                         pack_digest)

    root, total, corrupt_at, traj_dir = sys.argv[1:5]
    total, corrupt_at = int(total), int(corrupt_at)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    epoch = int(os.environ["PADDLE_TPU_GANG_EPOCH"])
    d = fd_mod.init_from_env()
    assert d is not None and d.rank == rank

    bad = epoch == 1 and rank == 2
    if bad:
        faults.scope(faults.FaultSpec(op="sdc", pattern="*", mode="bitflip",
                                      times=-1, seed=7)).__enter__()

    def crcf(a):
        # crc32 of the exact bytes, viewed as one f32 lane: the digest is
        # compared bit-for-bit, so any flipped bit in a moves the vote
        return np.frombuffer(np.uint32([zlib.crc32(a.tobytes())
                                        & 0xFFFFFFFF]).tobytes(),
                             np.float32)[0]

    def compute(step, p):
        g = np.sin((np.arange(8, dtype=np.float32)
                    + np.float32(step)).astype(np.float32)).astype(np.float32)
        if bad and step >= corrupt_at:
            g = faults.fire("sdc", "grad_rank%d" % rank, data=g)
        newp = (p - np.float32(0.1) * g).astype(np.float32)
        lanes = np.asarray([crcf(g), np.abs(g).sum(),
                            crcf(newp), np.abs(newp).sum()], np.float32)
        return newp, lanes

    ledger = RewindLedger(root)
    prev_at = {}

    def replay(step):
        # re-execute the voted step's batch; the sticky spec re-fires with
        # an advanced seed, so the replay cannot reproduce the majority
        newp, lanes = compute(step, prev_at[step])
        return pack_digest(lanes)

    mon = SDCMonitor(SDCPolicy(every=2, confirm=2, max_lag=0,
                               vote_timeout=30.0),
                     domain=d, ledger=ledger, replay_fn=replay)

    start = 0
    for f in os.listdir(root):
        if f.startswith("state_") and f.endswith(".npy"):
            n = int(f[6:-4])
            # the rewind ledger filters generations inside a poisoned
            # window — the pre-corruption resume point wins
            if n > start and not ledger.poisoned(n):
                start = n
    params = np.zeros(8, np.float32)
    if start:
        params = np.load(os.path.join(root, "state_%d.npy" % start))

    log = open(os.path.join(traj_dir, "traj.%d" % rank), "a")
    for step in range(start + 1, total + 1):
        prev_at[step] = params
        params, lanes = compute(step, params)
        log.write("%d:%d:%s\\n" % (epoch, step, params.tobytes().hex()))
        log.flush()
        d._store.barrier("sdcstep/%d/%d" % (epoch, step), d.world_size,
                         timeout=60.0, rank=rank)
        if step % 2 == 0:
            if rank == 0:
                tmp = os.path.join(root, ".state_%d.tmp" % step)
                with open(tmp, "wb") as f:
                    np.save(f, params)
                os.replace(tmp, os.path.join(root, "state_%d.npy" % step))
            d._store.barrier("sdcckpt/%d/%d" % (epoch, step), d.world_size,
                             timeout=60.0, rank=rank)
            mon.note_checkpoint(step)
        mon.observe(step, lanes)   # sticky suspect: SystemExit(101) here
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


class TestBitflipChaosE2E:
    def test_notice_name_quarantine_rewind_exact(self, tmp_path):
        total, corrupt_at, world = 8, 5, 4
        script = tmp_path / "member.py"
        script.write_text(_SDC_MEMBER)
        root = tmp_path / "ckpts"
        root.mkdir()
        sup = FleetSupervisor(
            str(script), [str(root), str(total), str(corrupt_at),
                          str(tmp_path)],
            nproc_per_node=world, log_dir=str(tmp_path / "log"),
            policy=_fast_policy(max_gang_restarts=2, degrade=False),
            env={"PYTHONPATH": REPO + os.pathsep +
                 os.environ.get("PYTHONPATH", "")})
        assert sup.run() == 0

        # NAMED + QUARANTINED: the vote attributed the corruption to rank 2
        # and the relaunch ran the same topology minus that slot
        assert sup.epoch == 2
        assert sup.excluded_slots == [2]
        assert sup.world_size == world - 1
        assert sup.exit_codes[0] != 0 and sup.exit_codes[-1] == 0

        # the ledger holds the pre-corruption window, naming the culprit
        ledger = RewindLedger(str(root))
        entries = [e for e in ledger.entries() if e["reason"] == "sdc"]
        assert len(entries) == 1
        assert entries[0]["culprit"] == 2
        lo, hi = entries[0]["window"]
        assert lo < corrupt_at <= hi         # window covers the corruption

        expect = _analytic_trajectory(total)
        by_rank = {}
        for r in range(world):
            lines = [l.split(":") for l in
                     (tmp_path / f"traj.{r}").read_text().splitlines() if l]
            by_rank[r] = [(int(e), int(s), h) for e, s, h in lines]

        # NOTICED: in gang epoch 1 the lying rank's trajectory silently
        # diverged (finite, plausible, wrong) from the corruption step on —
        # while every honest rank stayed bitwise-analytic
        e1_bad = {s: h for e, s, h in by_rank[2] if e == 1}
        assert any(h != expect[s] for s, h in e1_bad.items()
                   if s >= corrupt_at)
        for s, h in e1_bad.items():
            if s < corrupt_at:
                assert h == expect[s]
        for r in (0, 1, 3):
            for e, s, h in by_rank[r]:
                if e == 1:
                    assert h == expect[s], (r, s)

        # REWOUND: the quarantined gen (committed inside the detection-lag
        # window) exists on disk, yet the relaunch resumed BEFORE it — the
        # ledger, not absence, excluded it
        assert (root / f"state_{hi}.npy").exists()
        e2_steps = sorted(s for r in range(world)
                          for e, s, h in by_rank[r] if e == 2)
        assert e2_steps and min(e2_steps) == lo + 1
        assert max(e2_steps) == total

        # EXACT: every epoch-2 step, on every surviving rank, is bitwise
        # identical to the analytic fault-free run
        for r in range(world):
            for e, s, h in by_rank[r]:
                if e == 2:
                    assert h == expect[s], (r, s)
