"""The training health guard of the port (ROADMAP A7b), from the
reference's ``tests/test_health_guard.py``: the spike detector, the
escalation window, the rewind ledger, the guarded ``TrainStep`` (a probe on
the device, a skip on the device), the scaler's found-inf feed, resumable
samplers and the end-to-end NaN-window → escalate → exit 101 → Supervisor
relaunch → resume-past-the-window run in real processes.

Beyond the reference's cases: a NaN step on ``llama_tiny`` with
``use_fused_adamw`` (B5's guarded form, its plain twin here) and on
``ernie_tiny`` leaves every parameter, master, slot and ``@t`` bit-equal,
and the healthy steps around it are bit-equal to an unguarded run that
never took that batch; every optimizer rule under a NaN step; a
``resnet18`` step whose batch-norm statistics are restored; the probe's
loss and grad norm against the JAX package's guarded step on the same
weights and batches (within ``tests/op_test.py``'s f32 row)."""

import json
import math
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed.health import HealthGuard as JaxHealthGuard
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import ernie as jernie
from paddle_tpu.models import llama_tiny as jax_llama_tiny

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed.fleet.elastic import (ELASTIC_EXIT_CODE,
                                                        RestartPolicy, Supervisor)
from paddle_tpu_torch.distributed.health import (LEDGER_NAME, HealthError,
                                                 HealthGuard, HealthPolicy,
                                                 RewindLedger, SpikeDetector)
from paddle_tpu_torch.distributed.health import guard as guard_mod
from paddle_tpu_torch.io import BatchSampler, DistributedBatchSampler
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, ernie, llama_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch import optimizer as O

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=2e-5, atol=1e-6)    # tests/op_test.py, float32
LOSS = dict(rtol=1e-4, atol=0)      # f32 training losses (test_torch_train.py)


@pytest.fixture(autouse=True)
def _on_cpu():
    paddle.set_device("cpu")
    yield
    paddle.set_device(None)


def _policy(**kw):
    kw.setdefault("escalate_after", 3)
    kw.setdefault("window", 20)
    kw.setdefault("cooldown", 5)
    kw.setdefault("max_lag", 0)
    kw.setdefault("min_history", 10 ** 6)  # statistical detector off
    return HealthPolicy(**kw)


class TestSpikeDetector:
    def test_flags_spike_after_warmup_and_recovers(self):
        det = SpikeDetector(window=64, min_history=8, loss_zmax=6.0)
        for i in range(8):
            assert det.observe(loss=1.0 + 0.01 * (i % 3)) is None
        reason = det.observe(loss=50.0)
        assert reason is not None and reason.startswith("loss_spike")
        assert det.observe(loss=1.01) is None

    def test_grad_norm_series_is_independent(self):
        det = SpikeDetector(window=64, min_history=4, grad_zmax=6.0)
        for _ in range(6):
            assert det.observe(loss=2.0, grad_norm=1.0) is None
        r = det.observe(loss=2.0, grad_norm=1e6)
        assert r is not None and r.startswith("grad_norm_spike")

    def test_nonfinite_and_warmup_samples_never_flag(self):
        det = SpikeDetector(min_history=4)
        assert det.observe(loss=float("nan")) is None
        assert det.observe(loss=1e9) is None

    def test_flat_history_does_not_explode_z(self):
        det = SpikeDetector(min_history=4, loss_zmax=6.0)
        for _ in range(6):
            det.observe(loss=1.0)
        assert det.observe(loss=1.001) is None


class TestHealthPolicyStateMachine:
    def test_escalates_after_k_anomalies_in_window(self):
        hits = []
        g = HealthGuard(_policy(escalate_after=3, window=10), on_escalate=hits.append)
        for s in range(1, 3):
            g.observe_host(s, float("nan"))
        assert not hits
        g.observe_host(3, float("nan"))
        assert len(hits) == 1 and hits[0]["window"] == [0, 3]

    def test_old_anomalies_age_out_of_window(self):
        hits = []
        g = HealthGuard(_policy(escalate_after=2, window=3, cooldown=100),
                        on_escalate=hits.append)
        g.observe_host(1, float("nan"))
        for s in range(2, 8):
            g.observe_host(s, 1.0)
        g.observe_host(8, float("nan"))
        assert not hits

    def test_cooldown_clears_the_anomaly_record(self):
        hits = []
        g = HealthGuard(_policy(escalate_after=2, window=100, cooldown=3),
                        on_escalate=hits.append)
        g.observe_host(1, float("nan"))
        for s in range(2, 6):
            g.observe_host(s, 1.0)
        g.observe_host(6, float("nan"))
        assert not hits and g.anomalies == 2

    def test_step_domain_stays_monotonic_after_restart(self, tmp_path):
        hits = []
        g = HealthGuard(_policy(escalate_after=3, window=5, cooldown=100),
                        root=str(tmp_path), on_escalate=hits.append)
        g.on_restart(100)
        g.observe_host(1, float("nan"))
        for s in range(2, 100):
            g.observe_host(s, 1.0)
        assert g._last_step == 199
        g.observe_host(100, float("nan"))
        g.observe_host(101, float("nan"))
        assert not hits and len(g._anomaly_steps) == 2
        g.observe_host(102, float("nan"))
        assert len(hits) == 1
        assert hits[0]["window"] == [100, 202]

    def test_env_kill_switch(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_HEALTH", "0")
        g = HealthGuard(_policy(escalate_after=1), on_escalate="raise")
        assert not g.active
        g.observe_host(1, float("nan"))
        assert g.steps_seen == 0 and g.anomalies == 0


class TestRewindLedger:
    def test_record_persist_reload(self, tmp_path):
        root = str(tmp_path)
        led = RewindLedger(root)
        led.record(step=7, resume_step=4, reason="non_finite")
        doc = json.load(open(os.path.join(root, LEDGER_NAME)))
        assert doc["rewinds"][0]["window"] == [4, 7]
        led2 = RewindLedger(root)
        assert len(led2) == 1 and led2.skip_ahead(4) == 3
        assert led2.skip_ahead(9) == 0

    def test_check_restart_fails_loudly_on_rewind_loop(self, tmp_path):
        led = RewindLedger(str(tmp_path))
        led.record(step=7, resume_step=4, reason="non_finite")
        assert led.check_restart(4, max_rewinds=2) == 3
        led.record(step=6, resume_step=4, reason="loss_spike z=9.0")
        with pytest.raises(HealthError) as ei:
            led.check_restart(4, max_rewinds=2)
        assert "[4, 6]" in str(ei.value) and "step 4" in str(ei.value)

    def test_unreadable_ledger_degrades_to_empty(self, tmp_path):
        (tmp_path / LEDGER_NAME).write_text("{not json")
        led = RewindLedger(str(tmp_path))
        assert led.entries() == [] and led.check_restart(0) == 0

    def test_in_memory_mode_needs_no_filesystem(self):
        led = RewindLedger(None)
        led.record(step=3, resume_step=0, reason="x")
        assert len(led) == 1 and led.skip_ahead(0) == 3

    def test_ledger_file_crosses_between_packages(self, tmp_path):
        from paddle_tpu.distributed.health import RewindLedger as JaxLedger

        RewindLedger(str(tmp_path)).record(step=9, resume_step=2, reason="non_finite")
        assert JaxLedger(str(tmp_path)).skip_ahead(2) == 7


def _tiny_step(guard, lr=1e-2):
    paddle.seed(0)
    model = nn.Linear(8, 4)
    opt = O.SGD(lr, parameters=model.parameters())
    step = TrainStep(model, lambda m, x, y: F.mse_loss(m(x), y), opt, health_guard=guard)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8)).astype("float32")
    y = rng.standard_normal((4, 4)).astype("float32")
    return model, step, x, y


class TestTrainStepProbe:
    def test_nan_batch_skipped_in_program_then_recovers(self):
        guard = HealthGuard(_policy(escalate_after=10), on_escalate="raise")
        model, step, x, y = _tiny_step(guard)
        step(x, y)
        w1 = model.weight.detach().clone()
        xn = x.copy()
        xn[0, 0] = np.nan
        loss = step(xn, y)
        assert math.isnan(float(loss))
        assert torch.equal(w1, model.weight.detach())
        assert guard.steps_skipped == 1 and guard.anomalies == 1
        step(x, y)
        assert not torch.equal(w1, model.weight.detach())
        assert guard.steps_skipped == 1

    def test_healthy_run_counts_zero_skips(self):
        guard = HealthGuard(_policy(), on_escalate="raise")
        model, step, x, y = _tiny_step(guard)
        losses = [float(step(x, y)) for _ in range(5)]
        guard.flush()
        assert guard.steps_skipped == 0 and guard.anomalies == 0
        assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]

    def test_escalation_raises_for_inprocess_callers(self):
        guard = HealthGuard(_policy(escalate_after=2), on_escalate="raise")
        model, step, x, y = _tiny_step(guard)
        xn = np.full_like(x, np.inf)
        with pytest.raises(HealthError, match="escalated"):
            for _ in range(4):
                step(xn, y)
        assert guard.rewinds == 1 and len(guard.ledger) == 1

    def test_lagged_probe_defers_but_never_loses_verdicts(self):
        guard = HealthGuard(_policy(escalate_after=100, max_lag=3), on_escalate="raise")
        model, step, x, y = _tiny_step(guard)
        xn = x.copy()
        xn[0, 0] = np.nan
        step(xn, y)
        assert guard.steps_skipped == 0
        w = model.weight.detach().clone()
        for _ in range(3):
            step(x, y)
        assert guard.steps_skipped == 1
        guard.flush()
        assert guard.steps_seen == 4
        assert not torch.equal(w, model.weight.detach())

    def test_distributed_step_probe_pins_shardings(self):
        """The guarded DistributedTrainStep on dp2 x sharding4 (one
        controller, eight CPU members): a NaN batch leaves every member's
        block as it was, then training goes on."""
        from paddle_tpu_torch import distributed as dist
        from paddle_tpu_torch.distributed import DistributedTrainStep, topology

        try:
            s = dist.fleet.DistributedStrategy()
            s.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1,
                                "sharding_degree": 4}
            dist.fleet.init(is_collective=True, strategy=s, devices=["cpu"] * 8)
            paddle.seed(0)
            model = nn.Linear(16, 8)
            opt = O.AdamW(1e-2, parameters=model.parameters())
            guard = HealthGuard(_policy(escalate_after=10), on_escalate="raise")
            step = DistributedTrainStep(model, lambda m, x, y: F.mse_loss(m(x), y), opt,
                                        dist.get_hybrid_communicate_group(),
                                        sharding_stage=1, health_guard=guard)
            rng = np.random.default_rng(0)
            x = rng.standard_normal((16, 16)).astype("float32")
            y = rng.standard_normal((16, 8)).astype("float32")
            step(x, y)
            before = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                      for k, v in opt.state_dict().items() if k != "LR_Scheduler"}
            w = model.weight.detach().clone()
            xn = x.copy()
            xn[3, 3] = np.inf
            step(xn, y)
            assert torch.equal(w, model.weight.detach())
            after = opt.state_dict()
            for k, v in before.items():
                if k == "@step":
                    assert after[k] == v + 1
                elif isinstance(v, torch.Tensor):
                    assert torch.equal(v, after[k]), k
                else:
                    assert v == after[k], k
            assert guard.steps_skipped == 1
            loss = step(x, y)
            assert math.isfinite(float(loss)) and not torch.equal(w, model.weight.detach())
        finally:
            topology.set_hybrid_communicate_group(None)

    def test_check_nan_inf_flag_still_raises_without_guard(self):
        model, step, x, y = _tiny_step(None)
        xn = np.full_like(x, np.nan)
        paddle.set_flags({"check_nan_inf": True})
        try:
            with pytest.raises(RuntimeError, match="check_nan_inf"):
                step(xn, y)
        finally:
            paddle.set_flags({"check_nan_inf": False})

    def test_guard_subsumes_check_nan_inf(self):
        """Under the guard the flag's raise is the guard's skip (reference
        ``jit/__init__.py:843``)."""
        guard = HealthGuard(_policy(escalate_after=10), on_escalate="raise")
        model, step, x, y = _tiny_step(guard)
        w = model.weight.detach().clone()
        paddle.set_flags({"check_nan_inf": True})
        try:
            loss = step(np.full_like(x, np.nan), y)
        finally:
            paddle.set_flags({"check_nan_inf": False})
        assert math.isnan(float(loss)) and guard.steps_skipped == 1
        assert torch.equal(w, model.weight.detach())
        assert paddle.get_flags("check_nan_inf") == {"check_nan_inf": False}

    def test_step_hooks_stamp_first_step(self, tmp_path, monkeypatch):
        """``PADDLE_TPU_FIRST_STEP_STAMP``: the first completed step writes
        a wall-clock stamp, once a path; the fleet note is one global
        read without a domain."""
        from paddle_tpu_torch.distributed.fleet import fault_domain

        stamp = tmp_path / "first_step"
        monkeypatch.setenv("PADDLE_TPU_FIRST_STEP_STAMP", str(stamp))
        model, step, x, y = _tiny_step(None)
        step(x, y)
        first = stamp.read_text()
        assert float(first) > 0
        stamp.write_text("kept")
        step(x, y)
        assert stamp.read_text() == "kept" and fault_domain.current() is None


def _states(opt, model):
    """Every parameter, master, slot and ``@t`` (as numbers) of ``opt``."""
    out = {f"param.{n}": p.detach().clone() for n, p in model.named_parameters()}
    for k, v in opt.state_dict().items():
        if k in ("LR_Scheduler", "@step"):
            continue
        out[k] = v.clone() if isinstance(v, torch.Tensor) else int(v)
    return out


def _assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _guarded_run(make, batches, poison_at=None, guard=True, flags=None, opt_fn=None,
                 steps_since=None):
    """``make()`` → model; AdamW (or ``opt_fn``) + clip TrainStep over
    ``batches`` with the loss times a scalar that is NaN at ``poison_at``.
    Returns (losses, the states after each step, guard)."""
    model = make()
    opt = opt_fn(model) if opt_fn else O.AdamW(
        1e-3, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    g = HealthGuard(_policy(escalate_after=100, max_lag=1), on_escalate="raise") \
        if guard else None
    scale = torch.ones(())
    step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0] * scale, opt, health_guard=g)
    losses, states = [], []
    with paddle.flag_guard(**(flags or {})):
        for i, (x, y) in enumerate(batches):
            scale.fill_(float("nan") if i == poison_at else 1.0)
            losses.append(float(step(x, y)))
            states.append(_states(opt, model))
    if g is not None:
        g.flush()
    return losses, states, g


def _llama_make():
    return LlamaForCausalLM(llama_tiny(), device="cpu", seed=3)


def _ernie_make():
    paddle.seed(4)
    return ernie.ErnieForSequenceClassification(
        ernie.ernie_tiny(hidden_dropout_prob=0.0), 2,
        device="cpu")


def _llama_batches(n):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        ids = rng.integers(1, llama_tiny().vocab_size, (2, 16)).astype(np.int32)
        out.append((ids, np.roll(ids, -1, axis=1)))
    return out


def _ernie_batches(n):
    rng = np.random.default_rng(6)
    return [(rng.integers(0, 256, (4, 16)).astype(np.int32),
             rng.integers(0, 2, (4,)).astype(np.int64)) for _ in range(n)]


@pytest.mark.parametrize("kind,flags", [
    ("llama", {"use_fused_adamw": True}), ("llama", {}), ("ernie", {"use_fused_adamw": True})],
    ids=["llama_fused_adamw", "llama_plain", "ernie_fused_adamw"])
def test_nan_step_skipped_bit_exact(kind, flags):
    """Steps 0, 1 healthy, step 2 poisoned, steps 3, 4 healthy: the guarded
    run's states before the poison are bit-equal to an unguarded run's,
    the poisoned step changes no parameter, master, slot or ``@t``, and the
    steps after it are bit-equal to an unguarded run that never took that
    batch."""
    make, batches = (_llama_make, _llama_batches(5)) if kind == "llama" else \
        (_ernie_make, _ernie_batches(5))
    losses, states, g = _guarded_run(make, batches, poison_at=2, flags=flags)
    assert g.steps_skipped == 1 and g.steps_seen == 5
    assert math.isnan(losses[2]) and all(math.isfinite(v) for i, v in enumerate(losses)
                                         if i != 2)
    _assert_states_equal(states[1], states[2])
    control = batches[:2] + batches[3:]
    c_losses, c_states, _ = _guarded_run(make, control, guard=False, flags=flags)
    assert losses[:2] == c_losses[:2] and losses[3:] == c_losses[2:]
    for mine, theirs in zip(states[:2] + states[3:], c_states):
        _assert_states_equal(mine, theirs)
    ts = [v for k, v in states[-1].items() if k.endswith("@t")]
    assert ts and max(ts) == 4


def test_healthy_guarded_steps_bit_equal_unguarded_fused_masters():
    """bf16 O2 with masters and B5's guarded form: a healthy guarded run is
    the unguarded run to the bit, ``@t`` written as an integer."""
    def make():
        model = _llama_make()
        return model

    def opt_fn(model):
        opt = O.AdamW(1e-3, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
        paddle.amp.decorate(model, opt, level="O2", dtype="bfloat16")
        return opt

    batches = _llama_batches(3)
    a = _guarded_run(make, batches, flags={"use_fused_adamw": True}, opt_fn=opt_fn)
    b = _guarded_run(make, batches, guard=False, flags={"use_fused_adamw": True}, opt_fn=opt_fn)
    assert a[0] == b[0]
    for x, y in zip(a[1], b[1]):
        _assert_states_equal(x, y)
    assert any(k.endswith("master_weight") for k in a[1][-1])
    assert {v for k, v in a[1][-1].items() if k.endswith("@t")} == {3}


RULES = {
    "SGD": lambda ps: O.SGD(0.1, parameters=ps, weight_decay=1e-3),
    "Momentum": lambda ps: O.Momentum(0.1, momentum=0.9, parameters=ps, use_nesterov=True),
    "Adam": lambda ps: O.Adam(0.01, parameters=ps, weight_decay=1e-3),
    "AdamW": lambda ps: O.AdamW(0.01, parameters=ps),
    "Adam_amsgrad": lambda ps: O.Adam(0.01, parameters=ps, amsgrad=True),
    "Adamax": lambda ps: O.Adamax(0.01, parameters=ps),
    "Adagrad": lambda ps: O.Adagrad(0.1, parameters=ps, initial_accumulator_value=0.1),
    "Adadelta": lambda ps: O.Adadelta(1.0, parameters=ps),
    "RMSProp": lambda ps: O.RMSProp(0.01, parameters=ps, momentum=0.9, centered=True),
    "Lamb": lambda ps: O.Lamb(0.01, parameters=ps),
}


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_flag"])
def test_every_rule_skips_a_nan_step(rule, fused):
    """Each rule under a NaN step with the global-norm clip (its scale turns
    NaN): every parameter, slot and ``@t`` stays as it was, and the healthy
    steps are the unguarded rule's to the bit."""
    def make():
        paddle.seed(7)
        return nn.Sequential(nn.Linear(6, 5), nn.Linear(5, 3))

    def opt_fn(model):
        opt = RULES[rule](model.parameters())
        opt._grad_clip = ClipGradByGlobalNorm(1.0)
        return opt

    rng = np.random.default_rng(8)
    batches = [(rng.standard_normal((4, 6)).astype(np.float32),
                rng.standard_normal((4, 3)).astype(np.float32)) for _ in range(4)]

    def run(batches, poison_at=None, guard=True):
        model = make()
        opt = opt_fn(model)
        g = HealthGuard(_policy(escalate_after=100), on_escalate="raise") if guard else None
        scale = torch.ones(())
        step = TrainStep(model, lambda m, x, y: F.mse_loss(m(x), y) * scale, opt,
                         health_guard=g)
        states = []
        with paddle.flag_guard(use_fused_adamw=fused):
            for i, (x, y) in enumerate(batches):
                scale.fill_(float("nan") if i == poison_at else 1.0)
                step(x, y)
                states.append(_states(opt, model))
        return states, g

    states, g = run(batches, poison_at=1)
    assert g.steps_skipped == 1
    _assert_states_equal(states[0], states[1])
    control, _ = run(batches[:1] + batches[2:], guard=False)
    for mine, theirs in zip(states[:1] + states[2:], control):
        _assert_states_equal(mine, theirs)


def test_resnet18_batch_norm_statistics_restored():
    """A guarded ``resnet18`` step on a NaN batch: the forward updated the
    batch-norm running statistics in place, and the skip selects them back
    (with every parameter and velocity)."""
    from paddle_tpu_torch.vision.models import resnet

    paddle.seed(9)
    model = resnet.resnet18(num_classes=10, data_format="NCHW")
    opt = O.Momentum(0.01, parameters=model.parameters())
    guard = HealthGuard(_policy(escalate_after=10), on_escalate="raise")
    step = TrainStep(model, lambda m, x, y: F.cross_entropy(m(x), y).mean(), opt,
                     health_guard=guard)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, (2,)).astype(np.int64)
    step(x, y)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = _states(opt, model)
    xn = x.copy()
    xn[0, 0, 0, 0] = np.nan
    assert math.isnan(float(step(xn, y)))
    assert guard.steps_skipped == 1
    after = model.state_dict()
    assert any("_mean" in k for k in before)
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    _assert_states_equal(opt_before, _states(opt, model))
    step(x, y)
    assert not all(torch.equal(v, model.state_dict()[k]) for k, v in before.items()
                   if "_mean" in k)


class _Recorder:
    """Records every probe the guard is fed, as host values."""

    def __init__(self, guard_cls, values):
        outer = self

        class Rec(guard_cls):
            def on_step(self, probe, step=None):
                outer.probes.append(values(probe))
                return super().on_step(probe, step)

        self.probes = []
        self.guard = Rec(_policy(escalate_after=100), on_escalate="raise")


@pytest.mark.parametrize("kind", ["llama", "ernie"])
def test_probe_matches_jax_guarded_step(kind):
    """The same weights and batches (one poisoned by a NaN loss scale)
    through both packages' guarded ``TrainStep``: the probe's loss and
    grad norm within the f32 rows, ``ok`` equal."""
    if kind == "llama":
        jpaddle.seed(11)
        jm = JaxLlama(jax_llama_tiny())
        tm = LlamaForCausalLM(llama_tiny(), device="cpu")
        batches = _llama_batches(4)
    else:
        jpaddle.seed(12)
        cfg = dict(hidden_dropout_prob=0.0)
        jm = jernie.ErnieForSequenceClassification(jernie.ernie_tiny(**cfg), 2)
        tm = ernie.ErnieForSequenceClassification(ernie.ernie_tiny(**cfg), 2, device="cpu")
        batches = _ernie_batches(4)
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    scales = [np.array([1.0 if i != 2 else np.nan], np.float32) for i in range(4)]

    jrec = _Recorder(JaxHealthGuard, lambda p: np.asarray(p, np.float64)[:3])
    jopt = jpaddle.optimizer.AdamW(1e-3, parameters=jm.parameters(),
                                   grad_clip=jpaddle.nn.ClipGradByGlobalNorm(1.0))
    jstep = jpaddle.jit.TrainStep(jm, lambda m, x, y, s: m(x, labels=y)[0] * s[0], jopt,
                                  health_guard=jrec.guard)
    for (x, y), s in zip(batches, scales):
        jstep(jpaddle.to_tensor(x), jpaddle.to_tensor(y), jpaddle.to_tensor(s))

    rec = _Recorder(HealthGuard, lambda p: guard_mod._probe_values(p).astype(np.float64)[:3])
    opt = O.AdamW(1e-3, parameters=tm.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(tm, lambda m, x, y, s: m(x, labels=y)[0] * s[0], opt,
                     health_guard=rec.guard)
    for (x, y), s in zip(batches, scales):
        step(x, y, s)
    want, got = np.array(jrec.probes), np.array(rec.probes)
    assert got.shape == want.shape == (4, 3)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    assert list(got[:, 1]) == [1.0, 1.0, 0.0, 1.0]
    healthy = [0, 1, 3]
    np.testing.assert_allclose(got[healthy, 0], want[healthy, 0], **LOSS)
    np.testing.assert_allclose(got[healthy, 2], want[healthy, 2], rtol=1e-4, atol=1e-6)
    assert np.isnan(got[2, 0]) and np.isnan(want[2, 0])
    assert rec.guard.steps_skipped == jrec.guard.steps_skipped == 1
    # the state after the whole run, as the JAX step left it
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[name].numpy(), rtol=0,
                                   atol=2 * 1e-3 * 3, err_msg=name)


def test_probe_staging_counts_waits_only_on_the_card():
    """On the CPU a probe is on the host already: no event, no wait."""
    before = guard_mod.probe_event_waits()
    h = guard_mod.stage_probe(torch.tensor([1.0, 1.0, 2.0]))
    assert guard_mod.stage_probe(h) is h
    np.testing.assert_array_equal(h.values(), [1.0, 1.0, 2.0])
    assert h.values() is h.values()
    assert guard_mod.probe_event_waits() == before


class TestAmpScalerFusedUnscale:
    def test_single_reduction_skip_feeds_guard(self):
        guard = HealthGuard(_policy(escalate_after=100), on_escalate="raise")
        paddle.seed(0)
        m = nn.Linear(4, 4)
        opt = O.SGD(0.1, parameters=m.parameters())
        sc = paddle.amp.AmpScaler(enable=True, init_loss_scaling=4.0)
        sc.attach_health_guard(guard)
        x = torch.ones(2, 4)
        loss = sc.scale(m(x).sum())
        loss.backward()
        m.weight.grad = torch.full((4, 4), float("inf"))
        w = m.weight.detach().clone()
        sc.step(opt)
        assert torch.equal(w, m.weight.detach())
        assert guard.steps_skipped == 1
        assert sc.get_loss_scaling() == 2.0

    def test_healthy_unscale_division_exact(self):
        paddle.seed(0)
        m = nn.Linear(4, 2)
        opt = O.SGD(0.1, parameters=m.parameters())
        sc = paddle.amp.GradScaler(enable=True, init_loss_scaling=8.0)
        loss = sc.scale(m(torch.ones(2, 4)).sum())
        loss.backward()
        g_scaled = m.weight.grad.clone()
        sc.unscale_(opt)
        np.testing.assert_allclose(m.weight.grad.numpy(), g_scaled.numpy() / 8.0, rtol=1e-6)


class TestStepMeterFeed:
    def test_stepmeter_feeds_the_detector(self):
        from paddle_tpu_torch.telemetry import StepMeter

        hits = []
        guard = HealthGuard(_policy(escalate_after=2, window=10), on_escalate=hits.append)
        meter = StepMeter("t", jsonl_path=False, health_guard=guard)
        meter.step(loss=1.0)
        meter.step(loss=float("nan"))
        meter.step(loss=float("inf"))
        assert guard.steps_seen == 3 and guard.anomalies == 2 and len(hits) == 1


class _DS:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


class TestSamplerStateDict:
    def test_batch_sampler_mid_epoch_resume(self):
        bs = BatchSampler(_DS(20), batch_size=4, drop_last=True)
        full = list(bs)
        it = iter(bs)
        next(it), next(it)
        st = bs.state_dict()
        assert st == {"epoch": 0, "position": 2}
        res = BatchSampler(_DS(20), batch_size=4, drop_last=True)
        res.set_state_dict(st)
        assert list(res) == full[2:]

    def test_fast_forward_skips_poisoned_window(self):
        full = list(BatchSampler(_DS(20), batch_size=4, drop_last=True))
        res = BatchSampler(_DS(20), batch_size=4, drop_last=True)
        res.set_state_dict({"epoch": 0, "position": 1})
        res.fast_forward(2)
        assert list(res) == full[3:]

    def test_distributed_sampler_epoch_seeded_resume(self):
        a = DistributedBatchSampler(_DS(17), batch_size=2, num_replicas=2, rank=1,
                                    shuffle=True)
        a.set_epoch(5)
        full = list(a)
        b = DistributedBatchSampler(_DS(17), batch_size=2, num_replicas=2, rank=1,
                                    shuffle=True)
        b.set_state_dict({"epoch": 5, "position": 3})
        assert list(b) == full[3:]

    def test_worker_loader_tracks_delivered_position(self):
        """Threaded workers (the port's; worker processes are ROADMAP A10):
        the position counts batches delivered, so a mid-epoch snapshot and
        fast-forward land on the right batch."""
        from paddle_tpu_torch.io import DataLoader

        class DS:
            def __len__(self):
                return 24

            def __getitem__(self, i):
                return np.float32(i)

        def mk():
            return DataLoader(DS(), batch_size=4, num_workers=2, use_process_workers=False)

        full = [b.numpy().tolist() for b in mk()]
        dl = mk()
        it = iter(dl)
        next(it), next(it), next(it)
        assert dl.state_dict() == {"epoch": 0, "position": 3}
        res = mk()
        res.set_state_dict({"epoch": 0, "position": 3})
        res.batch_sampler.fast_forward(1)
        assert [b.numpy().tolist() for b in res] == full[4:]
        assert res.state_dict()["position"] == 0

    def test_state_rides_the_checkpoint_payload(self, tmp_path):
        from paddle_tpu_torch.distributed.checkpoint import (latest_checkpoint,
                                                             load_state_dict, save_state_dict)

        state = {"w": torch.arange(4, dtype=torch.float32),
                 "sampler": {"epoch": 2, "position": 7}}
        save_state_dict(state, str(tmp_path / "ck"),
                        commit_extra={"health": {"steps_skipped": 1}})
        dst = {"w": torch.zeros(4), "sampler": {"epoch": 0, "position": 0}}
        load_state_dict(dst, latest_checkpoint(str(tmp_path)))
        assert dst["sampler"] == {"epoch": 2, "position": 7}
        marker = json.load(open(tmp_path / "ck" / "COMMITTED"))
        assert marker["health"] == {"steps_skipped": 1}


CHILD_SCRIPT = """
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.distributed.checkpoint import (latest_checkpoint,
    load_state_dict, save_state_dict)
from paddle_tpu_torch.distributed.health import HealthGuard, HealthPolicy
from paddle_tpu_torch.io import BatchSampler
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import SGD

paddle.set_device("cpu")
root, total, log = sys.argv[1], int(sys.argv[2]), sys.argv[3]

# 16 batches of 4; samples 12..19 (batches 3 and 4) are the poisoned window
rng = np.random.default_rng(7)
X = rng.standard_normal((64, 8)).astype("float32")
Y = rng.standard_normal((64, 4)).astype("float32")
X[12:20] = np.nan

class DS:
    def __len__(self): return 64
    def __getitem__(self, i): return i

paddle.seed(0)
model = nn.Linear(8, 4)
opt = SGD(1e-2, parameters=model.parameters())
guard = HealthGuard(HealthPolicy(escalate_after=2, window=8, cooldown=4,
                                 max_lag=0, min_history=10**6), root=root)
step = TrainStep(model, lambda m, x, y: F.mse_loss(m(x), y), opt, health_guard=guard)
sampler = BatchSampler(DS(), batch_size=4, drop_last=True)

cur = 0
resume = latest_checkpoint(root)
if resume:
    state = {**model.state_dict(), "step": torch.tensor(0, dtype=torch.int64),
             "sampler": {"epoch": 0, "position": 0}}
    load_state_dict(state, resume)
    cur = int(state["step"])
    sampler.set_state_dict(state["sampler"])
    skipped = guard.on_restart(cur, sampler=sampler)  # HealthError on loop
    with open(log, "a") as f:
        f.write(f"resumed:{cur}:skip{skipped}\\n")

for batch_idx in sampler:
    if cur >= total:
        break
    loss = step(X[batch_idx], Y[batch_idx])  # may exit 101
    cur += 1
    with open(log, "a") as f:
        f.write(f"{cur}:{batch_idx[0]}:{float(loss):.4f}\\n")
    if cur % 2 == 0:
        save_state_dict({**model.state_dict(), "step": torch.tensor(cur, dtype=torch.int64),
                         "sampler": sampler.state_dict()},
                        os.path.join(root, f"step_{cur}"), keep_n=4,
                        commit_extra=guard.commit_extra())
        guard.note_checkpoint(cur)
"""


class TestEndToEndRewind:
    def test_nan_window_skip_escalate_relaunch_resume_past(self, tmp_path):
        """Batches 3-4 are NaN: the child skips them on the device,
        escalates on the second anomaly (exit 101, a ledger entry, a
        recorder dump), the port's Supervisor relaunches it, and the
        relaunch resumes from the step-4 checkpoint with the sampler past
        the poisoned window — batch 4 is never replayed."""
        script = tmp_path / "child.py"
        script.write_text(textwrap.dedent(CHILD_SCRIPT))
        root, log = str(tmp_path / "ckpts"), str(tmp_path / "log.txt")
        os.makedirs(root)
        env = {**os.environ, "PYTHONPATH": REPO,
               "PADDLE_TPU_FLIGHT_RECORDER_DIR": str(tmp_path / "fr")}
        sup = Supervisor([sys.executable, str(script), root, "10", log],
                         policy=RestartPolicy(max_restarts=3, backoff_base=0.01,
                                              backoff_cap=0.02),
                         env=env, ckpt_root=root, keep_n=4, child_timeout=120)
        assert sup.run() == 0
        assert sup.restarts == 1
        assert sup.exit_codes == [ELASTIC_EXIT_CODE, 0]
        lines = [ln for ln in open(log).read().splitlines() if ln]
        assert [ln for ln in lines if ln.startswith("resumed")] == ["resumed:4:skip1"]
        steps = [(int(ln.split(":")[0]), int(ln.split(":")[1]))
                 for ln in lines if not ln.startswith("resumed")]
        assert steps[:4] == [(1, 0), (2, 4), (3, 8), (4, 12)]
        assert steps[4:] == [(5, 20), (6, 24), (7, 28), (8, 32), (9, 36), (10, 40)]
        assert all(s != 16 for _, s in steps), "poisoned batch replayed"
        assert math.isnan(float(lines[3].split(":")[2]))
        post = [float(ln.split(":")[2]) for ln in lines if not ln.startswith("resumed")][4:]
        assert all(math.isfinite(v) for v in post)
        doc = json.load(open(os.path.join(root, "rewind_ledger.json")))
        assert len(doc["rewinds"]) == 1
        entry = doc["rewinds"][0]
        assert entry["window"] == [4, 5] and entry["reason"] == "non_finite"
        assert entry["steps_skipped"] == 2
        assert any("health_rewind" in d for d in os.listdir(tmp_path / "fr"))
        latest = max((d for d in os.listdir(root) if d.startswith("step_")),
                     key=lambda d: int(d.split("_")[1]))
        marker = json.load(open(os.path.join(root, latest, "COMMITTED")))
        assert marker["health"]["rewinds"] == 1
        assert marker["health"]["steps_skipped"] == 0

    def test_rewind_loop_fails_loudly_not_101(self, tmp_path):
        root = str(tmp_path)
        led = RewindLedger(root)
        led.record(step=7, resume_step=4, reason="non_finite")
        led.record(step=9, resume_step=4, reason="non_finite")

        def job():
            HealthGuard(_policy(), root=root).on_restart(4)

        sup = Supervisor(job, policy=RestartPolicy(max_restarts=3, backoff_base=0.01))
        with pytest.raises(HealthError, match="rewound to step 4"):
            job()
        with pytest.raises(HealthError):
            sup.run()
