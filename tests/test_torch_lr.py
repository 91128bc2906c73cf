"""The port's learning-rate schedules (``optimizer/lr.py``) against the JAX
package's: every schedule's value after each of 40 ``step()`` calls equal
to the reference's within 1e-12; ``ReduceOnPlateau.step(metrics)`` with
a 0-d tensor; ``state_dict``/``set_dict`` carrying a schedule midway, in
both directions; ``as_fn``; and a schedule driving an optimizer."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch as ptt
from paddle_tpu_torch.optimizer import lr as plr

torch.set_num_threads(1)

STEPS = 40
EXACT = 1e-12


def _lam(epoch):
    return 0.95 ** epoch


# (name, constructor of a schedule given the lr module)
SCHEDULES = [
    ("NoamDecay", lambda m: m.NoamDecay(d_model=64, warmup_steps=8, learning_rate=2.0)),
    ("ExponentialDecay", lambda m: m.ExponentialDecay(0.5, gamma=0.9)),
    ("NaturalExpDecay", lambda m: m.NaturalExpDecay(0.5, gamma=0.1)),
    ("InverseTimeDecay", lambda m: m.InverseTimeDecay(0.5, gamma=0.2)),
    ("PolynomialDecay", lambda m: m.PolynomialDecay(0.5, decay_steps=15, end_lr=0.01,
                                                    power=2.0)),
    ("PolynomialDecay_cycle", lambda m: m.PolynomialDecay(0.5, decay_steps=7, end_lr=0.01,
                                                          power=1.5, cycle=True)),
    ("PiecewiseDecay", lambda m: m.PiecewiseDecay([5, 12, 30], [0.1, 0.05, 0.01, 0.001])),
    ("LinearWarmup", lambda m: m.LinearWarmup(0.3, warmup_steps=10, start_lr=0.0,
                                              end_lr=0.3)),
    ("LinearWarmup_cosine", lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.3, T_max=20), warmup_steps=6, start_lr=0.01, end_lr=0.3)),
    ("CosineAnnealingDecay", lambda m: m.CosineAnnealingDecay(0.2, T_max=25, eta_min=0.01)),
    ("CosineAnnealingWarmRestarts", lambda m: m.CosineAnnealingWarmRestarts(
        0.2, T_0=5, T_mult=2, eta_min=0.001)),
    ("StepDecay", lambda m: m.StepDecay(0.4, step_size=7, gamma=0.5)),
    ("MultiStepDecay", lambda m: m.MultiStepDecay(0.4, milestones=[3, 10, 25], gamma=0.3)),
    ("LambdaDecay", lambda m: m.LambdaDecay(0.4, lr_lambda=_lam)),
    ("MultiplicativeDecay", lambda m: m.MultiplicativeDecay(0.4, lr_lambda=lambda e: 0.97)),
    ("ConstantLR", lambda m: m.ConstantLR(0.4, factor=0.25, total_iters=9)),
    ("LinearLR", lambda m: m.LinearLR(0.4, total_steps=17, start_factor=0.1,
                                      end_factor=0.9)),
    ("OneCycleLR", lambda m: m.OneCycleLR(0.5, total_steps=35, divide_factor=20.0,
                                          end_learning_rate=0.001, phase_pct=0.25)),
    ("CyclicLR_triangular", lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                                 step_size_down=6)),
    ("CyclicLR_triangular2", lambda m: m.CyclicLR(0.01, 0.1, step_size_up=5,
                                                  mode="triangular2")),
    ("CyclicLR_exp_range", lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3,
                                                mode="exp_range", exp_gamma=0.97)),
]


def _trace(sched, steps=STEPS):
    out = [sched()]
    for _ in range(steps):
        sched.step()
        out.append(sched())
    return out


def test_every_reference_schedule_is_ported():
    assert set(plr.__all__) == set(jlr.__all__)
    covered = {n.split("_")[0] for n, _ in SCHEDULES} | {"ReduceOnPlateau", "LRScheduler"}
    assert covered == set(jlr.__all__)


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[n for n, _ in SCHEDULES])
def test_schedule_values(name, make):
    got, want = _trace(make(plr)), _trace(make(jlr))
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    assert len(set(np.round(got, 12))) > 1, "the schedule never moves in 40 steps"


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[n for n, _ in SCHEDULES])
def test_state_dict_midway_crosses(name, make):
    """Fifteen steps in one package, ``set_dict`` into a fresh schedule of
    the other, fifteen more in both: equal."""
    for src, dst in ((plr, jlr), (jlr, plr)):
        a = make(src)
        for _ in range(15):
            a.step()
        b = make(dst)
        b.set_dict(a.state_dict())
        np.testing.assert_allclose(_trace(b, 15), _trace(a, 15), rtol=0, atol=EXACT)


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[n for n, _ in SCHEDULES])
def test_as_fn(name, make):
    sched = make(plr)
    before = sched()
    fn, ref = sched.as_fn(), make(jlr).as_fn()
    for step in range(0, STEPS, 3):
        assert abs(fn(step) - ref(step)) <= EXACT
    assert sched() == before          # the scheduler itself did not move


@pytest.mark.parametrize("mode,threshold_mode", [("min", "rel"), ("min", "abs"),
                                                 ("max", "rel"), ("max", "abs")])
def test_reduce_on_plateau(mode, threshold_mode):
    """``step(metrics)`` with a plateauing series: a float for the
    reference, a 0-d tensor for the port (the reference takes its
    arrays), cooldown and min_lr included."""
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=0.01,
              threshold_mode=threshold_mode, cooldown=1, min_lr=0.01)
    got, want = plr.ReduceOnPlateau(0.4, **kw), jlr.ReduceOnPlateau(0.4, **kw)
    rng = np.random.default_rng(5)
    series = np.concatenate([np.linspace(1.0, 0.5, 8), np.full(12, 0.5),
                             0.5 + 0.001 * rng.standard_normal(20)])
    if mode == "max":
        series = 2.0 - series
    lrs = []
    for v in series:
        got.step(torch.tensor(v, dtype=torch.float32))
        want.step(paddle.to_tensor(np.float32(v)))
        assert abs(got() - want()) <= EXACT
        lrs.append(got())
    assert lrs[-1] < lrs[0]
    got.step()            # without a metric: nothing changes
    assert got() == lrs[-1]


def test_schedule_drives_an_optimizer():
    """An optimizer reads the schedule's value at each step, as in the
    reference; the schedule's state rides in the optimizer's state dict."""
    from paddle_tpu_torch.optimizer import Momentum

    ptt.set_device("cpu")
    try:
        p = torch.nn.Parameter(torch.zeros(3))
        sched = plr.StepDecay(0.1, step_size=2, gamma=0.5)
        opt = Momentum(sched, momentum=0.0, parameters=[p])
        seen = []
        for _ in range(5):
            p.grad = torch.ones(3)
            seen.append(opt.get_lr())
            opt.step()
            sched.step()
        assert seen == [0.1, 0.1, 0.05, 0.05, 0.025]
        np.testing.assert_allclose(p.detach().numpy(), np.full(3, -sum(seen)), rtol=1e-6)
        assert opt.state_dict()["LR_Scheduler"]["last_epoch"] == 5
    finally:
        ptt.set_device(None)
