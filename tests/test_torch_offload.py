"""ZeRO offload in the port (``DistributedTrainStep(offload=True)``, the
``group_sharded_parallel`` and ``fleet`` tags, ``device.HostArena``, the
optimizer's per-tensor gradient casts) against the JAX package, on the CPU.

On the CPU the members cannot pin host memory, so an offload request
degrades as the reference's does on its CPU backend (a warning on the
``paddle_tpu.distributed`` logger, ``offload is False``, the step trains:
``tests/test_gradient_merge.py``).  With the support probe forced on (as
the reference's own test forces it), the port's real placement runs: the
masters and moments move into one ``HostArena`` (unpinned here), and the
update reads them from there.  On the card the same arena is pinned and B5
updates it across the host link (``chip_smoke.py``).

Tolerances: the offloaded step against the resident one, bit-equal (the
same operations on the same values; only where the states live differs);
against the JAX step (f32, 8 CPU members, AdamW(1e-2) with a global-norm
clip, 4 steps), losses within 1e-6 and weights within 1e-5 of the largest
weight: XLA's and torch's CPU matmuls round apart by an f32 epsilon or so,
and Adam's m / sqrt(v) carries that into the update (7.5e-6 measured on a
bias).
"""

import logging

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import topology as jtopo

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.device import HostArena
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.distributed.engine import DistributedTrainStep
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

LOSS_TOL, WEIGHT_TOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _clear_groups():
    yield
    jtopo.set_hybrid_communicate_group(None)
    topology.set_hybrid_communicate_group(None)


@pytest.fixture
def forced(monkeypatch):
    """The support probe forced on, as the reference's test forces it."""
    monkeypatch.setattr(DistributedTrainStep, "_offload_supported", lambda self: True)


def _strategy(package, degree=4, dp=2, **extra):
    s = package.fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": degree}
    for k, v in extra.items():
        setattr(s, k, v)
    return s


def _hcgs(**kw):
    jdist.fleet.init(is_collective=True, strategy=_strategy(jdist, **kw))
    dist.fleet.init(is_collective=True, strategy=_strategy(dist, **kw), devices=["cpu"] * 8)
    return jdist.get_hybrid_communicate_group(), dist.get_hybrid_communicate_group()


def _models(seed=7):
    """The reference test's MLP (16 -> 32 -> 8), the port's with its weights."""
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.Tanh(), jnn.Linear(32, 8))
    tm = torch.nn.Sequential(ptt.nn.Linear(16, 32, device="cpu"), torch.nn.Tanh(),
                             ptt.nn.Linear(32, 8, device="cpu"))
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _batches(n=4, seed=9):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((16, 16)).astype(np.float32),
             rng.standard_normal((16, 8)).astype(np.float32)) for _ in range(n)]


def _mse(m, a, b):
    return torch.nn.functional.mse_loss(m(a).float(), b)


def _port_run(hcg, stage, offload, batches, amp=False, flags=None):
    _, tm = _models()
    opt = AdamW(1e-2, parameters=tm.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    if amp:
        tm, opt = ptt.amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    step = dist.DistributedTrainStep(tm, _mse, opt, hcg, sharding_stage=stage,
                                     offload=offload)
    with ptt.flag_guard(**(flags or {})):
        losses = [float(step(x, y)) for x, y in batches]
    return tm, opt, step, losses


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


class TestCpuRequest:
    def test_degrades_with_the_warning_and_trains(self, caplog):
        """The reference's CPU behaviour (test_gradient_merge.py:134-152):
        group_sharded_parallel(offload=True) tags the optimizer, the step
        warns, keeps stage 3 with resident states, and trains as the JAX
        step does."""
        jhcg, hcg = _hcgs()
        jm, tm = _models()
        jopt = paddle.optimizer.AdamW(1e-2, parameters=jm.parameters())
        jm, jopt, _ = jdist.group_sharded_parallel(jm, jopt, "p_g_os", offload=True)
        opt = AdamW(1e-2, parameters=tm.parameters())
        tm, opt, _ = dist.group_sharded_parallel(tm, opt, "p_g_os", offload=True)
        assert opt._sharding_offload is True
        with caplog.at_level(logging.WARNING, "paddle_tpu.distributed"):
            step = dist.DistributedTrainStep(tm, _mse, opt, hcg)
        jstep = jdist.DistributedTrainStep(jm, lambda m, a, b: JF.mse_loss(m(a), b), jopt, jhcg)
        assert step.sharding_stage == 3 and step.offload is False
        assert step.state_memory_kind == "device"
        assert any("offload=True requested" in r.message for r in caplog.records)
        got = [float(step(x, y)) for x, y in _batches()]
        want = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
                for x, y in _batches()]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got[-1] < got[0]
        assert opt._host_arena is None


class TestForcedRoute:
    @pytest.mark.parametrize("stage", [0, 1, 2, 3])
    def test_states_in_the_arena_bit_equal_to_resident(self, forced, stage):
        """Masters and moments in the host arena at every stage; losses and
        weights bit-equal to resident states and near the JAX
        step (which keeps its states on its CPU devices)."""
        jhcg, hcg = _hcgs()
        batches = _batches()
        tm_r, opt_r, _, res = _port_run(hcg, stage, False, batches)
        tm_o, opt_o, step, off = _port_run(hcg, stage, True, batches)
        assert step.offload is True and step.state_memory_kind == "pinned_host"
        arena = opt_o._host_arena
        assert isinstance(arena, HostArena) and not arena.pinned   # no card to pin for
        base = arena._buf.data_ptr()
        for p in tm_o.parameters():
            for slot in ("moment1", "moment2"):
                t = opt_o._accumulators[id(p)][slot]
                assert base <= t.data_ptr() < base + arena.nbytes
                assert (id(p) in opt_o._layouts) == (stage >= 1)
        assert opt_r._host_arena is None
        assert off == res
        for (name, a), b in zip(tm_o.state_dict().items(), tm_r.state_dict().values()):
            assert torch.equal(a, b), name
        jm, _ = _models()
        jopt = paddle.optimizer.AdamW(1e-2, parameters=jm.parameters(),
                                      grad_clip=jnn.ClipGradByGlobalNorm(1.0))
        jstep = jdist.DistributedTrainStep(jm, lambda m, a, b: JF.mse_loss(m(a), b), jopt,
                                           jhcg, sharding_stage=stage)
        want = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
                for x, y in batches]
        assert _rel(off, want) <= LOSS_TOL
        for name, w in jm.state_dict().items():
            assert _rel(tm_o.state_dict()[name].numpy(), w.numpy()) <= WEIGHT_TOL, name

    @pytest.mark.parametrize("stage", [1, 2, 3])
    @pytest.mark.parametrize("fused", [True, False])
    def test_amp_masters_bit_equal_to_resident(self, forced, stage, fused):
        """AMP O2: bf16 parameters, their f32 masters in the arena; B5's
        plain twin (fused) or the reference's rule (not fused) on the host
        states, bit-equal to resident ones; the masters' state dict too."""
        _, hcg = _hcgs()
        batches = _batches(3)
        flags = dict(use_fused_adamw=fused)
        tm_r, opt_r, _, res = _port_run(hcg, stage, False, batches, amp=True, flags=flags)
        tm_o, opt_o, _, off = _port_run(hcg, stage, True, batches, amp=True, flags=flags)
        assert off == res
        assert next(iter(tm_o.parameters())).dtype == torch.bfloat16
        for (name, a), b in zip(tm_o.state_dict().items(), tm_r.state_dict().values()):
            assert torch.equal(a, b), name
        sd_o, sd_r = opt_o.state_dict(), opt_r.state_dict()
        assert sd_o.keys() == sd_r.keys()
        assert any(k.endswith("master_weight") for k in sd_o)
        for k, v in sd_o.items():
            assert (torch.equal(v, sd_r[k]) if isinstance(v, torch.Tensor)
                    else v == sd_r[k]), k

    def test_group_sharded_and_fleet_tags_flow_into_the_step(self, forced):
        _, hcg = _hcgs()
        _, tm = _models()
        opt = AdamW(1e-2, parameters=tm.parameters())
        tm, opt, _ = dist.group_sharded_parallel(tm, opt, "os_g", offload=True)
        step = dist.DistributedTrainStep(tm, _mse, opt, hcg)
        assert (step.sharding_stage, step.offload) == (2, True)
        topology.set_hybrid_communicate_group(None)
        s = _strategy(dist, degree=8, dp=1, sharding=True,
                      sharding_configs={"stage": 1, "offload": True})
        dist.fleet.init(is_collective=True, strategy=s, devices=["cpu"] * 8)
        _, tm = _models()
        opt = dist.fleet.distributed_optimizer(AdamW(1e-2, parameters=tm.parameters()))
        step = dist.DistributedTrainStep(tm, _mse, opt, dist.get_hybrid_communicate_group())
        assert (step.sharding_stage, step.offload) == (1, True)
        assert opt._host_arena is not None
        x, y = _batches(1)[0]
        assert np.isfinite(float(step(x, y)))

    def test_state_dict_round_trip_writes_into_the_arena(self, forced):
        """set_state_dict copies into the held host tensors (the arena keeps
        its block), and the state dict shows each parameter's layout."""
        _, hcg = _hcgs()
        tm, opt, _, _ = _port_run(hcg, 1, True, _batches(2), amp=True)
        sd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in opt.state_dict().items()}
        for p in tm.parameters():
            assert sd[f"{opt._names[id(p)]}.moment1"].shape == p.shape
        ptrs = {k: [t.data_ptr() for t in (*opt._accumulators[id(p)].values(),)
                    if isinstance(t, torch.Tensor)] for k, p in enumerate(tm.parameters())}
        masters = [opt._master_weights[id(p)].data_ptr() for p in tm.parameters()]
        zeroed = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else v)
                  for k, v in sd.items()}
        opt.set_state_dict(zeroed)
        assert all(float(v.abs().sum()) == 0 for v in opt.state_dict().values()
                   if isinstance(v, torch.Tensor))
        opt.set_state_dict(sd)
        for k, p in enumerate(tm.parameters()):
            assert [t.data_ptr() for t in opt._accumulators[id(p)].values()
                    if isinstance(t, torch.Tensor)] == ptrs[k]
            assert opt._master_weights[id(p)].data_ptr() == masters[k]
        for k, v in opt.state_dict().items():
            assert torch.equal(v, sd[k]) if isinstance(v, torch.Tensor) else v == sd[k], k


class TestHostArena:
    def test_takes_aligned_views_of_one_block(self):
        shapes = [(3, 5), (7,), (2, 2, 2)]
        arena = HostArena(HostArena.span(shapes, torch.float32), pin=False)
        ts = [arena.take(s, torch.float32) for s in shapes]
        base = arena._buf.data_ptr()
        assert [t.shape for t in ts] == [torch.Size(s) for s in shapes]
        assert all((t.data_ptr() - base) % HostArena.ALIGN == 0 for t in ts)
        assert HostArena.span(shapes, torch.float32) == 3 * HostArena.ALIGN
        for i, t in enumerate(ts):
            t.fill_(i)
        assert [float(t.mean()) for t in ts] == [0.0, 1.0, 2.0]
        with pytest.raises(RuntimeError, match="overrun"):
            arena.take((1,), torch.float32)
        arena.release()     # nothing pinned: a no-op


class TestPerTensorCasts:
    @pytest.mark.parametrize("fused", [True, False])
    def test_update_bit_equal_to_casting_every_gradient_first(self, fused):
        """The optimizer casts each gradient when its turn comes; the clip
        and update equal the old order (every gradient cast, then the clip
        over the list, then the updates) bit for bit."""
        torch.manual_seed(0)

        def run(eager):
            torch.manual_seed(0)
            m = torch.nn.Sequential(ptt.nn.Linear(8, 16, device="cpu"), torch.nn.Tanh(),
                                    ptt.nn.Linear(16, 4, device="cpu"))
            opt = AdamW(1e-2, parameters=m.parameters(), grad_clip=ClipGradByGlobalNorm(0.1))
            m, opt = ptt.amp.decorate(m, opt, level="O2", dtype="bfloat16")
            if eager:
                @torch.no_grad()
                def apply(params_grads):
                    pg = [(p, g.to(opt._master(p).dtype)) for p, g in params_grads]
                    pg = opt._grad_clip(pg)
                    lr = opt.get_lr()
                    for p, g in pg:
                        opt._update_param(p, g, lr)
                    opt._step_count += 1
                opt._apply = apply
            step = TrainStep(m, lambda mm, a, b: _mse(mm, a, b), opt)
            g = torch.Generator().manual_seed(3)
            with ptt.flag_guard(use_fused_adamw=fused):
                losses = [float(step(torch.randn(16, 8, generator=g),
                                     torch.randn(16, 4, generator=g))) for _ in range(4)]
            return losses, m.state_dict(), opt.state_dict()

        (la, ma, oa), (lb, mb, ob) = run(False), run(True)
        assert la == lb
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
        for k in oa:
            assert torch.equal(oa[k], ob[k]) if isinstance(oa[k], torch.Tensor) \
                else oa[k] == ob[k], k

    def test_global_scale_reads_a_generator_once(self):
        clip = ClipGradByGlobalNorm(1.0)
        ps = [torch.nn.Parameter(torch.ones(3)) for _ in range(3)]
        ps[1].need_clip = False
        gs = [torch.full((3,), 2.0), torch.full((3,), 5.0), torch.full((3,), -2.0)]
        seen = []

        def pairs():
            for p, g in zip(ps, gs):
                seen.append(g)
                yield p, g

        scale = clip.global_scale(pairs())
        assert len(seen) == 3
        want = clip(list(zip(ps, gs)))
        got = [(p, clip.scaled(p, g, scale)) for p, g in zip(ps, gs)]
        for (_, a), (_, b) in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(got[1][1], gs[1])
        assert clip.global_scale([(ps[1], gs[1])]) is None
