"""The port's fleet hybrid parallelism (ROADMAP A6c) against the JAX
package, on the CPU.

The JAX side runs on conftest's 8 forced CPU devices; the port's fleet
builds single-controller meshes of repeated ``cpu`` members
(``fleet.init(..., devices=["cpu"] * n)``).  The inputs are numpy arrays
from a seed and the weights cross by ``convert.py``.  Cases:
- the strategy's knob audit (``tests/test_distributed.py``) and the
  fleet facade: ``fleet.init`` with all four degrees, the hybrid group's
  degrees and groups against the JAX group's, ``distributed_model`` (amp
  O2, recompute, a ``PipelineLayer``), ``distributed_optimizer`` (stage,
  master weights, gradient merge, ``asp``), the A7 refusals;
- ``DistributedTrainStep`` at stages 0-3 on the reference's small model
  (dp 2 x sharding 2 x model 2): 5 steps' losses and the final weights
  against the JAX step, and the spec bookkeeping against the JAX step's
  shardings; gradient merge; bucketed against unbucketed; optimizer state
  dicts in the parameters' layout; ``group_sharded_parallel``;
- ``ScannedLayers`` against the layers run in turn;
- ``LlamaForCausalLMHybrid`` on ``llama_tiny`` at pp2 x mp2 x dp2 and
  pp2 x sharding2 x sep2, stage 3: 2 steps' losses and the updated state
  dict against the JAX model (state-dict keys equal), and its refusals.

Tolerances: losses rtol 1e-4 (``tests/test_distributed.py``); weights
within 1e-4 relative L2 (f32).
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
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models.llama import LlamaDecoderLayer, _rope_tables
from paddle_tpu_torch.models.llama_parallel import (LlamaForCausalLMHybrid,
                                                    stack_llama_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

DEGREES = {"dp": "dp_degree", "mp": "mp_degree", "pp": "pp_degree",
           "sharding": "sharding_degree", "sep": "sep_degree"}


@pytest.fixture(autouse=True)
def _clear_groups():
    """Every fleet.init here sets a package's hybrid group: clear both
    after each test, so no later test routes through a stale mesh."""
    yield
    jtopo.set_hybrid_communicate_group(None)
    topology.set_hybrid_communicate_group(None)


def _strategy(package, **degrees):
    s = package.fleet.DistributedStrategy()
    s.hybrid_configs = {DEGREES[k]: v for k, v in degrees.items()}
    return s


def _hcgs(**degrees):
    """(JAX hybrid group, port hybrid group) over the same degrees."""
    n = int(np.prod(list(degrees.values())))
    jdist.fleet.init(is_collective=True, strategy=_strategy(jdist, **degrees))
    dist.fleet.init(is_collective=True, strategy=_strategy(dist, **degrees),
                    devices=["cpu"] * n)
    return jdist.get_hybrid_communicate_group(), dist.get_hybrid_communicate_group()


def _np(state):
    return {k: np.asarray(v.numpy()).copy() for k, v in state.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the strategy and the fleet facade


class TestStrategyKnobAudit:
    def test_knobs_and_keys_are_the_reference_s(self):
        mine, ref = dist.fleet.DistributedStrategy(), jdist.fleet.DistributedStrategy()
        assert list(mine.__dataclass_fields__) == list(ref.__dataclass_fields__)
        from paddle_tpu.distributed import fleet as jfleet

        assert dist.fleet._PROTO_UNHONORED == jfleet._PROTO_UNHONORED
        assert dist.fleet._CONFIG_KEYS == jfleet._CONFIG_KEYS

    def test_unknown_and_unhonored_knobs(self):
        s = dist.fleet.DistributedStrategy()
        with pytest.raises(ValueError, match="unknown DistributedStrategy"):
            s.not_a_real_knob = True
        for knob in ("dgc", "localsgd"):
            with pytest.raises(ValueError, match="does not honor"):
                setattr(s, knob, True)
        s.dgc = False
        with pytest.raises(ValueError):
            s.extra = {"whatever": 1}

    def test_config_typos_rejected_at_init(self):
        s = dist.fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degre": 8}
        with pytest.raises(ValueError, match="unknown key.*dp_degre"):
            dist.fleet.init(is_collective=True, strategy=s, devices=["cpu"])
        s = dist.fleet.DistributedStrategy()
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_step": 4}
        with pytest.raises(ValueError, match="k_step"):
            dist.fleet.init(is_collective=True, strategy=s, devices=["cpu"])

    def test_asp_waits_for_a9(self):
        """``strategy.asp`` (no longer refused) wraps the optimizer in
        ``incubate.asp.decorate``: pruned weights stay 2:4 through eager
        steps."""
        from paddle_tpu_torch.incubate import asp

        s = dist.fleet.DistributedStrategy()
        s.asp = True
        dist.fleet.init(is_collective=True, strategy=s, devices=["cpu"])
        model = torch.nn.Sequential(ptt.nn.Linear(8, 8, device="cpu"))
        asp.prune_model(model)
        opt = dist.fleet.distributed_optimizer(
            ptt.optimizer.SGD(0.1, parameters=model.parameters()))
        assert opt._asp_decorated
        for _ in range(2):
            model(torch.ones(2, 8)).sum().backward()
            opt.step()
            opt.clear_grad()
        assert asp.check_mask_1d(model[0].weight) and \
            asp.calculate_density(model[0].weight) == 0.5
        asp.ASPHelper.reset()

    def test_sharding_offload_knob_wires_through_and_is_refused(self, caplog):
        s = dist.fleet.DistributedStrategy()
        s.sharding = True
        s.sharding_configs = {"stage": 3, "offload": True}
        s.hybrid_configs = {"dp_degree": 2, "sharding_degree": 4}
        dist.fleet.init(is_collective=True, strategy=s, devices=["cpu"] * 8)
        model = ptt.nn.Linear(2, 2, device="cpu")
        opt = dist.fleet.distributed_optimizer(AdamW(0.1, parameters=model.parameters()))
        assert opt._sharding_offload is True and opt._sharding_stage == 3
        # the CPU members cannot pin host memory: the reference's warning,
        # and the states stay where they are (tests/test_torch_offload.py)
        with caplog.at_level(logging.WARNING, "paddle_tpu.distributed"):
            step = dist.DistributedTrainStep(model, lambda m, a: m(a).sum(), opt,
                                             dist.get_hybrid_communicate_group())
        assert step.offload is False and step.sharding_stage == 3
        assert any("offload=True requested" in r.message for r in caplog.records)


class TestFleet:
    @pytest.mark.parametrize("degrees", [dict(dp=2, mp=2, pp=2), dict(pp=2, sharding=2, sep=2),
                                         dict(dp=1, mp=2, pp=2, sharding=2)],
                             ids=["dp2_mp2_pp2", "pp2_sh2_sep2", "mp2_pp2_sh2"])
    def test_hybrid_group_against_reference(self, degrees):
        jhcg, hcg = _hcgs(**degrees)
        assert dict(hcg.mesh.shape) == dict(jhcg.mesh.shape)
        for axis in ("data", "model", "pipe", "sharding", "sep"):
            assert getattr(hcg, f"get_{axis}_parallel_world_size")() == \
                getattr(jhcg, f"get_{axis}_parallel_world_size")()
            tg, jg = getattr(hcg, f"get_{axis}_parallel_group")(), \
                getattr(jhcg, f"get_{axis}_parallel_group")()
            assert (tg.axes, tg.nranks, tg.rank) == (jg.axes, jg.nranks, jg.rank)
        assert hcg.get_stage_id() == jhcg.get_stage_id() == 0
        assert hcg.get_sharding_parallel_rank() == jhcg.get_sharding_parallel_rank() == 0
        assert hcg.nranks == jhcg.nranks == 8
        assert dist.fleet.worker_index() == 0 and dist.fleet.worker_num() == 1

    def test_all_four_degrees(self):
        dist.fleet.init(is_collective=True,
                        strategy=_strategy(dist, dp=2, mp=2, pp=2, sharding=2),
                        devices=["cpu"] * 16)
        hcg = dist.get_hybrid_communicate_group()
        assert dict(hcg.mesh.shape) == {"data": 2, "pipe": 2, "sharding": 2, "sep": 1,
                                        "model": 2}
        assert hcg.get_check_parallel_group().nranks == 8
        mesh = topology.build_mesh(pp=2, sharding=2, mp=2, devices=["cpu"] * 8)
        assert mesh.axis_devices("pipe") == [torch.device("cpu")] * 2

    def test_distributed_model_and_optimizer(self):
        s = dist.fleet.DistributedStrategy()
        s.amp, s.amp_configs = True, {"level": "O2", "dtype": "bfloat16"}
        s.recompute = True
        s.sharding, s.sharding_configs = True, {"stage": 2}
        s.gradient_merge, s.gradient_merge_configs = True, {"k_steps": 2, "avg": False}
        dist.fleet.init(is_collective=True, strategy=s, devices=["cpu"])
        model = dist.fleet.distributed_model(LlamaForCausalLM(llama_tiny(), device="cpu"))
        assert model.config.recompute and next(iter(model.parameters())).dtype == torch.bfloat16
        opt = dist.fleet.distributed_optimizer(AdamW(1e-3, parameters=model.parameters()))
        assert (opt._sharding_stage, opt._multi_precision, opt._gradient_merge_k,
                opt._gradient_merge_avg) == (2, True, 2, False)
        step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt)
        assert (step._merge_k, step._merge_avg) == (2, False)
        pl = dist.meta_parallel.PipelineLayer([torch.nn.Linear(4, 4)] * 2, num_stages=1)
        assert isinstance(dist.fleet.distributed_model(pl), dist.meta_parallel.PipelineParallel)

    def test_fault_domain_waits_for_a7(self):
        """The fault domain and the gang (ROADMAP A7b, ported) are reachable
        where the reference has them, one class at every path."""
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.distributed.fleet import elastic, fault_domain

        assert fleet.fault_domain is fault_domain
        assert fleet.elastic.FleetSupervisor is dist.FleetSupervisor is elastic.FleetSupervisor
        for name in ("FaultDomain", "HeartbeatLease", "LeaseMonitor"):
            assert getattr(dist, name) is getattr(fleet, name) is getattr(fault_domain, name)
        assert elastic.HeartbeatLease is fault_domain.HeartbeatLease


# ---------------------------------------------------------------------------
# DistributedTrainStep on the reference's small model


def _small_models(seed=7):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.Tanh(), jnn.Linear(32, 16))
    tm = torch.nn.Sequential(ptt.nn.Linear(16, 32, device="cpu"), torch.nn.Tanh(),
                             ptt.nn.Linear(32, 16, device="cpu"))
    load_numpy_state_dict(tm, _np(jm.state_dict()))
    return jm, tm


def _data(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, 16)).astype(np.float32)
    return x, (x * 0.5).astype(np.float32)


def _run_small(stage, steps=5, merge=None, bucket_mb=None, monkeypatch=None):
    jhcg, hcg = _hcgs(dp=2, sharding=2, mp=2)
    if bucket_mb is not None:
        monkeypatch.setenv("PADDLE_TPU_BUCKET_MB", bucket_mb)
    jm, tm = _small_models()
    jopt = paddle.optimizer.AdamW(1e-2, parameters=jm.parameters(),
                                  grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    opt = AdamW(1e-2, parameters=tm.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    jstep = jdist.DistributedTrainStep(jm, lambda m, a, b: JF.mse_loss(m(a), b), jopt, jhcg,
                                       sharding_stage=stage, gradient_merge=merge)
    step = dist.DistributedTrainStep(tm, lambda m, a, b: torch.nn.functional.mse_loss(m(a), b),
                                     opt, hcg, sharding_stage=stage, gradient_merge=merge)
    x, y = _data()
    want = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))) for _ in range(steps)]
    got = [float(step(x, y)) for _ in range(steps)]
    return (jm, jopt, jstep), (tm, opt, step), got, want


def _spec(sharding):
    return None if sharding is None else tuple(sharding.spec) + (None,) * 0


class TestDistributedTrainStep:
    @pytest.mark.parametrize("stage", [0, 1, 2, 3])
    def test_against_reference(self, stage):
        (jm, jopt, jstep), (tm, opt, step), got, want = _run_small(stage)
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert got[-1] < got[0]
        for name, w in _np(jm.state_dict()).items():
            assert _rel_l2(tm.state_dict()[name].numpy(), w) <= 1e-4, name
        # the spec bookkeeping, entry for entry the reference's shardings
        jparams = [p for p in jm.parameters()]
        for i, (jp, tp) in enumerate(zip(jparams, tm.parameters())):
            jspec = tuple(jstep._param_shardings[i].spec)
            assert step._param_shardings[i] == jspec + (None,) * (tp.dim() - len(jspec))
            assert tp._storage_spec == step._param_shardings[i]
            js = jstep._state_shardings[i]["moment1"].spec
            assert step._state_shardings[i]["moment1"] == \
                tuple(js) + (None,) * (tp.dim() - len(js))
        w = tm[0].weight
        assert ("sharding" in str(step._param_shardings[0])) == (stage >= 3)
        assert ("sharding" in str(step._state_shardings[0]["moment1"])) == (stage >= 1)
        assert (id(w) in opt._layouts) == (stage >= 1)
        # the state dict shows the held blocks in the parameter's layout
        sd = opt.state_dict()
        jsd = jopt.state_dict()
        for key in ("moment1", "moment2", "master_weight"):
            name = next((k for k in sd if k.endswith(key)), None)
            if name is not None:
                assert tuple(sd[name].shape) == tuple(w.shape) or sd[name].dim() < 2

    def test_gradient_merge(self):
        _, _, got, want = _run_small(2, steps=3, merge=2)
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_bucketed_step_matches_unbucketed(self, monkeypatch):
        _, (_, _, step_b), got_b, _ = _run_small(2, steps=2, bucket_mb="0.0001",
                                                 monkeypatch=monkeypatch)
        assert step_b._grad_bucketer.num_buckets > 1 and step_b._grad_bucketer.routed == 2
        _, (_, _, step_n), got_n, _ = _run_small(2, steps=2, bucket_mb="0",
                                                 monkeypatch=monkeypatch)
        assert step_n._grad_bucketer is None
        assert got_b == got_n

    def test_state_dict_round_trip(self):
        _, (tm, opt, step), _, _ = _run_small(1, steps=2)
        sd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in opt.state_dict().items()}
        for p in tm.parameters():
            st = opt._accumulators[id(p)]
            assert tuple(opt._global(p, st["moment1"]).shape) == tuple(p.shape)
        opt.set_state_dict(sd)
        for k, v in opt.state_dict().items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, sd[k]), k

    def test_group_sharded_parallel_sets_the_stage(self):
        dist.fleet.init(is_collective=True, strategy=_strategy(dist, sharding=2),
                        devices=["cpu"] * 2)
        _, tm = _small_models()
        opt = AdamW(1e-2, parameters=tm.parameters())
        tm, opt, scaler = dist.group_sharded_parallel(tm, opt, "os_g", buffer_max_size=4096)
        assert scaler is None and opt._sharding_stage == tm._sharding_stage == 2
        step = dist.DistributedTrainStep(tm, lambda m, a, b: torch.nn.functional.mse_loss(
            m(a), b), opt, dist.get_hybrid_communicate_group().mesh)
        assert step.sharding_stage == 2 and step._grad_bucketer.bucket_bytes == 4096
        with pytest.raises(ValueError, match="level"):
            dist.group_sharded_parallel(tm, opt, "zero9")
        tm, opt, _ = dist.group_sharded_parallel(tm, opt, "os", offload=True)
        assert opt._sharding_offload is True and opt._sharding_stage == 1


# ---------------------------------------------------------------------------
# ScannedLayers


def test_scanned_layers_against_sequential():
    cfg = llama_tiny(num_hidden_layers=3)
    g = torch.Generator().manual_seed(3)
    blocks = [LlamaDecoderLayer(cfg, std=0.02, device="cpu", dtype=torch.float32, generator=g)
              for _ in range(3)]
    stack = dist.ScannedLayers(blocks, mesh=topology.build_mesh(pp=1, devices=["cpu"]))
    cos, sin = _rope_tables(cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8, cfg.hidden_size)).astype(np.float32))
    ref = x
    for b in blocks:
        ref = b(ref, cos, sin)
    torch.testing.assert_close(stack(x, cos, sin), ref, rtol=2e-5, atol=1e-6)
    assert len(stack) == 3 and not any(p.requires_grad for p in stack._template.parameters())
    assert tuple(stack.self_attn__q_proj__weight.shape) == (3, cfg.hidden_size, cfg.hidden_size)
    with pytest.raises(ValueError, match="homogeneous"):
        dist.ScannedLayers([torch.nn.Linear(4, 4), torch.nn.LayerNorm(4)])


# ---------------------------------------------------------------------------
# the hybrid Llama


HYBRID = {"dp2_mp2_pp2": dict(dp=2, mp=2, pp=2), "pp2_sh2_sep2": dict(pp=2, sharding=2, sep=2)}


@pytest.mark.parametrize("layout", list(HYBRID))
def test_hybrid_llama_against_reference(layout):
    jhcg, hcg = _hcgs(**HYBRID[layout])
    from paddle_tpu.models.llama import llama_tiny as jllama_tiny
    from paddle_tpu.models.llama_parallel import LlamaForCausalLMHybrid as JHybrid

    kw = dict(num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2)
    paddle.seed(0)
    jm = JHybrid(jllama_tiny(**kw), jhcg)
    tm = LlamaForCausalLMHybrid(llama_tiny(**kw), hcg)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert (tm.sequence_parallel, tm.context_parallel) == (jm.sequence_parallel,
                                                           jm.context_parallel)
    load_numpy_state_dict(tm, _np(jm.state_dict()))
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters(),
                                  grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    opt = AdamW(1e-3, parameters=tm.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    jstep = jdist.DistributedTrainStep(jm, lambda m, x, y: m(x, labels=y)[0], jopt, jhcg,
                                       sharding_stage=3)
    step = dist.DistributedTrainStep(tm, lambda m, x, y: m(x, labels=y)[0], opt, hcg,
                                     sharding_stage=3)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (4, 32)).astype(np.int32)
    labels = rng.integers(0, 256, (4, 32)).astype(np.int32)
    want = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))) for _ in range(2)]
    got = [float(step(ids, labels)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[1] < got[0]
    state = tm.state_dict()
    for name, w in _np(jm.state_dict()).items():
        assert _rel_l2(state[name].numpy(), w) <= 1e-4, name
    jspecs = dict(zip(jstep._param_names, jstep._param_shardings))
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    for name, p, spec in zip(names, step._params, step._param_shardings):
        jspec = tuple(jspecs[name].spec)
        assert spec == jspec + (None,) * (p.dim() - len(jspec)), name
    specs = " ".join(map(str, step._param_shardings))
    assert "pipe" in specs and "model" in specs     # "model" named at mp 1 too, as there
    assert ("sharding" in specs) == ("sharding" in HYBRID[layout])


def test_hybrid_llama_matches_the_plain_model():
    """Carried a plain ``LlamaForCausalLM``'s weights by
    ``stack_llama_state_dict``, the hybrid model at dp 2 x mp 2 x pp 2
    trains as the plain ``TrainStep`` does, stage 1 to 3."""
    cfg = llama_tiny(num_hidden_layers=4)
    plain = LlamaForCausalLM(cfg, device="cpu", seed=3)
    weights = _np(plain.state_dict())
    rng = np.random.default_rng(1)
    ids, labels = (rng.integers(0, 256, (4, 16)) for _ in range(2))
    opt = AdamW(1e-3, parameters=plain.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(plain, lambda m, x, y: m(x, labels=y)[0], opt)
    want = [float(step(ids, labels)) for _ in range(3)]
    for stage in (1, 2, 3):
        dist.fleet.init(is_collective=True, strategy=_strategy(dist, sharding=2, mp=2, pp=2),
                        devices=["cpu"] * 8)
        hcg = dist.get_hybrid_communicate_group()
        model = LlamaForCausalLMHybrid(cfg, hcg)
        load_numpy_state_dict(model, stack_llama_state_dict(weights))
        o = AdamW(1e-3, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
        s = dist.DistributedTrainStep(model, lambda m, x, y: m(x, labels=y)[0], o, hcg,
                                      sharding_stage=stage)
        got = [float(s(ids, labels)) for _ in range(3)]
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_hybrid_llama_refusals_and_context_parallel():
    _, hcg = _hcgs(sep=2, dp=4)
    with pytest.raises(ValueError, match="must be"):
        LlamaForCausalLMHybrid(llama_tiny(), hcg, context_parallel="Ring")
    with pytest.raises(ValueError, match="fused_ce_chunk"):
        LlamaForCausalLMHybrid(llama_tiny(fused_ce_chunk=4), hcg)
    assert LlamaForCausalLMHybrid(llama_tiny(), hcg).context_parallel == "ring"
    _, hcg4 = _hcgs(sep=4, dp=2)
    with pytest.raises(ValueError, match="kv heads"):
        LlamaForCausalLMHybrid(llama_tiny(num_attention_heads=8, num_key_value_heads=2), hcg4,
                               context_parallel="ulysses")
    cfg = llama_tiny(num_key_value_heads=4)
    ring = LlamaForCausalLMHybrid(cfg, hcg4, context_parallel="ring")
    dense = LlamaForCausalLMHybrid(cfg, hcg4, context_parallel="none")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32)))
    torch.testing.assert_close(ring(ids), dense(ids), rtol=1e-4, atol=1e-5)
    _, hcg_pp = _hcgs(pp=2, dp=4)
    with pytest.raises(ValueError, match="% pp"):
        LlamaForCausalLMHybrid(llama_tiny(num_hidden_layers=3), hcg_pp)
