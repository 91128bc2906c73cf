"""The port's ``distributed.auto_parallel`` (placements, ``ProcessMesh``,
``shard_tensor`` / ``reshard``, ``to_partition_spec``, ``shard_layer``,
``shard_optimizer``) and its ``Engine`` against the JAX package, on the CPU.

The JAX side runs on conftest's 8 forced CPU devices; the port's meshes
are single-controller meshes of repeated ``cpu`` members (``fleet.init(...,
devices=["cpu"] * n)``, ``ProcessMesh(..., devices=...)``).  Inputs are
numpy arrays from a seed; weights cross by ``convert.py``.  Cases:
- every placement case of ``tests/test_dist_semantics.py``
  (``TestPartialPlacement``): Partial sum/avg round trips, Partial to
  Shard, the unsupported reduce type, sum <-> avg, value-equal to the JAX
  package's, with the same pending axes;
- ``to_partition_spec`` against the reference's ``PartitionSpec`` entries;
  ``ProcessMesh``'s bookkeeping and its refusal of a mesh larger than the
  devices; the ``devices=`` departure;
- a ``shard_layer``-ed ``llama_tiny`` (q/k/v/gate/up ``Shard(1)``, o/down
  ``Shard(0)`` over ``model``, mp_layers' layout) trained by
  ``DistributedTrainStep`` at dp 2 x mp 2 x sharding 2 against the JAX step: the
  specs entry for entry, losses and weights;
- ``Engine.fit`` / ``evaluate`` / ``predict`` against the JAX ``Engine``
  on a plain list of Llama batches and on a ``Dataset`` through
  ``DistributedBatchSampler`` (its epoch-seeded shuffle: the same index
  stream in both packages); ``prepare``'s errors; ``save`` / ``load``
  naming ROADMAP A7.

Tolerances: placement values exact; losses rtol 1e-4 and weights within
1e-4 relative L2 (f32), as ``tests/test_torch_hybrid.py``; eval losses,
metrics and predictions rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.auto_parallel as jap
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import topology as jtopo

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.distributed.auto_parallel as ap
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

KW = dict(num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4)


@pytest.fixture(autouse=True)
def _clear_groups():
    yield
    jtopo.set_hybrid_communicate_group(None)
    topology.set_hybrid_communicate_group(None)
    ptt.set_device(None)


def _hcgs(**degrees):
    names = {"dp": "dp_degree", "mp": "mp_degree", "pp": "pp_degree",
             "sharding": "sharding_degree", "sep": "sep_degree"}
    n = int(np.prod(list(degrees.values())))
    out = []
    for package, kw in ((jdist, {}), (dist, {"devices": ["cpu"] * n})):
        s = package.fleet.DistributedStrategy()
        s.hybrid_configs = {names[k]: v for k, v in degrees.items()}
        package.fleet.init(is_collective=True, strategy=s, **kw)
        out.append(package.get_hybrid_communicate_group())
    return out


def _np(state):
    return {k: np.asarray(v.numpy()).copy() for k, v in state.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# placements


def _both_meshes():
    jhcg, hcg = _hcgs(dp=2, mp=2, sharding=2)
    return jap.ProcessMesh(jhcg.mesh), ap.ProcessMesh(hcg.mesh)


def _pl(mod, *names):
    """Placements of ``mod`` from short names: r, s<d>, sum, avg, max."""
    out = []
    for n in names:
        if n == "r":
            out.append(mod.Replicate())
        elif n.startswith("s"):
            out.append(mod.Shard(int(n[1:])) if n[1:].isdigit() else mod.Partial(n))
        else:
            out.append(mod.Partial(n))
    return out


R5 = ("r",) * 5
CASES = {  # (data, first placements, then reshard to, the value after)
    "partial_sum_roundtrip": (np.arange(8, dtype=np.float32).reshape(2, 4),
                              ("sum", "r", "r", "r", "r"), R5),
    "partial_avg_divides": (np.full((4, 4), 8.0, np.float32),
                            ("avg", "r", "r", "r", "r"), R5),
    "partial_to_shard": (np.arange(16, dtype=np.float32).reshape(4, 4),
                         ("sum", "r", "r", "r", "r"), ("r", "r", "s0", "r", "r")),
    "sum_to_avg": (np.full((4,), 8.0, np.float32), ("sum", "r", "r", "r", "r"),
                   ("avg", "r", "r", "r", "r")),
    "avg_resolved_through_ops": (np.full((4,), 8.0, np.float32),
                                 ("avg", "r", "r", "r", "r"), R5),
}


def _value(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") and not isinstance(t, torch.Tensor)
                      else t.detach().numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_placements_value_equal_to_reference(case):
    jpm, pm = _both_meshes()
    x, first, then = CASES[case]
    jt = jap.shard_tensor(x, jpm, _pl(jap, *first))
    t = ap.shard_tensor(x, pm, _pl(ap, *first))
    assert t._dist_attr.partial_axes == jt._partial_axes
    np.testing.assert_array_equal(_value(t), _value(jt))
    jr = jap.reshard(jt, jpm, _pl(jap, *then))
    r = ap.reshard(t, pm, _pl(ap, *then))
    assert r._dist_attr.partial_axes == jr._partial_axes
    np.testing.assert_array_equal(_value(r), _value(jr))
    assert r._dist_attr.spec == tuple(jr._value.sharding.spec) + \
        (None,) * (r.dim() - len(jr._value.sharding.spec))
    # resolve whatever is still pending: the value is the reference's too
    jf, f = jap.reshard(jr, jpm, _pl(jap, *R5)), ap.reshard(r, pm, _pl(ap, *R5))
    np.testing.assert_array_equal(_value(f), _value(jf))
    if case == "avg_resolved_through_ops":    # an op drops the tag: same value
        np.testing.assert_array_equal(_value(t * 1.0), _value(f * 1.0))


def test_sum_avg_sum_round_trip_and_the_unsupported_reduce_type():
    jpm, pm = _both_meshes()
    x = np.full((4,), 8.0, np.float32)
    for mod, mesh, out in ((jap, jpm, []), (ap, pm, [])):
        t = mod.shard_tensor(x, mesh, _pl(mod, "sum", "r", "r", "r", "r"))
        t2 = mod.reshard(t, mesh, _pl(mod, "avg", "r", "r", "r", "r"))
        back = mod.reshard(mod.reshard(t2, mesh, _pl(mod, "sum", "r", "r", "r", "r")),
                           mesh, _pl(mod, *R5))
        np.testing.assert_array_equal(_value(back), x)
        for api in (lambda pl: mod.shard_tensor(np.ones(4, np.float32), mesh, pl),
                    lambda pl: mod.reshard(mod.shard_tensor(np.ones(4, np.float32), mesh,
                                                            _pl(mod, *R5)), mesh, pl)):
            with pytest.raises(NotImplementedError, match="max"):
                api(_pl(mod, "max", "r", "r", "r", "r"))


SPEC_CASES = [(("s0", "r"), 2), (("r", "s1"), 2), (("s0", "s0"), 3), (("s1", "s0"), 2),
              (("r", "r"), 2), (("s2", "r"), None), (("sum", "s0"), 2)]


@pytest.mark.parametrize("names,ndim", SPEC_CASES)
def test_to_partition_spec_against_reference(names, ndim):
    import jax
    from jax.sharding import Mesh

    jpm = jap.ProcessMesh(Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y")))
    pm = ap.ProcessMesh(np.arange(4).reshape(2, 2), ["x", "y"], devices=["cpu"] * 4)
    want = jap.to_partition_spec(_pl(jap, *names), jpm, ndim=ndim)
    assert ap.to_partition_spec(_pl(ap, *names), pm, ndim=ndim) == tuple(want)


def test_process_mesh_bookkeeping_and_the_devices_departure():
    jpm = jap.ProcessMesh(shape=[2, 4], dim_names=["dp", "mp"])
    pm = ap.ProcessMesh(shape=[2, 4], dim_names=["dp", "mp"], devices=["cpu"] * 8)
    for attr in ("shape", "dim_names", "process_ids"):
        assert getattr(pm, attr) == getattr(jpm, attr), attr
    assert pm.get_dim_size("mp") == jpm.get_dim_size("mp") == 4
    assert pm == ap.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"], devices=["cpu"] * 8)
    assert repr(pm) == repr(jpm)
    assert pm.mesh.shape == {"dp": 2, "mp": 4} and pm.device == torch.device("cpu")
    # more members than devices raises, as the reference's does
    with pytest.raises(ValueError, match="devices"):
        jap.ProcessMesh(shape=[4, 4])
    ptt.set_device("cpu")
    with pytest.raises(ValueError, match="mesh needs 2 devices; 1 visible"):
        ap.ProcessMesh(shape=[2])
    ap.set_mesh(pm)
    assert ap.get_mesh() is pm


def test_shard_tensor_tags_and_sharding_of():
    _, pm = _both_meshes()
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = ap.shard_tensor(x, pm, _pl(ap, "r", "r", "r", "r", "s1"), stop_gradient=False)
    assert t.requires_grad and t.device == torch.device("cpu")
    sh = ap.sharding_of(t)
    assert sh.mesh is pm and sh.spec == (None, "model")
    assert ap.sharding_of(torch.ones(2)) is None
    d = ap.dtensor_from_fn(torch.ones, pm, _pl(ap, "s0", "r", "r", "r", "r"), 4, 2)
    assert ap.sharding_of(d).spec == ("data", None) and float(d.sum()) == 8.0
    c = ap.shard_constraint(t, pm, _pl(ap, *R5))
    np.testing.assert_array_equal(c.detach().numpy(), x)
    p = torch.nn.Parameter(torch.ones(4, 2))
    p.need_clip = False
    q = ap.shard_tensor(p, pm, _pl(ap, "r", "r", "s0", "r", "r"))
    assert isinstance(q, torch.nn.Parameter) and q.need_clip is False


# ---------------------------------------------------------------------------
# shard_layer through DistributedTrainStep

COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")


def _shard_fn(mod):
    def fn(name, sublayer, mesh):
        leaf = name.rsplit(".", 1)[-1]
        if leaf not in COLUMN + ROW:
            return
        dim = 1 if leaf in COLUMN else 0
        placements = [mod.Shard(dim) if a == "model" else mod.Replicate()
                      for a in mesh.dim_names]
        sublayer._parameters["weight"] = mod.shard_tensor(sublayer._parameters["weight"],
                                                          mesh, placements)
    return fn


def _llamas():
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama, llama_tiny as jtiny

    paddle.seed(0)
    jm = JLlama(jtiny(**KW))
    tm = LlamaForCausalLM(llama_tiny(**KW), device="cpu")
    load_numpy_state_dict(tm, _np(jm.state_dict()))
    return jm, tm


def _llama_batches(n=3, rows=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 256, (rows, seq)).astype(np.int32)
        out.append((ids, np.roll(ids, -1, 1).astype(np.int64)))
    return out


def test_shard_layer_layout_reaches_distributed_train_step():
    jhcg, hcg = _hcgs(dp=2, mp=2, sharding=2)
    jm, tm = _llamas()
    jpm, pm = jap.ProcessMesh(jhcg.mesh), ap.ProcessMesh(hcg.mesh)
    jap.shard_layer(jm, jpm, _shard_fn(jap))
    ap.shard_layer(tm, pm, _shard_fn(ap))
    jopt = jap.shard_optimizer(paddle.optimizer.AdamW(1e-3, parameters=jm.parameters(),
                                                      grad_clip=jnn.ClipGradByGlobalNorm(1.0)))
    opt = ap.shard_optimizer(AdamW(1e-3, parameters=tm.parameters(),
                                   grad_clip=ptt.nn.ClipGradByGlobalNorm(1.0)))
    jstep = jdist.DistributedTrainStep(jm, lambda m, x, y: m(x, labels=y)[0], jopt, jhcg,
                                       sharding_stage=1)
    step = dist.DistributedTrainStep(tm, lambda m, x, y: m(x, labels=y)[0], opt, hcg,
                                     sharding_stage=1)
    jspecs = dict(zip(jstep._param_names, jstep._param_shardings))
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    seen = 0
    for name, p, spec, sspec in zip(names, step._params, step._param_shardings,
                                    step._state_shardings):
        jspec = tuple(jspecs[name].spec)
        assert spec == jspec + (None,) * (p.dim() - len(jspec)), name
        if name.rsplit(".", 2)[-2] in COLUMN + ROW:
            seen += 1
            assert "model" in str(spec) and "sharding" in str(sspec["moment1"]), name
    assert seen == len(COLUMN + ROW) * KW["num_hidden_layers"]
    batches = _llama_batches()
    want = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))) for x, y in batches]
    got = [float(step(x, y)) for x, y in batches]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for name, w in _np(jm.state_dict()).items():
        assert _rel_l2(tm.state_dict()[name].numpy(), w) <= 1e-4, name


# ---------------------------------------------------------------------------
# Engine


def _ce(mod):
    if mod is jap:
        return lambda logits, y: JF.cross_entropy(logits.reshape([-1, 256]), y.reshape([-1]))
    return lambda logits, y: F.cross_entropy(logits.reshape(-1, 256), y.reshape(-1))


def test_engine_fit_evaluate_predict_on_batches():
    """A plain list of Llama batches (taken as they are), at dp 2 x
    sharding 4: fit's history, evaluate's loss and predict's logits equal
    the JAX Engine's."""
    jhcg, hcg = _hcgs(dp=2, sharding=4)
    jm, tm = _llamas()
    jeng = jap.Engine(jm, _ce(jap), paddle.optimizer.AdamW(1e-3, parameters=jm.parameters()))
    eng = ap.Engine(tm, _ce(ap), AdamW(1e-3, parameters=tm.parameters()))
    batches = _llama_batches(4, rows=8)
    jhist = jeng.fit(batches, epochs=2, verbose=0)
    hist = eng.fit(batches, epochs=2, verbose=0)
    assert eng._train_step.mesh is hcg.mesh
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4)
    assert hist["loss"][1] < hist["loss"][0]
    evals = _llama_batches(2, seed=5)
    jlogs, logs = jeng.evaluate(evals, verbose=0), eng.evaluate(evals, verbose=0)
    np.testing.assert_allclose(logs["loss"], jlogs["loss"], rtol=1e-4)
    jout, out = jeng.predict(evals, steps=1), eng.predict(evals, steps=1)
    assert len(out) == len(jout) == 1
    np.testing.assert_allclose(out[0], np.asarray(jout[0]), rtol=1e-4, atol=1e-5)


class _Toy:
    """The reference test's classification set (tests/test_dist_semantics.py)."""

    def __init__(self, base, n=32, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.standard_normal((n, 16)).astype(np.float32)
        self.y = (self.x[:, 0] > 0).astype(np.int64).reshape(-1, 1)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def test_engine_on_a_dataset_through_the_distributed_sampler():
    import paddle_tpu.io as jio
    import paddle_tpu.metric as jmetric

    import paddle_tpu_torch.io as tio
    import paddle_tpu_torch.metric as tmetric

    _hcgs(dp=8)
    paddle.seed(1234)
    jnet = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 2))
    tnet = torch.nn.Sequential(ptt.nn.Linear(16, 32, device="cpu"), torch.nn.ReLU(),
                               ptt.nn.Linear(32, 2, device="cpu"))
    load_numpy_state_dict(tnet, _np(jnet.state_dict()))
    jset = type("JToy", (_Toy, jio.Dataset), {})(None)
    tset = type("TToy", (_Toy, tio.Dataset), {})(None)
    # the index stream Engine.fit reads: the same in both packages
    jidx = list(jio.DistributedBatchSampler(jset, batch_size=8, shuffle=True))
    assert list(tio.DistributedBatchSampler(tset, batch_size=8, shuffle=True)) == jidx
    jeng = jap.Engine(jnet, jnn.CrossEntropyLoss(),
                      paddle.optimizer.Adam(learning_rate=1e-2, parameters=jnet.parameters()),
                      metrics=jmetric.Accuracy())
    eng = ap.Engine(tnet, lambda out, y: F.cross_entropy(out, y),
                    ptt.optimizer.Adam(learning_rate=1e-2, parameters=tnet.parameters()),
                    metrics=tmetric.Accuracy())
    jhist = jeng.fit(jset, epochs=6, batch_size=8, verbose=0)
    hist = eng.fit(tset, epochs=6, batch_size=8, verbose=0)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4)
    assert hist["loss"][-1] < hist["loss"][0]
    jval = type("JToy", (_Toy, jio.Dataset), {})(None, seed=1)
    tval = type("TToy", (_Toy, tio.Dataset), {})(None, seed=1)
    jlogs = jeng.evaluate(jval, batch_size=8, verbose=0)
    logs = eng.evaluate(tval, batch_size=8, verbose=0)
    assert logs.keys() == jlogs.keys() == {"loss", "acc"}
    np.testing.assert_allclose(logs["loss"], jlogs["loss"], rtol=1e-4)
    assert logs["acc"] == jlogs["acc"]
    out, jout = eng.predict(tval, batch_size=8), jeng.predict(jval, batch_size=8)
    assert len(out) == len(jout) == 4
    np.testing.assert_allclose(np.concatenate(out), np.concatenate([np.asarray(o) for o in jout]),
                               rtol=1e-4, atol=1e-5)


def test_engine_prepare_errors_and_the_a7_refusals(tmp_path):
    """The prepare errors; ``save``/``load``, which raised until the
    distributed checkpoint (A7a), now write and read it."""
    with pytest.raises(RuntimeError, match="model and loss"):
        ap.Engine().prepare()
    net = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="optimizer"):
        ap.Engine(net, lambda out, y: out.sum()).prepare()
    with pytest.raises(TypeError, match="Metric"):
        ap.Engine(net, lambda out, y: out.sum(), metrics=[object()])
    eng = ap.Engine(net, lambda out, y: out.sum(), AdamW(1e-3, parameters=net.parameters()))
    eng.save(str(tmp_path / "ck"))
    assert (tmp_path / "ck" / "COMMITTED").exists()
    with pytest.raises(FileNotFoundError):
        eng.load(str(tmp_path / "missing"))


def test_engine_save_load_reshards_the_training_state(tmp_path):
    """``Engine.save`` at dp 2 x sharding 4 after a fit, ``Engine.load`` into
    a fresh engine at dp 4 x sharding 2: the weights and the optimizer
    state come back, and the next fit's losses equal the first engine's and
    the JAX Engine's continuing from the same point."""
    jhcg, hcg = _hcgs(dp=2, sharding=4)
    jm, tm = _llamas()
    jeng = jap.Engine(jm, _ce(jap), paddle.optimizer.AdamW(1e-3, parameters=jm.parameters()))
    eng = ap.Engine(tm, _ce(ap), AdamW(1e-3, parameters=tm.parameters()))
    batches = _llama_batches(2, rows=8)
    jeng.fit(batches, epochs=1, verbose=0)
    eng.fit(batches, epochs=1, verbose=0)
    eng.save(str(tmp_path / "ck"))
    assert (tmp_path / "ck" / "optimizer.pdopt").exists()
    want = eng.fit(batches, epochs=1, verbose=0)["loss"]
    jwant = jeng.fit(batches, epochs=1, verbose=0)["loss"]
    jtopo.set_hybrid_communicate_group(None)
    topology.set_hybrid_communicate_group(None)
    _hcgs(dp=4, sharding=2)
    fresh = LlamaForCausalLM(llama_tiny(**KW), device="cpu", seed=9)
    eng2 = ap.Engine(fresh, _ce(ap), AdamW(1e-3, parameters=fresh.parameters()))
    eng2.load(str(tmp_path / "ck"))
    got = eng2.fit(batches, epochs=1, verbose=0)["loss"][-1]   # the histories run on
    np.testing.assert_allclose(got, want[-1], rtol=1e-5)
    np.testing.assert_allclose(got, jwant[-1], rtol=1e-4)


def test_engine_default_strategy_is_data_parallel_over_the_devices():
    """No strategy and no group: data parallelism over every visible
    device (here the CPU, once asked for)."""
    ptt.set_device("cpu")
    net = torch.nn.Linear(8, 8)
    eng = ap.Engine(net, lambda out, y: torch.nn.functional.mse_loss(out, y),
                    AdamW(0.1, parameters=net.parameters()))
    eng.prepare()
    assert eng._train_step.mesh.shape["data"] == 1 and eng._train_step.sharding_stage == 0
