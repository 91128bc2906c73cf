"""The port's optimizers (``optimizer/__init__.py``) against the JAX
package's, on the CPU: every update rule over 3 steps on the same numpy
parameters and gradients, in f32 and under ``multi_precision`` from bf16
(the f32 masters), with both coupled decays (L1, L2) and a ``ParamAttr``
regularizer, Nesterov, ``amsgrad``, ``centered``, Lamb's trust ratio;
``state_dict`` crossing both ways; ``set_lr``, ``set_lr_scheduler``,
``minimize``, ``clear_gradients``; the C4 probe (Adam's coupled decay
leaves out a parameter with a regularizer); Lamb under a ZeRO layout;
and the refusal of offloaded states by every rule but B5's.

Tolerances are the rows of ``tests/op_test.py``: f32 for f32 values
(masters, slots, f32 parameters), bf16 for bf16 parameters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor.tensor import Tensor as JTensor

import paddle_tpu_torch as ptt
from paddle_tpu_torch import optimizer as O
from paddle_tpu_torch.framework.param_attr import ParamAttr

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)     # tests/op_test.py, float32
BF16 = dict(rtol=2e-2, atol=2e-2)    # tests/op_test.py, bfloat16
SHAPES = [(4, 6), (6,), (3, 2, 5)]
STEPS = 3


@pytest.fixture(autouse=True)
def _on_cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _values(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _decay(pkg, kind, coeff):
    if kind == "l2":
        return pkg.L2Decay(coeff)
    if kind == "l1":
        return pkg.L1Decay(coeff)
    return coeff


# (name, class name, kwargs; "wd" a (kind, coeff) decay, "regularized" marks
# parameter 1 with a ParamAttr regularizer)
RULES = [
    ("sgd", "SGD", dict(learning_rate=0.1)),
    ("sgd_l2", "SGD", dict(learning_rate=0.1, wd=("l2", 0.05))),
    ("sgd_l1_regularized", "SGD", dict(learning_rate=0.1, wd=("l1", 0.05), regularized=True)),
    ("sgd_float_decay", "SGD", dict(learning_rate=0.1, wd=("float", 0.05))),
    ("momentum", "Momentum", dict(learning_rate=0.05, momentum=0.9)),
    ("momentum_nesterov_l2", "Momentum", dict(learning_rate=0.05, momentum=0.8,
                                              use_nesterov=True, wd=("l2", 0.01))),
    ("momentum_l1_regularized", "Momentum", dict(learning_rate=0.05, wd=("l1", 0.02),
                                                 regularized=True)),
    ("adam", "Adam", dict(learning_rate=0.01)),
    ("adam_amsgrad_l2", "Adam", dict(learning_rate=0.01, amsgrad=True, wd=("l2", 0.1))),
    ("adam_l1_regularized", "Adam", dict(learning_rate=0.01, wd=("l1", 0.1), regularized=True)),
    ("adam_lazy_multi_tensor", "Adam", dict(learning_rate=0.01, lazy_mode=True,
                                            use_multi_tensor=True)),
    ("adamw_amsgrad", "AdamW", dict(learning_rate=0.01, amsgrad=True, wd=("float", 0.1))),
    ("adamax_l2", "Adamax", dict(learning_rate=0.02, wd=("l2", 0.05))),
    ("adagrad", "Adagrad", dict(learning_rate=0.1, initial_accumulator_value=0.1)),
    ("adagrad_l1_regularized", "Adagrad", dict(learning_rate=0.1, wd=("l1", 0.01),
                                               regularized=True)),
    ("adadelta", "Adadelta", dict(learning_rate=1.0, rho=0.9, wd=("l2", 0.01))),
    ("rmsprop", "RMSProp", dict(learning_rate=0.01)),
    ("rmsprop_centered_momentum", "RMSProp", dict(learning_rate=0.01, momentum=0.9,
                                                  centered=True, wd=("l2", 0.01))),
    ("lamb", "Lamb", dict(learning_rate=0.01)),
    ("lamb_excluded", "Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.1,
                                   exclude=True)),
]


def _build(pkg_name, cls_name, kw, params):
    """The optimizer of one package over ``params`` (its tensors)."""
    kw = dict(kw)
    regularized = kw.pop("regularized", False)
    exclude = kw.pop("exclude", False)
    pkg = O if pkg_name == "port" else paddle.optimizer
    if "wd" in kw:
        kind, coeff = kw.pop("wd")
        kw["weight_decay"] = _decay(pkg, kind, coeff)
    if exclude:
        excluded = params[1]
        kw["exclude_from_weight_decay_fn"] = lambda p: p is excluded
    if regularized:
        params[1].regularizer = pkg.L2Decay(0.5)
    return getattr(pkg, cls_name)(parameters=params, **kw)


def _run(cls_name, kw, dtype, steps=STEPS, seed=0):
    """Both packages' parameters, masters and state dicts after each step."""
    values, grads = _values(seed)
    jparams = [JTensor(jnp.asarray(v).astype(dtype), stop_gradient=False) for v in values]
    pparams = [torch.nn.Parameter(torch.tensor(v).to(getattr(torch, dtype)))
               for v in values]
    jopt, popt = _build("jax", cls_name, kw, jparams), _build("port", cls_name, kw, pparams)
    if dtype == "bfloat16":
        jopt._multi_precision = popt._multi_precision = True
    history = []
    for g_step in grads[:steps]:
        for jp, pp, g in zip(jparams, pparams, g_step):
            jp._grad = JTensor(jnp.asarray(g).astype(dtype))
            pp.grad = torch.from_numpy(g).to(getattr(torch, dtype))
        jopt.step()
        popt.step()
        history.append(([np.asarray(p._value.astype(jnp.float32)) for p in jparams],
                        [p.detach().float().numpy().copy() for p in pparams]))
    return jopt, popt, jparams, pparams, history


def _state_arrays(sd):
    out = {}
    for k, v in sd.items():
        if k == "LR_Scheduler":
            continue
        if isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().float().numpy()
        else:
            out[k] = np.asarray(v._value.astype(jnp.float32))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,cls_name,kw", RULES, ids=[r[0] for r in RULES])
def test_rule_matches_reference(name, cls_name, kw, dtype):
    jopt, popt, _, _, history = _run(cls_name, kw, dtype)
    tol = F32 if dtype == "float32" else BF16
    for step, (want, got) in enumerate(history):
        for i, (w, g) in enumerate(zip(want, got)):
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{name} step {step} param {i}")
    want_sd, got_sd = _state_arrays(jopt.state_dict()), _state_arrays(popt.state_dict())
    assert set(got_sd) == set(want_sd)
    for k, w in want_sd.items():
        if isinstance(w, (int, float)):
            assert got_sd[k] == w, k
        else:       # slots and masters are f32 in both dtypes
            np.testing.assert_allclose(got_sd[k], w, **F32, err_msg=f"{name} {k}")
    if dtype == "bfloat16" and cls_name in ("SGD", "Momentum", "Adam", "AdamW", "Lamb"):
        assert any(k.endswith(".master_weight") for k in got_sd)


def test_c4_adam_coupled_decay_skips_a_regularized_parameter():
    """ROADMAP C4: a 2x2 Linear weight with a ParamAttr regularizer, all
    ones, gradient 0.5; one step of Adam(0.1, weight_decay=0.5,
    epsilon=1.0) gives the reference's 0.96667 (the port gave 0.95, the
    decay added to a parameter the reference leaves out)."""
    lin = ptt.nn.Linear(2, 2, weight_attr=ParamAttr(regularizer=O.L2Decay(0.1)))
    jlin = paddle.nn.Linear(2, 2, weight_attr=paddle.nn.ParamAttr(
        regularizer=paddle.optimizer.L2Decay(0.1)))
    with torch.no_grad():
        lin.weight.fill_(1.0)
    jlin.weight._value = jnp.ones((2, 2), jnp.float32)
    lin.weight.grad = torch.full((2, 2), 0.5)
    jlin.weight._grad = JTensor(jnp.full((2, 2), 0.5, jnp.float32))
    O.Adam(0.1, weight_decay=0.5, epsilon=1.0, parameters=[lin.weight]).step()
    paddle.optimizer.Adam(0.1, weight_decay=0.5, epsilon=1.0, parameters=[jlin.weight]).step()
    want = np.asarray(jlin.weight._value)
    np.testing.assert_allclose(want, np.full((2, 2), 0.96667), rtol=1e-5)
    np.testing.assert_allclose(lin.weight.detach().numpy(), want, **F32)
    # without the regularizer both decay it: 0.95
    plain = torch.nn.Parameter(torch.ones(2, 2))
    plain.grad = torch.full((2, 2), 0.5)
    O.Adam(0.1, weight_decay=0.5, epsilon=1.0, parameters=[plain]).step()
    np.testing.assert_allclose(plain.detach().numpy(), np.full((2, 2), 0.95), rtol=1e-5)


@pytest.mark.parametrize("cls_name,kw", [
    ("Momentum", dict(learning_rate=0.05, use_nesterov=True)),
    ("Adam", dict(learning_rate=0.01, amsgrad=True)),
    ("Adagrad", dict(learning_rate=0.1, initial_accumulator_value=0.2)),
    ("RMSProp", dict(learning_rate=0.01, centered=True, momentum=0.5)),
    ("Lamb", dict(learning_rate=0.01)),
], ids=["momentum", "adam_amsgrad", "adagrad", "rmsprop", "lamb"])
def test_state_dict_crosses_both_ways(cls_name, kw):
    """Two steps in one package, the state dict into the other through
    numpy, a third step in both: equal."""
    for src in ("jax", "port"):
        jopt, popt, jparams, pparams, _ = _run(cls_name, kw, "float32", steps=2)
        values, grads = _values(0)
        sd = (jopt if src == "jax" else popt).state_dict()
        arrays = {k: v if isinstance(v, (int, float)) else
                  (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v._value))
                  for k, v in sd.items()}
        # the target starts from fresh state at the source's parameter values
        fresh_j = [JTensor(jnp.asarray(p._value), stop_gradient=False) for p in jparams]
        fresh_p = [torch.nn.Parameter(p.detach().clone()) for p in pparams]
        if src == "jax":
            for fp, jp in zip(fresh_p, jparams):
                fp.data.copy_(torch.tensor(np.asarray(jp._value)))
            target = _build("port", cls_name, kw, fresh_p)
            target.set_state_dict({k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                                   for k, v in arrays.items()})
            other, other_params = jopt, jparams
            mine = fresh_p
        else:
            fresh_j = [JTensor(jnp.asarray(p.detach().numpy()), stop_gradient=False)
                       for p in pparams]
            target = _build("jax", cls_name, kw, fresh_j)
            target.set_state_dict(arrays)
            other, other_params = popt, pparams
            mine = fresh_j
        g3 = grads[2]
        for p, g in zip(mine, g3):
            if isinstance(p, torch.Tensor):
                p.grad = torch.from_numpy(g)
            else:
                p._grad = JTensor(jnp.asarray(g))
        for p, g in zip(other_params, g3):
            if isinstance(p, torch.Tensor):
                p.grad = torch.from_numpy(g)
            else:
                p._grad = JTensor(jnp.asarray(g))
        target.step()
        other.step()
        for a, b in zip(mine, other_params):
            av = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a._value)
            bv = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b._value)
            np.testing.assert_allclose(av, bv, **F32, err_msg=f"{cls_name} from {src}")


def test_lr_methods_minimize_and_clear_gradients():
    p = torch.nn.Parameter(torch.ones(3))
    sched = O.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    opt = O.SGD(0.1, parameters=[p])
    opt.set_lr(0.2)
    assert opt.get_lr() == 0.2
    opt.set_lr_scheduler(sched)
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.3)
    p.grad = torch.full((3,), 2.0)
    assert opt.minimize(None) == (None, None)
    np.testing.assert_allclose(p.detach().numpy(), np.full(3, 0.8), rtol=1e-6)
    assert p.grad is not None      # minimize leaves the gradients
    assert "LR_Scheduler" in opt.state_dict()
    opt.clear_gradients()
    assert p.grad is None
    assert O.Optimizer.clear_gradients is O.Optimizer.clear_grad


@pytest.mark.parametrize("cls_name", ["SGD", "Momentum", "Adamax", "Adagrad", "Adadelta",
                                      "RMSProp", "Lamb"])
def test_offloaded_states_refused_by_every_rule_but_b5(cls_name):
    """Only B5 updates states held in host memory; a rule given them (its
    ``out``, the card's parameter, marks them) raises."""
    p = torch.nn.Parameter(torch.ones(4))
    lr = 1.0 if cls_name == "Adadelta" else 0.1
    opt = getattr(O, cls_name)(lr, parameters=[p])
    st = opt._init_state(p)
    with pytest.raises(RuntimeError, match="B5"):
        opt._update_rule(p.detach(), torch.ones(4), st, 0.1, p, out=p.detach().clone())


def test_adam_amsgrad_never_takes_b5():
    """Under use_fused_adamw, amsgrad keeps the plain path (the reference's
    ``not self._amsgrad``): moment2_max is kept and equals the plain run."""
    p = torch.nn.Parameter(torch.ones(5))
    calls = []
    import paddle_tpu_torch.optimizer as mod

    orig = mod.fused_adamw
    mod.fused_adamw = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        with ptt.flag_guard(use_fused_adamw=True):
            opt = O.AdamW(0.01, parameters=[p], amsgrad=True)
            for v in (1.0, -0.5):
                p.grad = torch.full((5,), v)
                opt.step()
    finally:
        mod.fused_adamw = orig
    assert not calls
    assert set(opt.state_dict()) >= {"param_0.moment2_max", "param_0.moment1"}


def test_lamb_trust_ratio_over_the_whole_zero_layout():
    """Under a ZeRO layout (``DistributedTrainStep``, sharding 2 on one
    controller) Lamb's trust ratio is taken over the whole parameter, so
    the sharded step equals the plain ``TrainStep``."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.jit import TrainStep

    def make():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                   torch.nn.Linear(16, 4))

    def loss_fn(m, x, y):
        return ((m(x) - y) ** 2).mean()

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
    plain = make()
    step = TrainStep(plain, loss_fn, O.Lamb(0.05, parameters=plain.parameters()))
    sharded = make()
    s = dist.fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 2}
    dist.fleet.init(is_collective=True, strategy=s, devices=["cpu"] * 2)
    try:
        hcg = dist.fleet.get_hybrid_communicate_group()
        opt = O.Lamb(0.05, parameters=sharded.parameters())
        dstep = dist.DistributedTrainStep(sharded, loss_fn, opt, hcg, sharding_stage=1)
        assert opt._layouts           # blocked over the sharding members
        for _ in range(3):
            np.testing.assert_allclose(float(dstep(x, y)), float(step(x, y)), **F32)
    finally:
        from paddle_tpu_torch.distributed import topology

        topology.set_hybrid_communicate_group(None)
    for a, b in zip(sharded.parameters(), plain.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), **F32)
