"""The port's MoE layers, gates, routing and dispatch utilities
(``paddle_tpu_torch.incubate.distributed``) against the JAX package's, on
the CPU.

Routing: the port routes by index (a slot ``e·C + pos`` for each kept
assignment); the tests turn that back into the reference's dense
``[N, E, C]`` dispatch and combine and hold them to ``_topk_routing``:
the dispatch (which slot each assignment takes, the drops, the priority
order, the ties) exactly; the combine weights and ``l_aux`` within rtol
1e-6, because the two libraries' f32 softmax differ by up to an ulp
(their ``exp``).  Fed the reference's probabilities, the weights are
bit-equal.

Layers: weights cross through ``convert``; outputs and every gradient
(the router's included) are held within ``tests/op_test.py``'s rows (f32
rtol 2e-5 / atol 1e-6 on outputs, 1e-4 on gradients summed over the
tokens; bf16 rtol / atol 2e-2, grads 4e-2), at capacity factors 0.5
(drops) and 4.0 (none).  The expert split under a single-controller mesh
is bit-equal to one block.  Switch's noise reaches both packages from one
numpy stream (``test_torch_dropout.FedMasks``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.incubate.distributed.utils import moe_utils as jutils

import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.incubate.distributed.models import moe
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ExpertParallelMLP, GShardGate, MoELayer, NaiveGate, SwitchGate, _capacity, _route)
from paddle_tpu_torch.incubate.distributed.utils import moe_utils

from test_torch_dropout import FedMasks

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)        # tests/op_test.py, float32
F32_GRAD = dict(rtol=1e-4, atol=1e-5)   # grads summed over the tokens in another order
BF16 = dict(rtol=2e-2, atol=2e-2)       # tests/op_test.py, bfloat16
BF16_GRAD = dict(rtol=4e-2, atol=4e-2)  # tests/op_test.py, bfloat16 grads
WEIGHTS = dict(rtol=1e-6, atol=1e-7)    # f32 softmax of the two libraries: an ulp apart
DTYPES = {"float32": (F32, F32_GRAD), "bfloat16": (BF16, BF16_GRAD)}


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    v = x._value if hasattr(x, "_value") else x
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def _dense(r, n, e):
    """The port's Routing as the reference's dense dispatch and combine."""
    c = r.capacity
    disp = np.zeros((n, e, c), np.float32)
    comb = np.zeros((n, e, c), np.float32)
    for j in range(r.expert.shape[0]):
        for t in range(n):
            if bool(r.keep[j, t]):
                ex, p = int(r.expert[j, t]), int(r.pos[j, t])
                assert int(r.slot[j, t]) == ex * c + p
                disp[t, ex, p] += 1.0
                comb[t, ex, p] += float(r.weight[j, t])
            else:
                assert int(r.slot[j, t]) == e * c
    return disp, comb


def _check_routing(logits, k, cap):
    jd, jc, jl = jmoe._topk_routing(jnp.asarray(logits), k, cap)
    r = _route(torch.from_numpy(logits), k, cap)
    disp, comb = _dense(r, *logits.shape)
    np.testing.assert_array_equal(disp, np.asarray(jd))
    np.testing.assert_allclose(comb, np.asarray(jc), **WEIGHTS)
    np.testing.assert_allclose(float(r.l_aux), float(jl), **WEIGHTS)
    return r, np.asarray(jd)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
class TestRouting:
    @pytest.mark.parametrize("n,e,k,cf", [(64, 4, 2, 2.0), (64, 4, 2, 4.0), (100, 4, 2, 1.5),
                                          (10, 4, 1, 1.0), (8192, 8, 2, 2.0), (512, 8, 2, 2.0),
                                          (7, 3, 2, 0.5), (1, 8, 2, 2.0)])
    def test_capacity_table(self, n, e, k, cf):
        assert _capacity(n, e, k, cf) == jmoe._capacity(n, e, k, cf)
        assert _capacity(n, e, k, cf) % 8 == 0 and _capacity(n, e, k, cf) >= 8

    @pytest.mark.parametrize("n,e,k,cf", [(64, 4, 2, 0.5), (64, 4, 2, 4.0), (48, 8, 2, 1.0),
                                          (32, 4, 1, 0.5), (40, 6, 3, 1.0)])
    def test_random_logits_match_reference(self, n, e, k, cf):
        _check_routing(_np(n * e + k, n, e, scale=2.0), k, _capacity(n, e, k, cf))

    def test_second_choices_overflow_behind_first_choices(self):
        """Tokens 0-7 pick expert 0 first and expert 2 second; tokens 8-15
        pick expert 1 first and expert 0 second.  Every first choice claims
        before any second, so tokens 0-7 fill expert 0 and the second
        choices of tokens 8-15 find it full (capacity 8)."""
        logits = np.zeros((16, 4), np.float32)
        logits[:8, 0], logits[:8, 2] = 5.0, 4.5
        logits[8:, 1], logits[8:, 0] = 5.0, 4.5
        r, jd = _check_routing(logits, 2, 8)
        assert bool(r.keep[0].all())                    # first choices all kept
        assert not bool(r.keep[1, 8:].any())            # expert 0 full: dropped
        assert bool(r.keep[1, :8].all())                # expert 2 empty: kept
        np.testing.assert_array_equal(r.pos[1, 8:].numpy(), np.arange(8, 16))

    def test_ties_go_to_the_lower_expert(self):
        logits = np.zeros((16, 4), np.float32)
        logits[:, 0] = 10.0           # every token to expert 0, ties elsewhere
        r, _ = _check_routing(logits, 2, 8)
        assert (r.expert[1] == 1).all()
        r, _ = _check_routing(np.zeros((12, 5), np.float32), 3, 16)   # all tied
        assert (r.expert.t() == torch.tensor([0, 1, 2])).all()

    # tests/test_incubate.py TestRouting's three cases, on the port
    def test_capacity_rounding(self):
        assert _capacity(64, 4, 2, 1.0) == 32
        assert _capacity(10, 4, 1, 1.0) == 8
        assert _capacity(100, 4, 2, 1.5) % 8 == 0

    def test_dispatch_properties(self):
        logits = np.random.default_rng(3).standard_normal((32, 4)).astype(np.float32)
        r, _ = _check_routing(logits, 2, 16)
        disp, comb = _dense(r, 32, 4)
        assert disp.sum(axis=(1, 2)).max() <= 2.0 and disp.sum(axis=0).max() <= 1.0
        assert comb.sum(axis=(1, 2)).max() <= 1.0 + 1e-5 and np.isfinite(float(r.l_aux))

    def test_capacity_drops_overflow(self):
        logits = np.tile(np.asarray([[10.0, 0.0]], np.float32), (16, 1))
        r, _ = _check_routing(logits, 1, 8)
        assert int(r.keep.sum()) == 8 and (r.expert == 0).all()

    def test_weights_bit_equal_from_the_reference_probabilities(self, monkeypatch):
        """Fed the reference's softmax, the port's weights are the
        reference's bit for bit."""
        logits = _np(5, 64, 8, scale=2.0)
        jprobs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
        monkeypatch.setattr(torch, "softmax", lambda x, dim: torch.from_numpy(jprobs.copy()))
        r = _route(torch.from_numpy(logits), 2, 24)
        _, jc, _ = jmoe._topk_routing(jnp.asarray(logits), 2, 24)
        np.testing.assert_array_equal(_dense(r, 64, 8)[1], np.asarray(jc))

    def test_gradients_reach_the_router_through_the_kept_weights(self):
        """The logits' gradient through the combine weights is the
        reference's (``jax.vjp`` of ``_topk_routing``'s combine); dropped
        assignments pass none."""
        lg, g = _np(6, 32, 4, scale=2.0), _np(7, 32, 4, 8)
        logits = torch.from_numpy(lg).requires_grad_()
        r = _route(logits, 2, 8)
        assert not bool(r.keep.all())
        comb = torch.zeros(32, 4 * 8 + 1).scatter_add(
            1, r.slot.t(), (r.weight * r.keep).t()).view(32, -1)[:, :32].view(32, 4, 8)
        (comb * torch.from_numpy(g)).sum().backward()
        _, vjp = jax.vjp(lambda x: jmoe._topk_routing(x, 2, 8)[1], jnp.asarray(lg))
        np.testing.assert_allclose(logits.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                                   **F32)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------
def _gate_pair(cls, jcls, seed, **kw):
    paddle.seed(seed)
    jg = jcls(8, 4, **kw)
    tg = cls(8, 4, device="cpu", **kw)
    load_numpy_state_dict(tg, {k: np.asarray(v.numpy()) for k, v in jg.state_dict().items()})
    return jg, tg


class TestGates:
    @pytest.mark.parametrize("name", ["NaiveGate", "GShardGate"])
    def test_topk_and_loss_match(self, name):
        jg, tg = _gate_pair(getattr(moe, name), getattr(jmoe, name), 1)
        x = _np(2, 16, 8)
        jv, ji = jg(paddle.to_tensor(x))
        tv, ti = tg(torch.from_numpy(x))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji.numpy()))
        np.testing.assert_allclose(tv.detach().numpy(), jv.numpy(), **F32)
        if name == "GShardGate":
            np.testing.assert_allclose(float(tg.get_loss()), float(jg.get_loss().numpy()),
                                       **F32)
            assert tg.get_loss() is None
        else:
            assert tg.loss is None

    def test_switch_gate_eval_and_training_noise(self, monkeypatch):
        jg, tg = _gate_pair(SwitchGate, jmoe.SwitchGate, 3)
        x = _np(4, 16, 8)
        jg.eval(), tg.eval()
        jv, ji = jg(paddle.to_tensor(x))
        tv, ti = tg(torch.from_numpy(x))
        assert tuple(tv.shape) == (16, 1)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji.numpy()))
        np.testing.assert_allclose(tv.detach().numpy(), jv.numpy(), **F32)
        fed = FedMasks(monkeypatch, seed=7, uniform=True)
        jg.train(), tg.train()
        jv, ji = jg(paddle.to_tensor(x))
        tv, ti = tg(torch.from_numpy(x))
        fed.check_same_draws(1)
        assert fed.port[0] == ("uniform", (16, 4), 0.9)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji.numpy()))
        np.testing.assert_allclose(tv.detach().numpy(), jv.numpy(), **F32)
        np.testing.assert_allclose(float(tg.get_loss()), float(jg.get_loss().numpy()), **F32)

    def test_gate_factory(self):
        mk = lambda n: [nn.Linear(8, 8, device="cpu") for _ in range(n)]
        assert isinstance(MoELayer(8, experts=mk(1), gate={"type": "naive", "top_k": 1}).gate,
                          NaiveGate)
        assert isinstance(MoELayer(8, experts=mk(1), gate={"type": "switch"}).gate, SwitchGate)
        g = GShardGate(8, 4, device="cpu")
        assert MoELayer(8, experts=mk(4), gate=g).gate is g
        assert MoELayer(8, experts=mk(2)).gate.gate_weight.device.type == "cpu"
        with pytest.raises(ValueError, match="unknown gate"):
            MoELayer(8, experts=mk(2), gate={"type": "hash"})
        with pytest.raises(ValueError, match="non-empty"):
            MoELayer(8, experts=[])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
class JExpert(jnn.Layer):
    def __init__(self, d, h):
        super().__init__()
        self.up = jnn.Linear(d, h)
        self.down = jnn.Linear(h, d)

    def forward(self, x):
        return self.down(JF.relu(self.up(x)))


class Expert(nn.Layer):
    def __init__(self, d, h):
        super().__init__()
        self.up = nn.Linear(d, h, device="cpu")
        self.down = nn.Linear(h, d, device="cpu")

    def forward(self, x):
        return self.down(F.relu(self.up(x)))


def _moe_pair(kind, cf, dtype, seed=0, d=16, h=32, e=4, act="swiglu"):
    paddle.seed(seed)
    if kind == "moe_layer":
        jl = jmoe.MoELayer(d, experts=[JExpert(d, h) for _ in range(e)],
                           gate={"type": "gshard", "top_k": 2}, capacity_factor=cf)
        tl = MoELayer(d, experts=[Expert(d, h) for _ in range(e)],
                      gate={"type": "gshard", "top_k": 2}, capacity_factor=cf)
    else:
        jl = jmoe.ExpertParallelMLP(d, h, num_experts=e, top_k=2, capacity_factor=cf,
                                    activation=act)
        tl = ExpertParallelMLP(d, h, num_experts=e, top_k=2, capacity_factor=cf,
                               activation=act, device="cpu")
    load_numpy_state_dict(tl, {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()})
    if dtype == "bfloat16":
        jl.bfloat16()
        tl.bfloat16()
    return jl, tl


def _run_pair(jl, tl, x, gout, dtype):
    jx = paddle.to_tensor(np.asarray(jnp.asarray(x).astype(getattr(jnp, dtype))))
    jx.stop_gradient = False
    jout = jl(jx)
    jloss = (jout.astype("float32") * paddle.to_tensor(gout)).sum() + jl.l_aux
    jloss.backward()
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tout = tl(tx)
    (((tout.float() * torch.from_numpy(gout)).sum()) + tl.l_aux).backward()
    return (jout, jx, dict(jl.named_parameters())), (tout, tx, tl)


class TestLayers:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("cf", [0.5, 4.0])
    @pytest.mark.parametrize("kind", ["moe_layer", "expert_parallel"])
    def test_forward_and_every_grad_match(self, kind, cf, dtype):
        fwd, grad = DTYPES[dtype]
        jl, tl = _moe_pair(kind, cf, dtype, seed=10)
        x, gout = _np(11, 2, 12, 16), _np(12, 2, 12, 16)
        (jout, jx, jparams), (tout, tx, _) = _run_pair(jl, tl, x, gout, dtype)
        assert tout.dtype == getattr(torch, dtype) and tuple(tout.shape) == (2, 12, 16)
        np.testing.assert_allclose(_f32(tout), _f32(jout), **fwd)
        np.testing.assert_allclose(float(tl.l_aux), float(jl.l_aux.numpy()), **fwd)
        np.testing.assert_allclose(_f32(tx.grad), _f32(jx.grad), **grad)
        names = [n for n, _ in tl.named_parameters()]
        assert sorted(names) == sorted(jparams)
        for name, p in tl.named_parameters():
            assert p.grad is not None, name
            np.testing.assert_allclose(_f32(p.grad), _f32(jparams[name].grad), **grad,
                                       err_msg=name)

    def test_drops_happen_at_the_small_capacity(self):
        _, tl = _moe_pair("expert_parallel", 0.5, "float32")
        tokens = torch.from_numpy(_np(11, 24, 16))
        r = _route(moe._router_logits(tokens, tl.gate_weight), 2, _capacity(24, 4, 2, 0.5))
        assert not bool(r.keep.all())
        r = _route(moe._router_logits(tokens, tl.gate_weight), 2, _capacity(24, 4, 2, 4.0))
        assert bool(r.keep.all())

    @pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
    def test_other_activations_match(self, act):
        jl, tl = _moe_pair("expert_parallel", 2.0, "float32", seed=13, act=act)
        assert not hasattr(tl, "w_gate")
        x = _np(14, 3, 8, 16)
        np.testing.assert_allclose(_f32(tl(torch.from_numpy(x))),
                                   _f32(jl(paddle.to_tensor(x))), **F32)

    def test_combine_rounds_as_the_reference_in_bf16(self):
        """bf16: the weights round to bf16 and the two products (exact in
        f32) sum once, so the combine is the reference's bit for bit."""
        jl, tl = _moe_pair("expert_parallel", 4.0, "bfloat16", seed=15)
        tokens = _np(16, 32, 16)
        jt = jnp.asarray(tokens).astype(jnp.bfloat16)
        logits = np.asarray(jt.astype(jnp.float32) @ jl.gate_weight._value.astype(jnp.float32))
        cap = _capacity(32, 4, 2, 4.0)
        _, comb, _ = jmoe._topk_routing(jnp.asarray(logits), 2, cap)
        ye = jnp.asarray(_np(17, 4, cap, 16)).astype(jnp.bfloat16)
        want = jnp.einsum("nec,ecd->nd", comb.astype(ye.dtype), ye)
        r = _route(torch.from_numpy(logits), 2, cap)
        got = moe._combine(torch.from_numpy(np.asarray(ye.astype(jnp.float32))).bfloat16(),
                           r, round_weights=True)
        np.testing.assert_array_equal(_f32(got), _f32(want))

    def test_matches_the_dense_mixture_with_ample_capacity(self):
        """tests/test_incubate.py's dense check: with capacity for every
        token, out = Σ_k w_k · expert_k(x)."""
        d, e = 8, 3
        layer = MoELayer(d, experts=[Expert(d, 16) for _ in range(e)],
                         gate={"type": "gshard", "top_k": 2}, capacity_factor=float(e))
        tokens = torch.from_numpy(_np(18, 6, d))
        with torch.no_grad():
            out = layer(tokens[None]).reshape(-1, d)
            probs = torch.softmax(tokens @ layer.gate.gate_weight, -1)
            outs = torch.stack([layer.experts[i](tokens) for i in range(e)])
        ref = torch.zeros_like(out)
        for t in range(6):
            top = torch.argsort(-probs[t])[:2]
            w = probs[t][top] / probs[t][top].sum()
            for wi, ei in zip(w, top):
                ref[t] += wi * outs[ei, t]
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=1e-5)


class TestExpertAxes:
    def _layer(self, e=8, axes="data"):
        paddle.seed(20)
        jl = jmoe.ExpertParallelMLP(16, 32, num_experts=e, top_k=2, capacity_factor=2.0,
                                    expert_axes=axes)
        tl = ExpertParallelMLP(16, 32, num_experts=e, top_k=2, capacity_factor=2.0,
                               expert_axes=axes, device="cpu")
        load_numpy_state_dict(tl, {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()})
        return jl, tl

    @staticmethod
    def _grads(tl, x):
        tx = torch.from_numpy(x).requires_grad_()
        out = tl(tx)
        (out.sum() + tl.l_aux).backward()
        grads = [tx.grad] + [p.grad for p in tl.parameters()]
        tl.zero_grad()
        return out.detach(), grads

    @pytest.mark.parametrize("degrees,axes", [(dict(dp=2), "data"), (dict(mp=4), "model"),
                                              (dict(dp=2, mp=2), ("data", "model"))])
    def test_split_is_bit_equal_to_one_block(self, degrees, axes):
        jl, tl = self._layer(axes=axes)
        x = _np(21, 4, 16, 16)
        one, one_grads = self._grads(tl, x)
        n = int(np.prod(list(degrees.values())))
        mesh = topology.build_mesh(devices=["cpu"] * n, **degrees)
        topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(mesh=mesh))
        try:
            assert tl._expert_mesh() is mesh
            split, split_grads = self._grads(tl, x)
        finally:
            topology.set_hybrid_communicate_group(None)
        torch.testing.assert_close(split, one, rtol=0, atol=0)
        for a, b in zip(split_grads, one_grads):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        # and the reference's layer (one block without its mesh)
        np.testing.assert_allclose(split.numpy(), jl(paddle.to_tensor(x)).numpy(), **F32)

    def test_indivisible_experts_raise_and_other_axes_run_one_block(self):
        _, tl = self._layer(e=6, axes="data")
        mesh = topology.build_mesh(dp=4, devices=["cpu"] * 4)
        topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(mesh=mesh))
        try:
            with pytest.raises(ValueError, match="do not divide"):
                tl(torch.from_numpy(_np(22, 8, 16)))
            tl.expert_axes = ("model",)    # size 1 on this mesh: one block
            assert tl._expert_mesh() is None
        finally:
            topology.set_hybrid_communicate_group(None)
        assert tl._expert_mesh() is None


# ---------------------------------------------------------------------------
# moe_utils
# ---------------------------------------------------------------------------
class TestMoEUtils:
    def test_count_by_gate(self):
        gate = np.array([2, 0, 2, 1, 0, 2])
        pos, local, glob = moe_utils.count_by_gate(torch.from_numpy(gate), num_expert=3)
        jpos, jlocal, jglob = jutils.count_by_gate(paddle.to_tensor(gate), num_expert=3)
        for a, b in ((pos, jpos), (local, jlocal), (glob, jglob)):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(pos.numpy(), [1, 4, 3, 0, 2, 5])
        assert moe_utils.count_by_gate(torch.from_numpy(gate), 3, require_pos=False)[0].numel() == 0
        with pytest.raises(ValueError, match="out of range"):
            moe_utils.count_by_gate(torch.tensor([0, 3]), num_expert=3)

    @pytest.mark.parametrize("capacity", [None, 2])
    def test_scatter_gather_round_trip_matches_reference(self, capacity):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((9, 4)).astype(np.float32)
        gate = np.array([2, 0, 2, 1, 0, 2, 2, 0, 1])
        pos, local, glob = moe_utils.count_by_gate(torch.from_numpy(gate), num_expert=3)
        jpos, jlocal, jglob = jutils.count_by_gate(paddle.to_tensor(gate), num_expert=3)
        sorted_x = x[pos.numpy()]
        buf = moe_utils.global_scatter(torch.from_numpy(sorted_x), local, glob,
                                       capacity=capacity)
        jbuf = jutils.global_scatter(paddle.to_tensor(sorted_x), jlocal, jglob,
                                     capacity=capacity)
        np.testing.assert_array_equal(buf.numpy(), jbuf.numpy())
        back = moe_utils.global_gather(buf, local, glob)
        np.testing.assert_array_equal(back.numpy(), jutils.global_gather(jbuf, jlocal,
                                                                         jglob).numpy())
        if capacity is None:
            np.testing.assert_array_equal(back.numpy(), sorted_x)
        else:   # expert 2's last two rows dropped: zeros
            assert not back[-2:].any() and buf.shape == (3, 2, 4)

    def test_capacity_drops_and_grads(self):
        x = torch.arange(8, dtype=torch.float32).reshape(4, 2).requires_grad_()
        gate = torch.tensor([0, 0, 0, 1])
        pos, local, g = moe_utils.count_by_gate(gate, num_expert=2)
        buf = moe_utils.global_scatter(x[pos.long()], local, g, capacity=2)
        assert tuple(buf.shape) == (2, 2, 2)
        back = moe_utils.global_gather(buf, local, g)
        assert not back[2].any()
        back.sum().backward()
        np.testing.assert_array_equal(x.grad.numpy(), [[1, 1], [1, 1], [0, 0], [1, 1]])
