"""The port's pipeline engines (ROADMAP A6c) against the JAX package's, on
the CPU.

The JAX engines run on conftest's 8 forced CPU devices; the port's on
single-controller meshes of repeated ``cpu`` members, with the blocks'
weights carried across by ``convert.py``.  Cases (after
``tests/test_pipeline_compiled.py`` and ``tests/test_distributed.py``):
- ``make_1f1b_schedule``'s tables array for array, its depths, ticks and
  events, for p in {2, 4}, m in {2, 4, 8}, v in {1, 2}, and
  ``schedule_efficiency``;
- ``GPipeLayers`` and ``OneFOneBLayers`` (v 1 and 2, recompute True, False
  and "auto") loss and grads against the JAX engines and against the same
  blocks run sequentially over the micro-batches; the executed segment
  counts (P·M·v against GPipe's P·(M+P-1)); ``train_batch``;
- the host ``PipelineParallel`` and ``PipelineParallelWithInterleave``:
  schedule strings against the JAX runtimes', losses and grads against
  sequential and against the 1F1B engine, ``SharedLayerDesc`` tying and
  ``seg_method``.

Tolerances: the reference tests' (loss rtol 1e-5, grads rtol 1e-4 /
atol 1e-5); the port against sequential at 1e-5 (both in f32).
"""

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.distributed.meta_parallel import PipelineLayer as JPipelineLayer
from paddle_tpu.distributed.meta_parallel import PipelineParallel as JPipelineParallel
from paddle_tpu.distributed.meta_parallel import (
    PipelineParallelWithInterleave as JPipelineParallelWithInterleave)

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed import (GPipeLayers, OneFOneBLayers, gpipe_spmd_step,
                                          make_1f1b_schedule, schedule_efficiency, topology)
from paddle_tpu_torch.distributed.meta_parallel import (LayerDesc, PipelineLayer,
                                                        PipelineParallel,
                                                        PipelineParallelWithInterleave,
                                                        SharedLayerDesc)

torch.set_num_threads(1)


def _mse(out, y):
    return torch.nn.functional.mse_loss(out, y)


def _jmse(out, y):
    return JF.mse_loss(out, y)


def jax_blocks(n, width, seed=0):
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(n):
        blk = jnn.Sequential(jnn.Linear(width, width), jnn.Tanh())
        blk[0].weight.set_value(rng.standard_normal((width, width)).astype(np.float32) * 0.3)
        blk[0].bias.set_value(rng.standard_normal((width,)).astype(np.float32) * 0.1)
        blocks.append(blk)
    return blocks


def port_blocks(n, width, seed=0):
    out = []
    for jb in jax_blocks(n, width, seed):
        blk = torch.nn.Sequential(ptt.nn.Linear(width, width, device="cpu"), torch.nn.Tanh())
        load_numpy_state_dict(blk, {k: np.asarray(v.numpy()) for k, v in jb.state_dict().items()})
        out.append(blk)
    return out


def _pmesh(pp):
    return topology.build_mesh(pp=pp, devices=["cpu"] * pp)


def _jmesh(pp):
    return jtopo.build_mesh(pp=pp, devices=jax.devices()[:pp])


def _data(seed, rows=8, width=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, width)).astype(np.float32),
            rng.standard_normal((rows, width)).astype(np.float32))


def _sequential(blocks, x, y, m):
    """Loss and per-block grads of ``blocks`` run on each micro-batch in
    turn, each loss scaled by 1/m."""
    total = 0.0
    for mx, my in zip(np.split(x, m), np.split(y, m)):
        h = torch.from_numpy(mx)
        for b in blocks:
            h = b(h)
        loss = _mse(h, torch.from_numpy(my))
        (loss / m).backward()
        total += float(loss.detach()) / m
    return total


def _stacked_ref(eng, blocks, name):
    return np.stack([dict(b.named_parameters())[name].grad.numpy() for b in blocks])[
        eng._row_order]


# ---------------------------------------------------------------------------
# the host schedule


SCHEDULES = [(p, m, v) for p in (2, 4) for m in (2, 4, 8) for v in (1, 2)]


@pytest.mark.parametrize("p,m,v", SCHEDULES, ids=[f"p{p}m{m}v{v}" for p, m, v in SCHEDULES])
def test_schedule_tables_equal_the_reference(p, m, v):
    if v > 1 and m % p:
        for build in (make_1f1b_schedule, jdist.make_1f1b_schedule):
            with pytest.raises(ValueError, match="multiple of the pipe degree"):
                build(p, m, v)
        return
    got, want = make_1f1b_schedule(p, m, v), jdist.make_1f1b_schedule(p, m, v)
    assert sorted(got["tables"]) == sorted(want["tables"])
    for k in want["tables"]:
        np.testing.assert_array_equal(got["tables"][k], want["tables"][k], err_msg=k)
    for k in ("T", "Df", "Da", "Dg", "busy_micro_steps", "events", "tick_f", "tick_b"):
        assert got[k] == want[k], k
    for bwd in (2.0, 3.0):
        assert schedule_efficiency(got, bwd) == jdist.schedule_efficiency(want, bwd)


def test_schedule_efficiency_and_bound():
    s = make_1f1b_schedule(4, 8, 1)
    assert 0.5 < schedule_efficiency(s) < 1.0
    assert schedule_efficiency(make_1f1b_schedule(4, 16, 1)) > \
        schedule_efficiency(make_1f1b_schedule(4, 4, 1))
    s = make_1f1b_schedule(4, 4, 2)
    assert s["busy_micro_steps"] == 2 * 4 * 4 * 2 < 2 * 4 * 2 * (4 + 4 - 1)
    assert s["Da"] <= 2 * 4 * 2


# ---------------------------------------------------------------------------
# the engines


class TestGPipe:
    def test_forward_and_grads_against_reference_and_sequential(self):
        x, _ = _data(2, rows=4)
        jgp = jdist.GPipeLayers(jax_blocks(4, 16), _jmesh(2), num_microbatches=2)
        jx = paddle.to_tensor(x, stop_gradient=False)
        jout = jgp(jx)
        (jout * jout).mean().backward()
        gp = GPipeLayers(port_blocks(4, 16), _pmesh(2), num_microbatches=2)
        out = gp(torch.from_numpy(x))
        (out * out).mean().backward()
        np.testing.assert_allclose(out.detach().numpy(), jout.numpy(), rtol=1e-4, atol=1e-5)
        ref = port_blocks(4, 16)
        h = torch.from_numpy(x)
        for b in ref:
            h = b(h)
        (h * h).mean().backward()
        torch.testing.assert_close(out, h, rtol=1e-5, atol=1e-6)
        for name in gp._stack_names:
            got = gp._parameters[name.replace(".", "__")].grad.numpy()
            want = jgp._parameters[name.replace(".", "__")].grad.numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(got, np.stack([dict(b.named_parameters())[name].grad
                                                      .numpy() for b in ref]),
                                       rtol=1e-5, atol=1e-6)
        assert gp.segments_run == 2 * (2 + 2 - 1)       # P·(M+P-1), the bubble included

    def test_errors_and_builder(self):
        with pytest.raises(ValueError, match="not divisible by pipe degree"):
            GPipeLayers(port_blocks(3, 8), _pmesh(2), num_microbatches=2)
        gp = GPipeLayers(port_blocks(2, 8), _pmesh(2), num_microbatches=3)
        with pytest.raises(ValueError, match="not divisible by"):
            gp(torch.zeros(4, 8))
        gp = gpipe_spmd_step(port_blocks(2, 8), _pmesh(2), num_microbatches=2)
        assert isinstance(gp, GPipeLayers) and tuple(gp(torch.ones(4, 8)).shape) == (4, 8)


class TestOneFOneB:
    @pytest.mark.parametrize("v,recompute", [(1, True), (2, False)])
    def test_against_reference(self, v, recompute):
        x, y = _data(1)
        jeng = jdist.OneFOneBLayers(jax_blocks(4, 16), _jmesh(2), num_microbatches=4,
                                    loss_fn=_jmse, num_virtual_stages=v, recompute=recompute)
        jloss, jgrads = jeng.loss_and_grads(paddle.to_tensor(x), paddle.to_tensor(y))
        eng = OneFOneBLayers(port_blocks(4, 16), _pmesh(2), num_microbatches=4, loss_fn=_mse,
                             num_virtual_stages=v, recompute=recompute)
        loss, grads = eng.loss_and_grads(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(jloss.numpy()), rtol=1e-5)
        np.testing.assert_array_equal(eng._row_order, jeng._row_order)
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("p,v,n_layers", [(2, 1, 4), (2, 2, 4), (4, 2, 8)])
    @pytest.mark.parametrize("recompute", [True, False, "auto"])
    def test_against_sequential(self, p, v, n_layers, recompute):
        x, y = _data(5, width=8)
        eng = OneFOneBLayers(port_blocks(n_layers, 8, seed=3), _pmesh(p), num_microbatches=4,
                             loss_fn=_mse, num_virtual_stages=v, recompute=recompute)
        loss, grads = eng.loss_and_grads(torch.from_numpy(x), torch.from_numpy(y))
        ref = port_blocks(n_layers, 8, seed=3)
        want = _sequential(ref, x, y, 4)
        assert abs(float(loss) - want) <= 1e-5 * abs(want)
        for k, name in enumerate(eng._stack_names):
            np.testing.assert_allclose(grads[k].numpy(), _stacked_ref(eng, ref, name),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        stash = next(iter(eng.stash_by_key.values()))
        assert stash == (recompute is not True)
        assert eng.segments_run == p * 4 * v                       # P·M·v
        assert eng.segments_recomputed == (0 if stash else p * 4 * v)

    def test_auto_budget_and_errors(self):
        x, y = _data(23, rows=4, width=8)
        eng = OneFOneBLayers(port_blocks(2, 8, seed=19), _pmesh(2), 2, _mse,
                             stash_budget_bytes=0)
        eng.loss_and_grads(torch.from_numpy(x), torch.from_numpy(y))
        assert next(iter(eng.stash_by_key.values())) is False
        eng = OneFOneBLayers(port_blocks(2, 8, seed=19), _pmesh(2), 2, _mse)
        eng.loss_and_grads(torch.from_numpy(x), torch.from_numpy(y))
        assert next(iter(eng.stash_by_key.values())) is True
        assert eng._residual_bytes(torch.from_numpy(x)) > 0
        with pytest.raises(ValueError, match="recompute"):
            OneFOneBLayers(port_blocks(2, 8), _pmesh(2), 2, _mse, recompute="sometimes")
        with pytest.raises(ValueError, match="not divisible by pipe"):
            OneFOneBLayers(port_blocks(3, 8), _pmesh(2), 2, _mse)

    def test_forward_global_order_and_train_batch(self):
        x, y = _data(7)
        eng = OneFOneBLayers(port_blocks(4, 16, seed=9), _pmesh(2), num_microbatches=4,
                             loss_fn=_mse, num_virtual_stages=2)
        h = torch.from_numpy(x)
        for b in port_blocks(4, 16, seed=9):
            h = b(h)
        torch.testing.assert_close(eng(torch.from_numpy(x)), h, rtol=1e-5, atol=1e-6)
        opt = ptt.optimizer.AdamW(0.05, parameters=list(eng.parameters()))
        losses = [float(eng.train_batch((torch.from_numpy(x), torch.from_numpy(y)), opt))
                  for _ in range(4)]
        assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# the host runtimes


class TestHostRuntimes:
    def test_static_scheduler_against_reference(self):
        for acc in (2, 4, 6):
            pp = PipelineParallel(PipelineLayer([torch.nn.Linear(4, 4) for _ in range(4)],
                                                num_stages=4, loss_fn=_mse),
                                  accumulate_steps=acc)
            jpp = JPipelineParallel(JPipelineLayer([jnn.Linear(4, 4) for _ in range(4)],
                                                   num_stages=4, loss_fn=_jmse),
                                    accumulate_steps=acc)
            for s in range(4):
                assert pp.static_scheduler(s) == jpp.static_scheduler(s)
        assert pp.static_scheduler(3) == "f0;b0;f1;b1;f2;b2;f3;b3;f4;b4;f5;b5;"

    def test_interleave_scheduler_against_reference(self):
        for acc, p, v in ((4, 2, 2), (8, 2, 2), (4, 4, 2), (6, 2, 3)):
            n = p * v * 2
            vpp = PipelineParallelWithInterleave(
                PipelineLayer([torch.nn.Linear(4, 4) for _ in range(n)], num_stages=p,
                              num_virtual_pipeline_stages=v, loss_fn=_mse),
                accumulate_steps=acc)
            jvpp = JPipelineParallelWithInterleave(
                JPipelineLayer([jnn.Linear(4, 4) for _ in range(n)], num_stages=p,
                               num_virtual_pipeline_stages=v, loss_fn=_jmse),
                accumulate_steps=acc)
            for s in range(p):
                assert vpp.interleave_scheduler(s) == jvpp.interleave_scheduler(s)
                assert vpp._num_warmup(s) == jvpp._num_warmup(s)

    @pytest.mark.parametrize("v", [1, 2])
    def test_losses_and_grads_against_sequential_and_1f1b(self, v):
        x, y = _data(13, width=12)
        blocks = port_blocks(4, 12, seed=11)
        pl = PipelineLayer(blocks, num_stages=2, num_virtual_pipeline_stages=v, loss_fn=_mse)
        host = (PipelineParallelWithInterleave if v > 1 else PipelineParallel)(
            pl, accumulate_steps=4)
        loss = host.forward_backward_pipeline(torch.from_numpy(x), torch.from_numpy(y))
        ref = port_blocks(4, 12, seed=11)
        want = _sequential(ref, x, y, 4)
        assert abs(float(loss) - want) <= 1e-5 * abs(want)
        for b, r in zip(blocks, ref):
            for p, q in zip(b.parameters(), r.parameters()):
                torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-6)
        eng = OneFOneBLayers(port_blocks(4, 12, seed=11), _pmesh(2), num_microbatches=4,
                             loss_fn=_mse, num_virtual_stages=v)
        eloss, _ = eng.loss_and_grads(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(eloss), float(loss), rtol=1e-5)

    def test_train_batch_against_reference(self):
        x, y = _data(17, width=8)
        pl = PipelineLayer([LayerDesc(ptt.nn.Linear, 8, 8, device="cpu"),
                            LayerDesc(torch.nn.Tanh), LayerDesc(ptt.nn.Linear, 8, 8, device="cpu"),
                            LayerDesc(ptt.nn.Linear, 8, 8, device="cpu")],
                           num_stages=2, loss_fn=_mse)
        paddle.seed(0)
        jpl = JPipelineLayer([jnn.Linear(8, 8), jnn.Tanh(), jnn.Linear(8, 8), jnn.Linear(8, 8)],
                             num_stages=2, loss_fn=_jmse)
        load_numpy_state_dict(pl, {k: np.asarray(v.numpy())
                                   for k, v in jpl.state_dict().items()})
        pp = PipelineParallel(pl, accumulate_steps=2)
        jpp = JPipelineParallel(jpl, accumulate_steps=2)
        opt = ptt.optimizer.AdamW(5e-3, parameters=list(pl.parameters()))
        jopt = paddle.optimizer.AdamW(5e-3, parameters=jpl.parameters())
        got = [float(pp.train_batch((torch.from_numpy(x), torch.from_numpy(y)), opt))
               for _ in range(5)]
        want = [float(jpp.train_batch((paddle.to_tensor(x), paddle.to_tensor(y)), jopt).numpy())
                for _ in range(5)]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got[-1] < got[0]
        np.testing.assert_allclose(float(pp.eval_batch((torch.from_numpy(x),
                                                        torch.from_numpy(y)))),
                                   float(jpp.eval_batch((paddle.to_tensor(x),
                                                         paddle.to_tensor(y))).numpy()),
                                   rtol=1e-5)

    def test_shared_layer_desc_ties_weights(self):
        pipe = PipelineLayer([SharedLayerDesc("emb", torch.nn.Linear, None, "weight", 4, 4),
                              torch.nn.Tanh(),
                              SharedLayerDesc("emb", torch.nn.Linear, None, "weight", 4, 4)],
                             num_stages=1)
        first, last = pipe.get_stage_layers(0)[0].shared, pipe.get_stage_layers(0)[2].shared
        assert first is last and set(pipe.shared_layers()) == {"emb"}
        assert len(list(pipe.parameters())) == 2
        pipe(torch.ones(2, 4)).sum().backward()
        assert first.weight.grad is not None       # both uses add into the one grad

    def test_seg_method_and_chunks(self):
        for layers, kw, parts in (
                ([torch.nn.Linear(4, 4), torch.nn.Tanh(), torch.nn.Linear(4, 4),
                  torch.nn.Tanh()], dict(num_stages=2, seg_method="layer:Linear"), [0, 2, 4]),
                ([torch.nn.Linear(4, 4) for _ in range(5)], dict(num_stages=2), [0, 3, 5])):
            assert PipelineLayer(layers, **kw).segment_parts == parts
        jparts = JPipelineLayer([jnn.Linear(4, 4) for _ in range(5)], num_stages=2).segment_parts
        assert jparts == [0, 3, 5]
        layers = [torch.nn.Linear(4, 4) for _ in range(8)]
        pl = PipelineLayer(layers, num_stages=2, num_virtual_pipeline_stages=2)
        assert pl.get_chunk_layers(1, 0) == layers[2:4] and pl.get_chunk_layers(0, 1) == \
            layers[4:6]
        with pytest.raises(RuntimeError, match="non-contiguous"):
            pl.get_stage_layers(0)
        with pytest.raises(ValueError, match="num_virtual_pipeline_stages"):
            PipelineParallelWithInterleave(PipelineLayer(layers, num_stages=2))
        with pytest.raises(TypeError, match="PipelineLayer"):
            PipelineParallel(torch.nn.Linear(4, 4))
