"""The port's distributed process layer (``paddle_tpu_torch.distributed``:
``communication``, ``topology``'s data axis, ``DataParallel`` and
``CommWatchdog``) held against the JAX package on the CPU.

The JAX package runs on its 8 forced CPU devices, on a dp 2 × sharding 2
× model 2 hybrid mesh (the layout of the ``mesh_222`` / ``mesh_22``
fixtures of ``test_distributed.py`` and ``test_dist_semantics.py``); the
port runs single-controller on a :class:`Mesh` of 8 repeated ``cpu``
members of the same layout.  Both get the same numpy stacks, and every
collective and P2P case of ``test_distributed.py::TestCollectives`` and
``test_dist_semantics.py::TestP2P`` is run through both packages and
compared (f32: rtol 1e-6; results of exact arithmetic exactly).  The
multi-process mode runs in ``test_torch_launch.py``.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import communication as jcomm
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTForCausalLM, LlamaForCausalLM, gpt_tiny, llama_tiny
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

F32 = dict(rtol=1e-6, atol=1e-6)
GROUPS = {"data": ("data",), "sharding": ("sharding",), "model": ("model",),
          "data_sharding": ("data", "sharding"), "global": topology._HYBRID_AXES}


@pytest.fixture(scope="module")
def meshes():
    """(JAX hybrid group, port hybrid group) of the dp 2 × sharding 2 ×
    model 2 layout, each set as its package's hybrid group for the
    module and the earlier one restored after."""
    saved = (jtopo.get_hybrid_communicate_group(), topology.get_hybrid_communicate_group())
    jhcg = jtopo.HybridCommunicateGroup(dp=2, sharding=2, mp=2)
    members = np.empty(8, dtype=object)
    members[:] = [torch.device("cpu")] * 8
    thcg = topology.HybridCommunicateGroup(
        mesh=topology.Mesh(members.reshape(2, 1, 2, 1, 2), topology._HYBRID_AXES))
    jtopo.set_hybrid_communicate_group(jhcg)
    topology.set_hybrid_communicate_group(thcg)
    yield jhcg, thcg
    jtopo.set_hybrid_communicate_group(saved[0])
    topology.set_hybrid_communicate_group(saved[1])


@pytest.fixture(autouse=True)
def no_pending_sends():
    jcomm.clear_pending_p2p()
    comm.clear_pending_p2p()
    yield
    jcomm.clear_pending_p2p()
    comm.clear_pending_p2p()


def groups(meshes, name):
    jhcg, thcg = meshes
    axes = GROUPS[name]
    return jtopo.CommGroup(jhcg.mesh, axes), topology.CommGroup(thcg.mesh, axes)


def stack(shape, seed, positive=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.5, 2.0, shape) if positive else rng.standard_normal(shape)
    return x.astype(np.float32)


def both(meshes, name, data):
    """The same numpy stack laid out by both packages' scatter_stack."""
    jg, tg = groups(meshes, name)
    return (jg, jcomm.scatter_stack(paddle.to_tensor(data), jg),
            tg, comm.scatter_stack(data, tg))


def close(got, want, tol=F32):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


class TestCollectives:
    """``test_distributed.py::TestCollectives``, case by case, through both
    packages (with its own expected values), then every op over every
    group on random stacks."""

    def test_all_reduce_sum_and_avg(self, meshes):
        for op, want in ((comm.ReduceOp.SUM, [4.0, 4.0]), (comm.ReduceOp.AVG, [2.0, 2.0])):
            jg, jx, tg, tx = both(meshes, "data", np.array([[1.0], [3.0]], "float32"))
            jcomm.all_reduce(jx, op=op, group=jg)
            out = comm.all_reduce(tx, op=op, group=tg)
            assert out is tx
            close(tx.ravel(), want)
            close(tx, jx.numpy())

    def test_all_gather(self, meshes):
        jg, jx, tg, tx = both(meshes, "model", np.arange(2, dtype="float32")[:, None])
        jout, out = jcomm.all_gather(jx, group=jg), comm.all_gather(tx, group=tg)
        assert list(out.shape) == jout.shape == [4, 1]
        close(out, jout.numpy())

    def test_reduce_scatter(self, meshes):
        jg, jx, tg, tx = both(meshes, "data", np.ones((4, 1), "float32"))
        jout, out = jcomm.reduce_scatter(jx, group=jg), comm.reduce_scatter(tx, group=tg)
        assert list(out.shape) == jout.shape == [2, 1]
        close(out.ravel(), [2.0, 2.0])
        close(out, jout.numpy())

    def test_all_to_all(self, meshes):
        jg, jx, tg, tx = both(meshes, "data", np.arange(8, dtype="float32").reshape(4, 2))
        jout, out = jcomm.all_to_all(jx, group=jg), comm.all_to_all(tx, group=tg)
        close(out, np.array([[0, 1], [4, 5], [2, 3], [6, 7]], "float32"))
        close(out, jout.numpy())

    def test_broadcast(self, meshes):
        jg, jx, tg, tx = both(meshes, "sharding", np.array([[5.0], [9.0]], "float32"))
        jcomm.broadcast(jx, src=1, group=jg)
        comm.broadcast(tx, src=1, group=tg)
        close(tx.ravel(), [9.0, 9.0])
        close(tx, jx.numpy())

    def test_new_group_axes(self, meshes):
        assert jcomm.new_group(axes=("data", "sharding")).nranks == 4
        assert comm.new_group(axes=("data", "sharding")).nranks == 4

    def test_arbitrary_ranks_rejected(self, meshes):
        for package in (jcomm, comm):
            with pytest.raises(ValueError):
                package.new_group(ranks=[0, 3])
        assert comm.new_group(ranks=list(range(8))).nranks == 8

    @pytest.mark.parametrize("name", list(GROUPS))
    @pytest.mark.parametrize("op", ["sum", "avg", "max", "min", "prod"])
    def test_all_reduce_matches_reference(self, meshes, name, op):
        n = int(np.prod([meshes[1].mesh.shape[a] for a in GROUPS[name]]))
        data = stack((2 * n, 3), seed=len(name) + len(op), positive=op == "prod")
        jg, jx, tg, tx = both(meshes, name, data)
        jcomm.all_reduce(jx, op=op, group=jg)
        comm.all_reduce(tx, op=op, group=tg)
        close(tx, jx.numpy())

    @pytest.mark.parametrize("name", list(GROUPS))
    def test_all_gather_reduce_scatter_all_to_all_match_reference(self, meshes, name):
        n = int(np.prod([meshes[1].mesh.shape[a] for a in GROUPS[name]]))
        data = stack((n * n * 2, 3), seed=n)
        jg, jx, tg, tx = both(meshes, name, data)
        close(comm.all_gather(tx, group=tg), jcomm.all_gather(jx, group=jg).numpy())
        close(comm.reduce_scatter(tx, group=tg), jcomm.reduce_scatter(jx, group=jg).numpy())
        close(comm.all_to_all(tx, group=tg), jcomm.all_to_all(jx, group=jg).numpy())
        # all_gather's list form: the reference's n views of the stack
        jl, tl = jcomm.all_gather([], jx, group=jg), comm.all_gather([], tx, group=tg)
        assert len(tl) == len(jl) == n
        for t, j in zip(tl, jl):
            close(t, j.numpy())

    @pytest.mark.parametrize("name", ["data", "data_sharding", "global"])
    @pytest.mark.parametrize("src", [0, 1])
    def test_broadcast_reduce_scatter_ppermute_match_reference(self, meshes, name, src):
        n = int(np.prod([meshes[1].mesh.shape[a] for a in GROUPS[name]]))
        data = stack((n, 4), seed=7 + src)
        jg, jx, tg, tx = both(meshes, name, data)
        jcomm.broadcast(jx, src=src, group=jg)
        comm.broadcast(tx, src=src, group=tg)
        close(tx, jx.numpy())
        jg, jx, tg, tx = both(meshes, name, data)
        jcomm.reduce(jx, dst=src, group=jg)
        comm.reduce(tx, dst=src, group=tg)
        close(tx, jx.numpy())
        parts = [data[i:i + 1] for i in range(n)]
        close(comm.scatter(None, [torch.from_numpy(p) for p in parts], src=src, group=tg),
              jcomm.scatter(None, [paddle.to_tensor(p) for p in parts], src=src,
                            group=jg).numpy())
        perm = [(i, (i + 1 + src) % n) for i in range(n - 1)]   # member 0 or 1 gets zeros
        close(comm.ppermute(tx, perm, group=tg), jcomm.ppermute(jx, perm, group=jg).numpy())

    def test_coalesced_reduce_scatter_matches_reference(self, meshes):
        jg, _, tg, _ = both(meshes, "data", np.zeros((2, 1), "float32"))
        arrays = [stack((4, 3), 4), stack((2, 5), 5), stack((6,), 6),
                  stack((2, 2), 7).astype(np.float64)]
        jout = jcomm.coalesced_reduce_scatter(
            [jcomm.scatter_stack(paddle.to_tensor(a), jg) for a in arrays], group=jg,
            bucket_bytes=40)
        out = comm.coalesced_reduce_scatter([comm.scatter_stack(a, tg) for a in arrays],
                                            group=tg, bucket_bytes=40)
        for t, j, a in zip(out, jout, arrays):
            close(t, j.numpy())
            close(t, a[:a.shape[0] // 2] + a[a.shape[0] // 2:])

    def test_buckets_follow_the_reference_plan(self):
        from paddle_tpu.distributed.overlap.bucketer import GradientBucketer

        sizes = [40, 8, 24, 100, 8, 8, 16]
        keys = ["f32", "f32", "bf16", "f32", "f32", "bf16", "bf16"]
        for target in (0, 16, 32, 64, 1 << 20):
            want = GradientBucketer(sizes, bucket_bytes=target, keys=keys).buckets
            assert comm._plan_buckets(sizes, keys, target) == want

    def test_barrier_and_wait(self, meshes):
        comm.barrier(groups(meshes, "global")[1])
        comm.wait(torch.zeros(2))

    def test_in_place_on_a_strided_stack(self, meshes):
        """all_reduce and broadcast write a non-contiguous stack in place."""
        _, tg = groups(meshes, "data")
        data = stack((3, 4), 11)
        for call, want in ((lambda x: comm.all_reduce(x, group=tg),
                            np.tile(data.T[:2] + data.T[2:], (2, 1))),
                           (lambda x: comm.broadcast(x, src=1, group=tg),
                            np.tile(data.T[2:], (2, 1)))):
            x = torch.from_numpy(data.copy()).t()
            assert not x.is_contiguous() and call(x) is x
            close(x, want)

    def test_avg_of_integers_raises(self, meshes):
        _, _, tg, tx = both(meshes, "data", np.array([[1], [2]], "int64"))
        with pytest.raises(TypeError, match="floating"):
            comm.all_reduce(tx, op=comm.ReduceOp.AVG, group=tg)


class TestP2P:
    """``test_dist_semantics.py::TestP2P``, through both packages."""

    @staticmethod
    def run_both(meshes, fn):
        """``fn(comm_module, to_tensor, group_of, numpy_of)`` in both
        packages; their results as numpy arrays."""
        jhcg, thcg = meshes
        jout = fn(jcomm, paddle.to_tensor,
                  lambda axes: jtopo.CommGroup(jhcg.mesh, axes), lambda t: t.numpy())
        tout = fn(comm, torch.from_numpy,
                  lambda axes: topology.CommGroup(thcg.mesh, axes), lambda t: t.numpy())
        return jout, tout

    def test_send_recv_pair_moves_slice(self, meshes):
        def fn(c, tt, group_of, npy):
            g = group_of(("data",))
            x = c.scatter_stack(tt(np.array([[10.0], [20.0]], "float32")), g)
            buf = c.scatter_stack(tt(np.zeros((2, 1), "float32")), g)
            c.send(x, dst=g.rank + 1, group=g)
            c.recv(buf, src=(g.rank - 1) % g.nranks, group=g)
            return npy(buf)

        jout, tout = self.run_both(meshes, fn)
        close(tout.ravel(), [20.0, 10.0])
        close(tout, jout)

    def test_recv_without_send_raises(self, meshes):
        for c, tt, g in ((jcomm, paddle.to_tensor, groups(meshes, "data")[0]),
                         (comm, torch.from_numpy, groups(meshes, "data")[1])):
            buf = c.scatter_stack(tt(np.zeros((2, 1), "float32")), g)
            with pytest.raises(RuntimeError, match="no matching send"):
                c.recv(buf, src=1, group=g)

    def test_batch_isend_irecv_ring(self, meshes):
        vals = np.arange(4, dtype=np.float32)[:, None]

        def fn(c, tt, group_of, npy):
            g = group_of(("data", "sharding"))
            x = c.scatter_stack(tt(vals), g)
            buf = c.scatter_stack(tt(np.zeros((4, 1), "float32")), g)
            tasks = c.batch_isend_irecv([c.P2POp(c.isend, x, peer=1, group=g),
                                         c.P2POp(c.irecv, buf, peer=3, group=g)])
            for t in tasks:
                t.wait()
            return npy(buf)

        jout, tout = self.run_both(meshes, fn)
        close(tout.ravel(), np.roll(vals.ravel(), 1))
        close(tout, jout)

    def test_batch_unmatched_recv_raises(self, meshes):
        for c, tt, g in ((jcomm, paddle.to_tensor, groups(meshes, "data")[0]),
                         (comm, torch.from_numpy, groups(meshes, "data")[1])):
            buf = c.scatter_stack(tt(np.zeros((2, 1), "float32")), g)
            with pytest.raises(RuntimeError, match="no matching isend"):
                c.batch_isend_irecv([c.P2POp(c.irecv, buf, peer=1, group=g)])

    def test_send_snapshots_value(self, meshes):
        def fn(c, tt, group_of, npy):
            g = group_of(("data",))
            x = c.scatter_stack(tt(np.array([[7.0], [5.0]], "float32")), g)
            buf = c.scatter_stack(tt(np.zeros((2, 1), "float32")), g)
            c.send(x, dst=g.rank + 1, group=g)
            if c is comm:
                x.zero_()
            else:
                x._rebind(paddle.to_tensor(np.zeros((2, 1), "float32")))
            c.recv(buf, src=(g.rank - 1) % g.nranks, group=g)
            return npy(buf)

        jout, tout = self.run_both(meshes, fn)
        close(tout.ravel(), [5.0, 7.0])
        close(tout, jout)

    def test_batch_unmatched_isend_stages_for_later_recv(self, meshes):
        def fn(c, tt, group_of, npy):
            g = group_of(("data",))
            x = c.scatter_stack(tt(np.array([[1.0], [2.0]], "float32")), g)
            c.batch_isend_irecv([c.P2POp(c.isend, x, peer=g.rank + 1, group=g)])
            buf = c.scatter_stack(tt(np.zeros((2, 1), "float32")), g)
            c.recv(buf, src=(g.rank - 1) % g.nranks, group=g)
            return npy(buf)

        jout, tout = self.run_both(meshes, fn)
        close(tout.ravel(), [2.0, 1.0])
        close(tout, jout)

    def test_group_mismatch_in_batch_raises(self, meshes):
        for c, tt, (g1, g2) in (
                (jcomm, paddle.to_tensor, (groups(meshes, "data")[0], groups(meshes, "model")[0])),
                (comm, torch.from_numpy, (groups(meshes, "data")[1], groups(meshes, "model")[1]))):
            x = c.scatter_stack(tt(np.zeros((2, 1), "float32")), g1)
            y = c.scatter_stack(tt(np.zeros((2, 1), "float32")), g2)
            with pytest.raises(ValueError, match="share one group"):
                c.batch_isend_irecv([c.P2POp(c.isend, x, 1, g1), c.P2POp(c.irecv, y, 1, g2)])

    def test_unbatched_send_batched_recv(self, meshes):
        def fn(c, tt, group_of, npy):
            g = group_of(("data",))
            x = c.scatter_stack(tt(np.array([[4.0], [6.0]], "float32")), g)
            buf = c.scatter_stack(tt(np.zeros((2, 1), "float32")), g)
            c.send(x, dst=g.rank + 1, group=g)
            c.batch_isend_irecv([c.P2POp(c.irecv, buf, peer=(g.rank - 1) % g.nranks,
                                         group=g)])
            return npy(buf)

        jout, tout = self.run_both(meshes, fn)
        close(tout.ravel(), [6.0, 4.0])
        close(tout, jout)

    @pytest.mark.parametrize("offset", [1, 2, 3])
    def test_ring_offsets_match_reference(self, meshes, offset):
        vals = stack((4, 2), offset)

        def fn(c, tt, group_of, npy):
            g = group_of(("data", "sharding"))
            x = c.scatter_stack(tt(vals), g)
            buf = c.scatter_stack(tt(np.zeros((4, 2), "float32")), g)
            c.isend(x, dst=offset, group=g)
            c.irecv(buf, src=-offset % 4, group=g).wait()
            return npy(buf)

        jout, tout = self.run_both(meshes, fn)
        close(tout, np.roll(vals, offset, axis=0))
        close(tout, jout)


class TestTopology:
    def test_data_axis_accessors(self):
        mesh = topology.build_mesh(dp=4, devices=["cpu"] * 4)
        hcg = topology.HybridCommunicateGroup(mesh=mesh)
        assert hcg.get_data_parallel_world_size() == 4
        assert hcg.get_data_parallel_group().nranks == 4
        assert hcg.get_data_parallel_rank() == 0
        assert hcg.get_global_group().nranks == 4
        assert mesh.procs is None and hcg.get_data_parallel_group().rank == 0

    def test_multi_process_mesh_places_this_process(self, monkeypatch):
        members = np.empty(4, dtype=object)
        members[:] = [torch.device("cpu")] * 4
        procs = np.arange(4).reshape(2, 1, 1, 2, 1)
        mesh = topology.Mesh(members.reshape(2, 1, 1, 2, 1), topology._HYBRID_AXES, procs)
        monkeypatch.setattr(topology, "process_rank", lambda: 3)
        assert topology.process_mesh_coords(mesh) == dict(data=1, pipe=0, sharding=0,
                                                          sep=1, model=0)
        assert topology.CommGroup(mesh, ("data",)).rank == 1
        assert topology.CommGroup(mesh, ("data", "sep")).rank == 3


def _pair(kind, seed, amp, **kw):
    """The same tiny model in both packages, with the same weights, after
    one backward of the same batch (AMP O2 in both when ``amp``)."""
    paddle.seed(seed)
    jm = (JaxLlama(jax_llama_tiny(**kw)) if kind == "llama" else JaxGPT(jax_gpt_tiny(**kw)))
    tm = (LlamaForCausalLM(llama_tiny(**kw), device="cpu") if kind == "llama"
          else GPTForCausalLM(gpt_tiny(**kw), device="cpu"))
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    if amp:
        jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        tm = ptt.amp.decorate(tm, level="O2", dtype="bfloat16")
    ids = np.random.default_rng(seed).integers(1, 256, (2, 16)).astype(np.int32)
    jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))[0].backward()
    tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))[0].backward()
    return jm, tm


class TestDataParallel:
    @pytest.mark.parametrize("kind,amp", [("llama", False), ("gpt", False), ("gpt", True)])
    @pytest.mark.parametrize("mb", [0, 1])
    def test_grad_buckets_match_reference(self, kind, amp, mb):
        """The same parameter names and byte sizes, bucket by bucket
        (per gradient dtype, reverse parameter order, ``mb`` MB each)."""
        # wide enough (2 MB of embedding, 0.5 MB matrices) for 1 MB buckets
        jm, tm = _pair(kind, 3, amp, vocab_size=2048, hidden_size=256,
                       intermediate_size=512)

        def plan(dp, named):
            name_of = {id(p): n for n, p in named}
            return [[(name_of[id(p)], int(np.prod(p.shape)) * dtype_bytes(p)) for p in b]
                    for b in dp._grad_buckets()]

        def dtype_bytes(p):
            return p.grad.element_size() if isinstance(p, torch.Tensor) else \
                np.dtype(p._grad._value.dtype).itemsize

        want = plan(jdist.DataParallel(jm, comm_buffer_size=mb), jm.named_parameters())
        got = plan(dist.DataParallel(tm, comm_buffer_size=mb), tm.named_parameters())
        assert got == want
        assert len(got) > (4 if mb else 10)

    def test_state_dict_keys_match_reference(self):
        jm, tm = _pair("llama", 4, False)
        jdp, tdp = jdist.DataParallel(jm), dist.DataParallel(tm)
        assert list(tdp.state_dict()) == list(tm.state_dict())
        assert sorted(tdp.state_dict()) == sorted(jdp.state_dict())
        assert not any(k.startswith("_layers.") for k in tdp.state_dict())
        fresh = dist.DataParallel(LlamaForCausalLM(llama_tiny(), device="cpu", seed=9))
        fresh.set_state_dict(tdp.state_dict())
        for k, v in tm.state_dict().items():
            torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)

    def test_is_a_layer_as_in_the_reference(self):
        """C5: DataParallel is an ``nn.Layer`` in both packages, so the
        Layer methods answer as the reference's do on
        ``DataParallel(Sequential(Linear(2, 2), Linear(2, 2)))``."""
        import paddle_tpu.nn as jnn

        ptt.set_device("cpu")
        try:
            got = dist.DataParallel(ptt.nn.Sequential(ptt.nn.Linear(2, 2), ptt.nn.Linear(2, 2)))
        finally:
            ptt.set_device(None)
        want = jdist.DataParallel(jnn.Sequential(jnn.Linear(2, 2), jnn.Linear(2, 2)))
        assert isinstance(got, ptt.nn.Layer)
        for dp in (got, want):
            assert len(dp.parameters(include_sublayers=False)) == 0
            assert len(list(dp.named_parameters(include_sublayers=False))) == 0
            assert len(dp.sublayers()) == 3
            assert len(dp.parameters()) == 4
            dp.clear_gradients()
        assert [n for n, _ in got.named_sublayers()] == [n for n, _ in want.named_sublayers()]
        assert sorted(got.state_dict()) == sorted(want.state_dict())
        assert got.full_name().startswith("dataparallel")
        for name in ("add_sublayer", "add_parameter", "create_parameter", "set_dict",
                     "load_dict", "astype", "register_forward_post_hook"):
            assert callable(getattr(got, name)), name
        state = {k: np.full(tuple(v.shape), 0.5, np.float32) for k, v in got.state_dict().items()}
        got.set_dict(state)
        assert all(bool((v == 0.5).all()) for v in got.state_dict().values())

    def test_forward_passthrough_and_one_process_sync(self):
        inner = ptt.nn.Linear(4, 4, device="cpu")
        dp = dist.DataParallel(inner)
        x = torch.rand(2, 4)
        torch.testing.assert_close(dp(x), inner(x), rtol=0, atol=0)
        dp(x).sum().backward()
        before = inner.weight.grad.clone()
        dp.apply_collective_grads()       # one process: returns at once
        torch.testing.assert_close(inner.weight.grad, before, rtol=0, atol=0)
        with pytest.raises(RuntimeError, match="init_parallel_env"):
            dp._sync_buckets()            # no process group to sync over

    def test_train_step_through_the_wrapper_equals_the_model(self):
        ids = np.random.default_rng(5).integers(1, 256, (2, 16)).astype(np.int32)
        losses = []
        for wrap in (False, True):
            m = LlamaForCausalLM(llama_tiny(), device="cpu", seed=5)
            opt = AdamW(1e-3, parameters=m.parameters())
            step = TrainStep(dist.DataParallel(m) if wrap else m,
                             lambda mm, x, y: mm(x, labels=y)[0], opt, donate=False)
            losses.append([float(step(ids, ids)) for _ in range(3)])
        assert losses[0] == losses[1] and losses[0][-1] < losses[0][0]


class TestParallelEnv:
    def test_without_a_process_group(self):
        assert dist.get_rank() == 0 and not dist.is_initialized()
        ptt.set_device("cpu")
        try:
            assert dist.get_world_size() == 1
            assert dist.ParallelEnv().nranks == 1
        finally:
            ptt.set_device(None)

    def test_fleet_store_waits_for_a7(self, monkeypatch):
        """An armed fault domain (ROADMAP A7b, ported) whose store cannot be
        reached fails loudly, before any process group exists."""
        monkeypatch.setenv("PADDLE_TPU_FLEET_STORE", "127.0.0.1:1")
        monkeypatch.setenv("PADDLE_TPU_HB_TTL", "0.3")
        with pytest.raises((OSError, TimeoutError, RuntimeError)):
            dist.init_parallel_env()
        assert not dist.is_initialized()
        assert not torch.distributed.is_initialized()

    def test_nccl_takes_one_rank_per_card(self, monkeypatch):
        from paddle_tpu_torch.distributed import parallel

        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setenv("PADDLE_NPROC_PER_NODE", "2")
        monkeypatch.setenv("PADDLE_LOCAL_RANK", "1")
        with pytest.raises(RuntimeError, match="one rank per card"):
            parallel._card_of_this_process()


class TestWatchdog:
    def test_fires_once_on_a_wedged_watch(self):
        fired = []
        wd = dist.CommWatchdog(timeout=0.2, on_timeout=fired.append, poll_interval=0.05)
        try:
            with wd.watch("wedged"):
                time.sleep(0.6)
        finally:
            wd.stop()
        assert [i["name"] for i in fired] == ["wedged"] and wd.timeout_count == 1
        assert fired[0]["elapsed"] >= 0.2 and "--- thread" in fired[0]["stacks"]
        # the flight recorder's dump (A8), its last event the hung watch
        with open(fired[0]["flight_recorder_dump"]) as f:
            last = json.load(f)["events"][-1]
        assert (last["kind"], last["name"]) == ("watchdog_timeout", "wedged")

    def test_silent_on_a_released_watch(self):
        fired = []
        wd = dist.CommWatchdog(timeout=0.5, on_timeout=fired.append, poll_interval=0.05)
        try:
            for _ in range(3):
                with wd.watch("quick"):
                    time.sleep(0.02)
            time.sleep(0.7)            # past the deadline of every released watch
        finally:
            wd.stop()
        assert fired == [] and wd.timeout_count == 0

    def test_poisons_its_fault_domain_first(self):
        order = []

        class Domain:
            rank = 2

            def poll_once(self):
                pass

            def poison(self, reason, culprit, detail):
                order.append(("poison", reason, culprit))

        wd = dist.CommWatchdog(timeout=0.1, poll_interval=0.05,
                               on_timeout=lambda info: order.append(("handler", info["poisoned"])))
        wd.attach_fault_domain(Domain())
        try:
            with wd.watch("hang"):
                deadline = time.time() + 5
                while len(order) < 2 and time.time() < deadline:
                    time.sleep(0.02)
        finally:
            wd.stop()
        assert order == [("poison", "watchdog_hang", 2), ("handler", True)]

    def test_current_domain_waits_for_a7(self):
        """``fault_domain="current"`` (ROADMAP A7b, ported) resolves the
        process-global domain at every tick: none set, nothing polled."""
        from paddle_tpu_torch.distributed.fleet import fault_domain

        assert fault_domain.current() is None
        wd = dist.CommWatchdog(fault_domain="current", poll_interval=0.01)
        try:
            assert wd._resolve_domain() is None
            wd.attach_fault_domain("current")
            assert wd.fault_domain == "current" and wd._resolve_domain() is None
        finally:
            wd.stop()

    def test_many_threads_watch_at_once(self):
        """More watching threads than cores: every watch disarms cleanly
        and none fires."""
        fired = []
        wd = dist.CommWatchdog(timeout=5.0, on_timeout=fired.append, poll_interval=0.01)

        def work():
            for _ in range(50):
                with wd.watch("w"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(32)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            wd.stop()
        assert not any(t.is_alive() for t in threads)
        assert fired == [] and wd._watches == {}
