"""The port's launch CLI and its multi-process mode on the CPU:
``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2`` over
gloo, mirroring the JAX package's ``test_launch_multiprocess.py``
(``_PAYLOAD``: a stacked all_reduce gives ``[4.]``; ``_DP_PAYLOAD``: the
bucketed gradient sync equals the analytic mean; a failing rank fails the
pod).  Beyond it, every collective and P2P call of each rank is held
against its rows of the single-controller result on a CPU mesh (which
``test_torch_distributed.py`` holds against the JAX package), and a
``DataParallel`` ``TrainStep`` on two half batches against one process on
the whole batch; the tensor-parallel layers (ROADMAP A6b) with each
process holding its shard, against one process on the whole weights; and
(A6c) ``fleet.init`` over the processes with ``DistributedTrainStep`` at
stages 0-2 and the collective-matmul ring across them.
Every launch has its own timeout of at most 120 s."""

import importlib
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from paddle_tpu_torch.distributed.launch import launch

ROOT = Path(__file__).resolve().parents[1]

_PREAMBLE = textwrap.dedent("""
    import os
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as tdist
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.distributed import topology

    ptt.set_device("cpu")
    env = dist.init_parallel_env()
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    assert tdist.get_backend() == "gloo" and tdist.get_world_size() == 2
    assert env.rank == rank == dist.get_rank() and env.world_size == 2
""")

# every payload that joined the process group leaves it before it exits: a
# gloo group still alive at interpreter exit can abort the process there
# ("terminate called without an active exception") after its checks passed
_EPILOGUE = textwrap.dedent("""
    tdist.barrier()
    tdist.destroy_process_group()
""")

_PAYLOAD = _PREAMBLE + textwrap.dedent("""
    hcg = dist.get_hybrid_communicate_group()
    g = hcg.get_data_parallel_group()
    assert g.rank == rank and hcg.get_data_parallel_rank() == rank
    assert hcg.get_data_parallel_world_size() == 2

    # cross-process all_reduce: slices [1.] and [3.] -> every slice 4.
    x = comm.scatter_stack(torch.tensor([[1.0], [3.0]]))
    comm.all_reduce(x)
    np.testing.assert_allclose(x.numpy().ravel(), [4.0])
    # all_gather: every process sees the full stack
    y = comm.scatter_stack(torch.tensor([[10.0], [20.0]]))
    np.testing.assert_allclose(comm.all_gather(y).numpy().ravel(), [10.0, 20.0])

    # every call against this rank's rows of the single-controller result
    sc = topology.CommGroup(topology.build_mesh(dp=2, devices=["cpu"] * 2), ("data",))

    def rows(t):
        return t.reshape(2, -1, *t.shape[1:])[rank]

    def check(got, want):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)

    data = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    for op in ("sum", "avg", "max", "min", "prod"):
        d = np.abs(data) + 0.5 if op == "prod" else data
        check(comm.all_reduce(comm.scatter_stack(d), op=op),
              rows(comm.all_reduce(comm.scatter_stack(d, sc), op=op, group=sc)))
        check(comm.reduce_scatter(comm.scatter_stack(d), op=op),
              rows(comm.reduce_scatter(comm.scatter_stack(d, sc), op=op, group=sc)))
    mine, whole = comm.scatter_stack(data), comm.scatter_stack(data, sc)
    check(comm.all_gather(mine), rows(comm.all_gather(whole, group=sc)))
    parts = comm.all_gather([], mine)
    check(parts[0], torch.from_numpy(data[:4]))
    check(parts[1], torch.from_numpy(data[4:]))
    check(comm.all_to_all(mine), rows(comm.all_to_all(whole, group=sc)))
    check(comm.broadcast(mine.clone(), src=1), rows(comm.broadcast(whole.clone(), 1, sc)))
    check(comm.reduce(mine.clone()), rows(comm.reduce(whole.clone(), group=sc)))
    chunks = [torch.from_numpy(data[:4]), torch.from_numpy(data[4:])]
    check(comm.scatter(None, chunks, src=1), rows(comm.scatter(None, chunks, 1, sc)))
    check(comm.ppermute(mine, [(0, 1)]), rows(comm.ppermute(whole, [(0, 1)], sc)))

    buf, sbuf = torch.zeros_like(mine), torch.zeros_like(whole)
    comm.send(mine, dst=g.rank + 1)
    comm.recv(buf, src=(g.rank - 1) % 2)
    comm.send(whole, dst=1, group=sc)
    comm.recv(sbuf, src=1, group=sc)
    check(buf, rows(sbuf))
    buf, sbuf = torch.zeros_like(mine), torch.zeros_like(whole)
    for task in comm.batch_isend_irecv([comm.P2POp(comm.isend, mine, (rank + 1) % 2),
                                        comm.P2POp(comm.irecv, buf, (rank + 1) % 2)]):
        task.wait()
    comm.batch_isend_irecv([comm.P2POp(comm.isend, whole, 1, sc),
                            comm.P2POp(comm.irecv, sbuf, 1, sc)])
    check(buf, rows(sbuf))
    try:
        comm.recv(buf, src=0)
        raise AssertionError("a recv without a send must raise")
    except RuntimeError as e:
        assert "no matching send" in str(e)

    others = [np.random.default_rng(s).standard_normal(shape).astype(np.float32)
              for s, shape in ((1, (8, 3)), (2, (4, 5)), (3, (12,)))]
    got = comm.coalesced_reduce_scatter([comm.scatter_stack(o) for o in others],
                                        bucket_bytes=64)
    want = comm.coalesced_reduce_scatter([comm.scatter_stack(o, sc) for o in others],
                                         group=sc, bucket_bytes=64)
    for a, b in zip(got, want):
        check(a, rows(b))
    comm.barrier()
    try:
        comm.all_reduce(torch.zeros(1, dtype=torch.int64), op="avg")
        raise AssertionError("AVG of integers must raise")
    except TypeError:
        pass
    print("PAYLOAD OK rank", rank, flush=True)
""") + _EPILOGUE

_DP_PAYLOAD = _PREAMBLE + textwrap.dedent("""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.optimizer import AdamW

    # identical model on both ranks; DIFFERENT local batches
    net = ptt.nn.Linear(8, 4, device="cpu")
    with torch.no_grad():
        net.weight.fill_(0.1)
        net.bias.zero_()
    dp = dist.DataParallel(net, comm_buffer_size=1)   # small buckets
    x = torch.full((2, 8), float(rank + 1))
    loss = dp(x).square().mean()
    loss.backward()
    local_grad = net.weight.grad.clone()
    dp.apply_collective_grads()
    synced = net.weight.grad

    # expected: the mean of both ranks' analytic local grads
    def grad_for(r):
        xx = np.full((2, 8), float(r + 1), np.float32)
        out = xx @ (np.ones((8, 4), np.float32) * 0.1)
        return 2.0 / out.size * xx.T @ out
    expect = (grad_for(0) + grad_for(1)) / 2
    np.testing.assert_allclose(synced.numpy(), expect, rtol=1e-5)
    assert not np.allclose(local_grad.numpy(), synced.numpy())   # the sync changed it

    # a DataParallel TrainStep on two half batches == one process on the whole
    ids = np.random.default_rng(7).integers(1, 256, (4, 16)).astype(np.int32)

    def train(model, batch, wrap, merge=None):
        opt = AdamW(1e-3, parameters=model.parameters())
        step = TrainStep(dist.DataParallel(model) if wrap else model,
                         lambda m, a, b: m(a, labels=b)[0], opt, gradient_merge=merge)
        return [float(step(batch, batch)) for _ in range(3)]

    whole = LlamaForCausalLM(llama_tiny(), device="cpu", seed=7)
    train(whole, ids, wrap=False)
    for merge in (None, 2):
        half = LlamaForCausalLM(llama_tiny(), device="cpu", seed=7)
        train(half, ids[2 * rank:2 * rank + 2], wrap=True, merge=merge)
        for (name, p), q in zip(half.named_parameters(), whole.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
            both = comm.all_gather([], p.detach().reshape(1, -1).contiguous())
            assert torch.equal(both[0], both[1]), name          # the ranks agree
    print("DP PAYLOAD OK rank", rank, flush=True)
""") + _EPILOGUE


_TP_PAYLOAD = _PREAMBLE + textwrap.dedent("""
    from paddle_tpu_torch.distributed.meta_parallel import (
        ColumnParallelLinear, ColumnSequenceParallelLinear, GatherOp, ParallelCrossEntropy,
        RowParallelLinear, RowSequenceParallelLinear, ScatterOp, VocabParallelEmbedding,
        register_sequence_parallel_allreduce_hooks)

    # a model axis over the two processes: each holds its shard
    members = np.empty(2, dtype=object)
    members[:] = [torch.device("cpu")] * 2
    shape = (1, 1, 1, 1, 2)
    topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(mesh=topology.Mesh(
        members.reshape(shape), topology._HYBRID_AXES, np.arange(2).reshape(shape))))
    hcg = dist.get_hybrid_communicate_group()
    assert hcg.get_model_parallel_rank() == rank and hcg.get_model_parallel_world_size() == 2

    def close(got, want, what):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=what)

    def mine(t, axis):
        w = t.shape[axis] // 2
        return t.narrow(axis, rank * w, w)

    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 64, (2, 8)))
    labels = torch.from_numpy(rng.integers(0, 64, (2, 8)))
    labels[0, :2] = -100
    for sp in (False, True):
        col_t = ColumnSequenceParallelLinear if sp else ColumnParallelLinear
        row_t = RowSequenceParallelLinear if sp else RowParallelLinear
        g = torch.Generator().manual_seed(3)
        emb = VocabParallelEmbedding(64, 16, generator=g, device="cpu")
        col = col_t(16, 32, gather_output=False, generator=g, device="cpu")
        row = row_t(32, 16, input_is_parallel=True, generator=g, device="cpu")
        head = ColumnParallelLinear(16, 64, has_bias=False, gather_output=False,
                                    generator=g, device="cpu")
        norm = ptt.nn.RMSNorm(16)
        with torch.no_grad():
            col.bias.copy_(mine(torch.arange(32.0) / 32, 0))
            row.bias.copy_(torch.arange(16.0) / 16)
            norm.weight.copy_(1.0 + torch.arange(16.0) / 64)
        if sp:   # the norm sees this process's tokens: sum its grad over the group
            register_sequence_parallel_allreduce_hooks(
                torch.nn.ModuleList([emb, col, row, head, norm]))
        assert tuple(col.weight.shape) == (16, 16) and tuple(row.weight.shape) == (16, 16)
        h = emb(ids)
        h = ScatterOp.apply(h) if sp else h
        h = row(col(norm(h)))
        h = GatherOp.apply(h) if sp else h
        loss = ParallelCrossEntropy()(head(h), labels).sum()
        loss.backward()

        # one process on the whole weights, the same draws
        g = torch.Generator().manual_seed(3)
        W = [torch.empty(s_).normal_(0.0, 0.02, generator=g).requires_grad_()
             for s_ in ((64, 16), (16, 32), (32, 16), (16, 64))]
        bc = (torch.arange(32.0) / 32).requires_grad_()
        br = (torch.arange(16.0) / 16).requires_grad_()
        nw = (1.0 + torch.arange(16.0) / 64).requires_grad_()
        x = W[0][ids]
        x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * nw
        logits = ((x @ W[1] + bc) @ W[2] + br) @ W[3]
        want = torch.nn.functional.cross_entropy(logits.reshape(-1, 64), labels.reshape(-1),
                                                 ignore_index=-100, reduction="sum")
        want.backward()
        close(loss, want, f"loss sp={sp}")
        close(emb.weight.grad, mine(W[0].grad, 0), "embedding grad")
        close(col.weight.grad, mine(W[1].grad, 1), "column grad")
        close(col.bias.grad, mine(bc.grad, 0), "column bias grad")
        close(row.weight.grad, mine(W[2].grad, 0), "row grad")
        close(row.bias.grad, br.grad, "row bias grad")
        close(head.weight.grad, mine(W[3].grad, 1), "head grad")
        close(norm.weight.grad, nw.grad, f"norm weight grad sp={sp}")
    print("TP PAYLOAD OK rank", rank, flush=True)
""") + _EPILOGUE


_HYBRID_PAYLOAD = _PREAMBLE + textwrap.dedent("""
    from paddle_tpu_torch.distributed.meta_parallel import (
        ColumnParallelLinear, ColumnSequenceParallelLinear, RowParallelLinear,
        RowSequenceParallelLinear)
    from paddle_tpu_torch.distributed.overlap import should_decompose
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    def close(got, want, what, rtol=1e-5, atol=1e-6):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                                   rtol=rtol, atol=atol, err_msg=what)

    def mine(t, axis):
        w = t.shape[axis] // 2
        return t.narrow(axis, rank * w, w)

    def fleet_init(**configs):
        s = dist.fleet.DistributedStrategy()
        s.hybrid_configs = configs
        dist.fleet.init(is_collective=True, strategy=s)
        return dist.get_hybrid_communicate_group()

    # ZeRO across the two processes: sharding 2, the global batch given to
    # each, against one process on the whole batch
    hcg = fleet_init(sharding_degree=2)
    assert hcg.mesh.procs is not None and hcg.get_sharding_parallel_rank() == rank
    os.environ["PADDLE_TPU_BUCKET_MB"] = "0.01"          # several buckets
    ids = np.random.default_rng(7).integers(1, 256, (4, 16)).astype(np.int64)

    def build():
        model = LlamaForCausalLM(llama_tiny(), device="cpu", seed=7)
        return model, AdamW(1e-3, parameters=model.parameters(),
                            grad_clip=ClipGradByGlobalNorm(1.0))

    whole, wopt = build()
    wstep = TrainStep(whole, lambda m, a, b: m(a, labels=b)[0], wopt)
    want = [float(wstep(ids, ids)) for _ in range(3)]
    for stage in (0, 1, 2):
        model, opt = build()
        step = dist.DistributedTrainStep(model, lambda m, a, b: m(a, labels=b)[0], opt, hcg,
                                         sharding_stage=stage)
        got = [float(step(ids, ids)) for _ in range(3)]
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"stage {stage}")
        for (name, p), q in zip(model.named_parameters(), whole.parameters()):
            close(p, q, f"stage {stage} {name}", rtol=1e-4, atol=1e-5)
        held = [opt._accumulators[id(p)]["moment1"] for p in model.parameters()
                if id(p) in opt._layouts]
        assert (len(held) > 0) == (stage > 0)
        assert all(m.shape[0] == 1 for m in held)      # this process's block only
        if stage:
            assert step._grad_bucketer.num_buckets > 1
    for bad in (dict(sharding_stage=3),):
        try:
            dist.DistributedTrainStep(model, lambda m, a, b: m(a, labels=b)[0], opt, hcg, **bad)
        except NotImplementedError as e:
            assert "A6d" in str(e)
        else:
            raise AssertionError(f"{bad} across processes was taken")

    # the collective-matmul ring across the two processes on a model axis
    os.environ["PADDLE_TPU_TP_OVERLAP"] = "1"
    os.environ["PADDLE_TPU_TP_OVERLAP_MIN_ROWS"] = "1"
    hcg = fleet_init(mp_degree=2)
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    dys = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    for sp in (False, True):
        col_t = ColumnSequenceParallelLinear if sp else ColumnParallelLinear
        row_t = RowSequenceParallelLinear if sp else RowParallelLinear
        g = torch.Generator().manual_seed(3)
        col = col_t(16, 32, gather_output=False, generator=g, device="cpu")
        row = row_t(32, 16, input_is_parallel=True, generator=g, device="cpu")
        with torch.no_grad():
            col.bias.copy_(mine(torch.arange(32.0) / 32, 0))
            row.bias.copy_(torch.arange(16.0) / 16)
        x = (mine(xs, 1) if sp else xs).clone().requires_grad_()
        assert should_decompose((2, 8, 16), hcg.mesh)
        out = row(col(x))
        (out * (mine(dys, 1) if sp else dys)).sum().backward()

        g = torch.Generator().manual_seed(3)
        W1 = torch.empty(16, 32).normal_(0.0, 0.02, generator=g).requires_grad_()
        W2 = torch.empty(32, 16).normal_(0.0, 0.02, generator=g).requires_grad_()
        bc = (torch.arange(32.0) / 32).requires_grad_()
        br = (torch.arange(16.0) / 16).requires_grad_()
        xr = xs.clone().requires_grad_()
        ref = (xr @ W1 + bc) @ W2 + br
        (ref * dys).sum().backward()
        close(out, mine(ref, 1) if sp else ref, f"ring output sp={sp}")
        close(x.grad, mine(xr.grad, 1) if sp else xr.grad, f"ring input grad sp={sp}")
        close(col.weight.grad, mine(W1.grad, 1), f"ring column grad sp={sp}")
        close(col.bias.grad, mine(bc.grad, 0), f"ring column bias grad sp={sp}")
        close(row.weight.grad, mine(W2.grad, 0), f"ring row grad sp={sp}")

    # the hybrid Llama over the model axis across the processes (SP and the
    # ring on, each process holding its shards) against one controller
    from paddle_tpu_torch.models.llama_parallel import LlamaForCausalLMHybrid

    def hybrid_losses(group):
        model = LlamaForCausalLMHybrid(llama_tiny(), group, device="cpu", seed=5)
        opt = AdamW(1e-3, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(0.5))
        step = dist.DistributedTrainStep(model, lambda m, a, b: m(a, labels=b)[0], opt, group)
        return model, [float(step(ids, ids)) for _ in range(3)]

    model, got = hybrid_losses(hcg)
    assert model.sequence_parallel and tuple(model.lm_head.weight.shape) == (64, 128)
    one = topology.HybridCommunicateGroup(mesh=topology.build_mesh(devices=["cpu"]))
    topology.set_hybrid_communicate_group(one)
    whole, want = hybrid_losses(one)
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg="hybrid Llama across processes")
    for (name, p), q in zip(model.named_parameters(), whole.parameters()):
        axis = getattr(p, "split_axis", None) if vars(p).get("is_distributed") else None
        close(p, q if axis is None else mine(q, axis), name, rtol=1e-4, atol=1e-5)
    print("HYBRID PAYLOAD OK rank", rank, flush=True)
""") + _EPILOGUE


def _run_launch(tmp_path, payload_src, nproc=2, timeout=120, extra_env=None, args=()):
    payload = tmp_path / "payload.py"
    payload.write_text(payload_src)
    log_dir = tmp_path / "log"
    env = os.environ.copy()
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
              "PADDLE_LOCAL_RANK", "PADDLE_NPROC_PER_NODE"):
        env.pop(k, None)
    env.update(extra_env or {})
    # workers run script-mode (script dir on sys.path, not cwd); make the
    # repo-local package importable
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(nproc), "--log_dir", str(log_dir), *args,
         str(payload)],
        env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=timeout)
    logs = {p.name: p.read_text() for p in log_dir.glob("workerlog.*")}
    return proc, logs


class TestLaunchMultiProcess:
    def test_two_process_collectives(self, tmp_path):
        proc, logs = _run_launch(tmp_path, _PAYLOAD)
        assert proc.returncode == 0, f"launch failed: {proc.stderr}\n{logs}"
        assert set(logs) == {"workerlog.0", "workerlog.1"}
        for name, text in logs.items():
            assert "PAYLOAD OK rank" in text, f"{name}: {text[-2000:]}"

    def test_worker_failure_tears_down_pod(self, tmp_path):
        pid_file = tmp_path / "sibling.pid"
        bad = textwrap.dedent(f"""
            import os, sys, time
            if os.environ["PADDLE_TRAINER_ID"] == "1":
                time.sleep(1.0)
                sys.exit(3)
            open({str(pid_file)!r}, "w").write(str(os.getpid()))
            time.sleep(60)  # rank 0 hangs; the launcher must kill it
        """)
        t0 = time.time()
        proc, _ = _run_launch(tmp_path, bad, timeout=90)
        assert proc.returncode == 3
        assert time.time() - t0 < 30
        with pytest.raises(ProcessLookupError):
            os.kill(int(pid_file.read_text()), 0)       # the sibling is gone

    def test_excluded_slot_gets_no_worker(self, tmp_path):
        show = textwrap.dedent("""
            import os
            print(*(os.environ.get(k) for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                  "PADDLE_LOCAL_RANK", "PADDLE_NODE_RANK")), flush=True)
        """)
        proc, logs = _run_launch(tmp_path, show, nproc=3, timeout=60,
                                 extra_env={"PADDLE_TPU_EXCLUDE_SLOTS": "1"})
        assert proc.returncode == 0, proc.stderr
        assert {k: v.split() for k, v in logs.items()} == {
            "workerlog.0": ["0", "2", "0", "0"], "workerlog.1": ["1", "2", "2", "0"]}


class TestDataParallelMultiProcess:
    def test_bucketed_grad_sync_across_processes(self, tmp_path):
        proc, logs = _run_launch(tmp_path, _DP_PAYLOAD)
        assert proc.returncode == 0, f"launch failed: {proc.stderr}\n{logs}"
        for name, text in logs.items():
            assert "DP PAYLOAD OK rank" in text, f"{name}: {text[-2000:]}"


class TestTensorParallelMultiProcess:
    def test_parallel_layers_across_processes(self, tmp_path):
        """Two gloo processes on a model axis: the four ``mp_layers`` and
        the SP linears with a marked norm weight, forward and backward,
        against one process on the whole weights."""
        proc, logs = _run_launch(tmp_path, _TP_PAYLOAD)
        assert proc.returncode == 0, f"launch failed: {proc.stderr}\n{logs}"
        for name, text in logs.items():
            assert "TP PAYLOAD OK rank" in text, f"{name}: {text[-2000:]}"


class TestHybridMultiProcess:
    def test_zero_and_ring_across_processes(self, tmp_path):
        """Two gloo processes: ``fleet.init`` over them, then
        ``DistributedTrainStep`` at stages 0, 1 and 2 (this process's block
        of the optimizer states, the gradients reduce-scattered a bucket at
        a time, the parameters all-gathered; stage 3 refused, A6d) against
        one process on the whole batch; then the collective-matmul ring
        (each step a ``batch_isend_irecv`` to the ring neighbour), the
        tensor-parallel and the sequence-parallel linears, forward and
        backward, against one process on the whole weights."""
        proc, logs = _run_launch(tmp_path, _HYBRID_PAYLOAD)
        assert proc.returncode == 0, f"launch failed: {proc.stderr}\n{logs}"
        for name, text in logs.items():
            assert "HYBRID PAYLOAD OK rank" in text, f"{name}: {text[-2000:]}"


class TestUnported:
    """What waits for later queue items refuses to start."""

    @pytest.mark.parametrize("argv,env,item", [
        (["--mode", "serve", "x.py"], {}, "A8"),
        (["--fault_domain", "on", "x.py"], {}, "on"),
        (["x.py"], {"PADDLE_TPU_FAULT_DOMAIN": "1"}, "on"),
        (["x.py"], {"PADDLE_TPU_FAULT_DOMAIN": "0"}, "off"),
    ], ids=["serve", "fault_domain", "fault_domain_env", "fault_domain_env_off"])
    def test_refused(self, monkeypatch, tmp_path, argv, env, item):
        """Serving mode (A8) and the fault domain (A7b) are ported: ``--mode
        serve`` parses and nothing refuses it any more; the fault domain is
        on unless PADDLE_TPU_FAULT_DOMAIN is 0/false, as in the reference."""
        from paddle_tpu_torch.distributed.launch.main import _parse

        for k, v in env.items():
            monkeypatch.setenv(k, v)
        launch_main = importlib.import_module("paddle_tpu_torch.distributed.launch.main")

        if item in ("on", "off"):
            assert _parse(argv).fault_domain == item
            return
        assert _parse(argv).mode == "serve"
        assert not hasattr(launch_main, "_refuse_unported")
        assert callable(launch_main._serve_pod)


_SNAP_PAYLOAD = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed.checkpoint import Snapshotter, resume
    from paddle_tpu_torch.distributed.checkpoint.replicator import transport_from_env

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    assert os.environ.get("PADDLE_TPU_SNAP_STORE"), "no depot exported"
    acc = torch.full((4,), float(rank + 1))
    snap = Snapshotter(lambda: {"acc": acc}, every=2, sync=True)
    assert snap.transport is not None and snap.world_size == 2
    assert snap.on_step(2)                      # captured and shipped
    tr = transport_from_env()
    deadline = time.time() + 60
    while not tr.complete_generations(2):       # the other rank's copy
        assert time.time() < deadline, "generation 2 never completed"
        time.sleep(0.1)
    got = {"acc": torch.zeros(4)}
    info = resume(got, None, transport=tr, ledger=None)
    assert info.source == "memory" and info.step == 2, info
    assert torch.equal(got["acc"], acc)
    holders = sorted((e["src"], e["holder"]) for e in tr.index() if e["src"] == rank)
    assert holders == sorted([(rank, rank), (rank, (rank + 1) % 2)]), holders
    print("SNAP PAYLOAD OK rank", rank, flush=True)
""")


class TestSnapshotDepot:
    def test_launcher_hosts_the_depot(self, tmp_path):
        """``PADDLE_TPU_SNAP`` on by default: the launcher hosts the depot
        and exports ``PADDLE_TPU_SNAP_STORE``; each rank ships its own copy
        and its ring neighbour's replica, and resumes from the depot."""
        proc, logs = _run_launch(tmp_path, _SNAP_PAYLOAD, timeout=120)
        assert proc.returncode == 0, f"launch failed: {proc.stderr}\n{logs}"
        for name, text in logs.items():
            assert "SNAP PAYLOAD OK rank" in text, f"{name}: {text[-2000:]}"

    def test_snapshots_off_exports_no_depot(self, tmp_path):
        show = "import os; print(os.environ.get('PADDLE_TPU_SNAP_STORE'), flush=True)\n"
        proc, logs = _run_launch(tmp_path, show, nproc=1, timeout=60,
                                 extra_env={"PADDLE_TPU_SNAP": "0"})
        assert proc.returncode == 0, proc.stderr
        assert logs["workerlog.0"].split() == ["None"]
