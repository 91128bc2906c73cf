"""The port's launch CLI and its multi-process mode on the CPU:
``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2`` over
gloo, mirroring the JAX package's ``test_launch_multiprocess.py``
(``_PAYLOAD``: a stacked all_reduce gives ``[4.]``; ``_DP_PAYLOAD``: the
bucketed gradient sync equals the analytic mean; a failing rank fails the
pod).  Beyond it, every collective and P2P call of each rank is held
against its rows of the single-controller result on a CPU mesh (which
``test_torch_distributed.py`` holds against the JAX package), and a
``DataParallel`` ``TrainStep`` on two half batches against one process on
the whole batch; and the tensor-parallel layers (ROADMAP A6b) with each
process holding its shard, against one process on the whole weights.
Every launch has its own timeout of at most 120 s."""

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
""")

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
""")


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
""")


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


class TestUnported:
    """What waits for later queue items refuses to start."""

    @pytest.mark.parametrize("argv,env,item", [
        (["--mode", "serve", "x.py"], {}, "A8"),
        (["--fault_domain", "on", "x.py"], {}, "A7"),
        (["x.py"], {"PADDLE_TPU_FAULT_DOMAIN": "1"}, "A7"),
        (["x.py"], {"PADDLE_TPU_SNAP": "1"}, "A7"),
    ], ids=["serve", "fault_domain", "fault_domain_env", "snapshot_depot"])
    def test_refused(self, monkeypatch, tmp_path, argv, env, item):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(NotImplementedError, match=item):
            launch(["--log_dir", str(tmp_path / "log"), *argv])
        assert not (tmp_path / "log").exists()
