"""The port's ``distributed.overlap`` (ROADMAP A6c) against the JAX
package's, on the CPU.

The JAX side runs on conftest's 8 forced CPU devices, its rings jitted;
the port's on single-controller meshes of repeated ``cpu`` members.
Cases:
- the gradient bucketer (``tests/test_overlap.py``'s planning, coalescing
  and identity cases), plan for plan against the JAX bucketer;
- the four ring primitives and both grads against the JAX primitives and
  against the fused product, f32 and bf16, at model 4 and at data 2 x
  model 2 (the batch groups' weight-grad sum);
- the gates against the JAX gates (env switch, row threshold,
  divisibility, degree, a pipe mesh stays fused);
- ``mp_layers`` and the SP linears with the ring on against off;
- ``measure`` on synthetic traces, and the fingerprint.

Tolerances: ``tests/test_overlap.py``'s (f32 rtol 1e-5 for grads, bf16
5e-2); the ring against the fused form in f32 at 2e-5 (``op_test.py``'s
row): the partial products are summed in another order.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import overlap as joverlap
from paddle_tpu.distributed import topology as jtopo

import paddle_tpu_torch as ptt
from paddle_tpu_torch.distributed import overlap, topology
from paddle_tpu_torch.distributed.meta_parallel import mp_layers as tmp
from paddle_tpu_torch.distributed.meta_parallel import sequence_parallel as tsp

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _pmesh(**degrees):
    return topology.build_mesh(devices=["cpu"] * math.prod(degrees.values()), **degrees)


def _jmesh(**degrees):
    return jtopo.build_mesh(devices=jax.devices()[:math.prod(degrees.values())], **degrees)


MESHES = {"mp4": dict(mp=4), "dp2_mp2": dict(dp=2, mp=2), "dp2_sh2_mp2": dict(dp=2, sharding=2, mp=2)}


@pytest.fixture
def overlap_on(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", "1")
    monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP_MIN_ROWS", "1")


# ---------------------------------------------------------------------------
# the bucketer


class TestGradientBucketer:
    @pytest.mark.parametrize("sizes,bb,keys", [
        ([100] * 7, 250, None),
        ([10, 1000, 10], 100, None),
        ([10, 10, 10, 10], 10 ** 6, ["f32", "f32", "bf16", "f32"]),
        ([64, 96, 32, 500, 8], 128, ["a", "a", "b", "a", "a"]),
    ], ids=["reverse", "oversize", "keys", "mixed"])
    def test_plan_matches_reference(self, sizes, bb, keys):
        b = overlap.GradientBucketer(sizes, bucket_bytes=bb, keys=keys)
        jb = joverlap.GradientBucketer(sizes, bucket_bytes=bb, keys=keys)
        assert b.buckets == jb.buckets and b.bucket_nbytes() == jb.bucket_nbytes()
        flat = [i for bucket in b.buckets for i in bucket]
        assert sorted(flat) == list(range(len(sizes)))
        for i in range(len(sizes)):
            assert b.bucket_of(i) == jb.bucket_of(i)

    def test_reverse_order_and_target(self):
        b = overlap.GradientBucketer([100] * 7, bucket_bytes=250)
        assert [i for bk in b.buckets for i in bk] == list(reversed(range(7)))
        assert all(len(bk) * 100 <= 250 for bk in b.buckets)
        assert [sorted(bk) for bk in overlap.GradientBucketer(
            [10, 1000, 10], bucket_bytes=100).buckets] == [[2], [1], [0]]

    def test_skip(self):
        skip = [False, True, False, False]
        b = overlap.GradientBucketer([8, 8, 8, 8], bucket_bytes=16, skip=skip)
        jb = joverlap.GradientBucketer([8, 8, 8, 8], bucket_bytes=16, skip=skip)
        assert b.buckets == jb.buckets and all(1 not in bk for bk in b.buckets)
        grads = [torch.full((2,), float(i)) for i in range(4)]
        out = b.split(b.coalesce(grads), [(2,)] * 4)
        assert out[1] is None and all(torch.equal(o, g) for o, g in zip(out, grads)
                                      if o is not None)

    def test_env_target(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_BUCKET_MB", "0")
        assert overlap.grad_bucket_bytes() == joverlap.grad_bucket_bytes() == 0
        monkeypatch.delenv("PADDLE_TPU_BUCKET_MB")
        assert overlap.grad_bucket_bytes() == joverlap.grad_bucket_bytes() == 25 * 2 ** 20
        assert overlap.grad_bucket_bytes(1234) == 1234

    def test_coalesce_split_round_trip(self):
        rng = np.random.default_rng(0)
        arrays = [rng.standard_normal(s).astype(np.float32) for s in [(4, 3), (2,), (5, 2, 2)]]
        sizes = [a.size * 4 for a in arrays]
        b = overlap.GradientBucketer(sizes, bucket_bytes=60)
        flats = b.coalesce([torch.from_numpy(a) for a in arrays])
        jflats = joverlap.GradientBucketer(sizes, bucket_bytes=60).coalesce(
            [jnp.asarray(a) for a in arrays])
        assert len(flats) == b.num_buckets == len(jflats)
        for f, jf in zip(flats, jflats):
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        for a, r in zip(arrays, b.split(flats, [a.shape for a in arrays])):
            np.testing.assert_array_equal(r.numpy(), a)

    def test_constrain_is_value_identity(self):
        grads = [torch.randn(8, 4), torch.randn(16)]
        b = overlap.GradientBucketer([g.numel() * 4 for g in grads], bucket_bytes=64)
        out = b.constrain(grads, _pmesh(dp=2, mp=2))
        assert all(o is g for o, g in zip(out, grads)) and b.routed == 1
        b.constrain(grads, _pmesh(mp=2))           # no sized reduction axis
        assert b.routed == 1


# ---------------------------------------------------------------------------
# the ring primitives


PRIMS = ["all_gather_matmul", "matmul_reduce_scatter", "all_gather_matmul_seq",
         "matmul_reduce_scatter_seq"]


def _operands(prim, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xshape = (4, 8, 12) if prim.endswith("_seq") else (16, 12)
    return (rng.standard_normal(xshape).astype(dtype),
            rng.standard_normal((12, 8)).astype(dtype))


def _port(prim, mesh_kw, x, w, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    out = getattr(overlap, prim)(xt, wt, _pmesh(**mesh_kw))
    torch.sin(out.float()).sum().backward()
    return out.detach(), xt.grad, wt.grad


def _jax(prim, mesh_kw, x, w, dtype=jnp.float32):
    mesh = _jmesh(**mesh_kw)
    fn = getattr(joverlap, prim)

    def loss(a, b):
        return jnp.sum(jnp.sin(fn(a, b, mesh).astype(jnp.float32)))

    xa, wa = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    out = jax.jit(lambda a, b: fn(a, b, mesh))(xa, wa)
    gx, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(xa, wa)
    return [np.asarray(t, np.float32) for t in (out, gx, gw)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("prim", PRIMS)
class TestRingPrimitives:
    def test_f32_against_reference_and_fused(self, prim, mesh):
        x, w = _operands(prim, PRIMS.index(prim))
        got = _port(prim, MESHES[mesh], x, w)
        want = _jax(prim, MESHES[mesh], x, w)
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.numpy(), j, rtol=1e-5, atol=1e-5)
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        fused = xt @ wt
        torch.sin(fused).sum().backward()
        for g, f in zip(got, (fused.detach(), xt.grad, wt.grad)):
            torch.testing.assert_close(g, f, **F32)

    def test_bf16(self, prim, mesh):
        x, w = _operands(prim, 10 + PRIMS.index(prim))
        got = _port(prim, MESHES[mesh], x, w, torch.bfloat16)
        assert got[0].dtype == got[1].dtype == got[2].dtype == torch.bfloat16
        want = _jax(prim, MESHES[mesh], x, w, jnp.bfloat16)
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(), j, **BF16)
        fused = (torch.from_numpy(x).to(torch.bfloat16) @ torch.from_numpy(w).to(torch.bfloat16))
        torch.testing.assert_close(got[0].float(), fused.float(), **BF16)


def test_ring_at_two_members_sums_like_the_fused_form():
    """At p 2 both forms add the same two partials: the f32 row-parallel
    ring equals the members' sum (``member_sum``) bit for bit."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32))
    mesh = _pmesh(mp=2)
    parts = [xj @ wj for xj, wj in zip(x.chunk(2, -1), w.chunk(2, 0))]
    assert torch.equal(overlap.matmul_reduce_scatter(x, w, mesh), tmp.member_sum(parts, x.device))


# ---------------------------------------------------------------------------
# the gates


class TestGates:
    CASES = [((16, 12), dict(mp=4)), ((32, 12), dict(mp=4)), ((15, 12), dict(mp=4)),
             ((16, 12), dict(dp=4)), ((16, 12), dict(mp=2, pp=2)),
             ((8, 12), dict(dp=2, mp=2)), ((4, 16, 12), dict(dp=2, mp=2)),
             ((3, 16, 12), dict(dp=2, mp=2)), ((4, 16, 12), dict(sep=2, mp=2))]

    @pytest.mark.parametrize("min_rows", ["1", "8", "256"])
    def test_against_reference(self, monkeypatch, min_rows):
        monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP_MIN_ROWS", min_rows)
        for env in ("1", "0", None):
            if env is None:
                monkeypatch.delenv("PADDLE_TPU_TP_OVERLAP", raising=False)
            else:
                monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", env)
            assert overlap.tp_overlap_enabled() == joverlap.tp_overlap_enabled()
            assert overlap.overlap_min_rows() == joverlap.overlap_min_rows()
            for shape, kw in self.CASES:
                p, j = _pmesh(**kw), _jmesh(**kw)
                assert overlap.should_decompose(shape, p) == joverlap.should_decompose(shape, j)
                assert overlap.should_decompose_seq(shape, p) == \
                    joverlap.should_decompose_seq(shape, j), (shape, kw)

    def test_defaults(self, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_TP_OVERLAP", raising=False)
        monkeypatch.delenv("PADDLE_TPU_TP_OVERLAP_MIN_ROWS", raising=False)
        mesh = _pmesh(sharding=2, mp=2)
        assert overlap.should_decompose((4 * 2048, 4096), mesh)       # 2048 rows a member
        assert not overlap.should_decompose((4 * 2048, 4096), _pmesh(pp=2, mp=2))
        assert not overlap.should_decompose((2 * 255, 64), _pmesh(mp=2))
        assert overlap.overlap_fingerprint() == {"tp_overlap": True, "min_rows": 256,
                                                 "bucket_bytes": 25 * 2 ** 20}


# ---------------------------------------------------------------------------
# the tensor-parallel layers through the gate


@pytest.fixture
def model_mesh():
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(
        topology.HybridCommunicateGroup(mesh=_pmesh(dp=2, sharding=2, mp=2)))
    yield
    topology.set_hybrid_communicate_group(saved)


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_mp_layers_ring_on_against_off(model_mesh, overlap_on, monkeypatch, sp):
    col_t = tsp.ColumnSequenceParallelLinear if sp else tmp.ColumnParallelLinear
    row_t = tsp.RowSequenceParallelLinear if sp else tmp.RowParallelLinear
    g = torch.Generator().manual_seed(0)
    col = col_t(16, 32, gather_output=False, generator=g, device="cpu")
    row = row_t(32, 16, input_is_parallel=True, generator=g, device="cpu")
    with torch.no_grad():
        col.bias.copy_(torch.arange(32.0) / 32)
        row.bias.copy_(torch.arange(16.0) / 16)
    xv = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 8, 16)).astype(np.float32))

    def run(flag):
        monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", flag)
        for p in (*col.parameters(), *row.parameters()):
            p.grad = None
        x = xv.clone().requires_grad_()
        out = row(col(x))
        torch.sin(out).sum().backward()
        return [out.detach(), x.grad] + [p.grad for p in (*col.parameters(), *row.parameters())]

    assert overlap.should_decompose(tuple(xv.shape), topology.get_hybrid_communicate_group().mesh)
    for a, b in zip(run("1"), run("0")):
        torch.testing.assert_close(a, b, **F32)


# ---------------------------------------------------------------------------
# measure


class TestMeasure:
    EVENTS = [
        {"ph": "X", "name": "fusion.1", "ts": 0, "dur": 100},
        {"ph": "X", "name": "all-reduce.3", "ts": 50, "dur": 100},
        {"ph": "X", "name": "collective-permute-start", "ts": 300, "dur": 40},
        {"ph": "X", "name": "telemetry span", "ts": 0, "dur": 1000, "cat": "telemetry"},
        {"ph": "i", "name": "all-gather", "ts": 0},
    ]

    def test_trace_against_reference(self):
        got = overlap.overlap_fraction_from_trace(self.EVENTS)
        assert got == joverlap.overlap_fraction_from_trace(self.EVENTS) == 50 / 140
        assert overlap.overlap_fraction_from_trace(self.EVENTS[:1]) is None

    def test_device_events_only(self):
        """A ``torch.profiler`` trace: host operator spans do not count as
        compute once device events exist; NCCL kernels are collectives."""
        events = [
            {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 1000},
            {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16", "ts": 0, "dur": 30},
            {"ph": "X", "cat": "kernel",
             "name": "ncclDevKernel_AllReduce_Sum_bf16_RING_LL", "ts": 20, "dur": 40},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 50, "dur": 20},
        ]
        assert overlap.overlap_fraction_from_trace(events) == pytest.approx(20 / 40)

    @pytest.mark.parametrize("args", [(1.0, 0.5, 2.0), (3.0, 1.0, 1.0), (0.0, 0.0, 1.0)])
    def test_hidden_comm_seconds(self, args):
        assert overlap.hidden_comm_seconds(*args) == joverlap.hidden_comm_seconds(*args)
