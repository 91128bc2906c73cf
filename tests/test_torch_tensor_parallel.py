"""The port's model axis (ROADMAP A6b) against the JAX package, on the CPU.

The JAX side runs on conftest's 8 forced CPU devices; the port's on a
``topology.Mesh`` of 8 repeated ``cpu`` members (driven from one process),
at the reference's layouts: dp 2 × sharding 2 × model 2 and dp 4 × model 2
(``tests/test_sequence_parallel.py``'s fixtures).  Cases:
- the hybrid group's degrees, groups and ranks;
- the four ``mp_layers`` (forward, input and weight gradients) with the
  JAX layers' weights carried across by ``convert.py``;
- ``ParallelCrossEntropy`` with ``ignore_index`` and both label shapes;
- the sequence-parallel ops' round trips and gradients, and the SP linears;
- a marked norm weight's gradient, the analytic sum at tp 2, and the
  hooks' loud failures;
- ``sequence_parallel_enabled``'s precedence;
- the mesh wrappers against the reference's (its Pallas kernels in
  interpret mode) at ``tests/test_mesh_pallas.py``'s degrees, and the
  functional ops' routing through them under a live mesh;
- a model of ``mp_layers`` carried across by its ``state_dict``.

Tolerances: ``tests/op_test.py``'s f32 rows.  Left out: the reference's
collective-matmul ring (``should_decompose_seq``, ``all_gather_matmul_seq``:
ROADMAP A6c; ``PADDLE_TPU_TP_OVERLAP`` set on raises in the port).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.distributed.meta_parallel import mp_layers as jmp
from paddle_tpu.distributed.meta_parallel import sequence_parallel as jsp
from paddle_tpu.framework.flags import flag_guard as jax_flag_guard
from paddle_tpu.ops import sharded as jsharded

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.distributed.meta_parallel import mp_layers as tmp
from paddle_tpu_torch.distributed.meta_parallel import sequence_parallel as tsp
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import sharded as tsharded

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)          # tests/op_test.py float32 row
F32_GRAD = dict(rtol=2e-5, atol=1e-5)     # analytic grads of both packages
LAYOUTS = {"dp2_sh2_mp2": (2, 1, 2, 1, 2), "dp4_mp2": (4, 1, 1, 1, 2)}


def _port_mesh(shape):
    members = np.empty(math.prod(shape), dtype=object)
    members[:] = [torch.device("cpu")] * members.size
    return topology.Mesh(members.reshape(shape), topology._HYBRID_AXES)


@pytest.fixture(params=list(LAYOUTS))
def hcgs(request, monkeypatch):
    """(JAX hybrid group, port hybrid group) of one layout, each live in its
    package for the test; the collective-matmul ring off in the JAX
    package (it has no port yet)."""
    monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", "0")
    dp, _, sh, _, mp = LAYOUTS[request.param]
    saved = jtopo.get_hybrid_communicate_group(), topology.get_hybrid_communicate_group()
    jhcg = jtopo.HybridCommunicateGroup(dp=dp, sharding=sh, mp=mp)
    thcg = topology.HybridCommunicateGroup(mesh=_port_mesh(LAYOUTS[request.param]))
    jtopo.set_hybrid_communicate_group(jhcg)
    topology.set_hybrid_communicate_group(thcg)
    yield jhcg, thcg
    jtopo.set_hybrid_communicate_group(saved[0])
    topology.set_hybrid_communicate_group(saved[1])


def _carry(jlayer, tlayer):
    load_numpy_state_dict(tlayer, {k: np.asarray(v.numpy())
                                   for k, v in jlayer.state_dict().items()})
    return tlayer


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# the hybrid group


class TestHybridGroup:
    def test_degrees_groups_and_ranks(self, hcgs):
        jhcg, thcg = hcgs
        for name in ("data", "model", "pipe", "sharding", "sep"):
            ws = f"get_{name}_parallel_world_size"
            assert getattr(thcg, ws)() == getattr(jhcg, ws)()
            grp = f"get_{name}_parallel_group"
            tg, jg = getattr(thcg, grp)(), getattr(jhcg, grp)()
            assert (tg.axes, tg.nranks, tg.rank) == (jg.axes, jg.nranks, jg.rank)
        for fn in ("get_data_parallel_rank", "get_model_parallel_rank",
                   "get_sharding_parallel_rank", "get_sep_parallel_rank", "get_stage_id"):
            assert getattr(thcg, fn)() == getattr(jhcg, fn)() == 0
        for grp in (thcg.get_dp_sep_parallel_group(), jhcg.get_dp_sep_parallel_group()):
            assert grp.axes == ("data", "sep")
        for sharding in (False, True):
            tg = thcg.get_check_parallel_group(sharding)
            jg = jhcg.get_check_parallel_group(sharding)
            assert (tg.axes, tg.nranks) == (jg.axes, jg.nranks)
        assert thcg.get_global_group().nranks == jhcg.get_global_group().nranks == 8
        assert thcg.topology().get_dim("model") == jhcg.topology().get_dim("model") == 2

    def test_build_mesh_model_axis(self):
        mesh = topology.build_mesh(dp=2, mp=2, devices=["cpu"] * 4)
        hcg = topology.HybridCommunicateGroup(mesh=mesh)
        assert hcg.get_model_parallel_world_size() == 2
        assert hcg.get_model_parallel_group().nranks == 2
        assert mesh.axis_devices("model") == [torch.device("cpu")] * 2
        for kw in (dict(pp=2), dict(sharding=2)):
            with pytest.raises(NotImplementedError, match="A6c"):
                topology.build_mesh(devices=["cpu"] * 2, **kw)


# ---------------------------------------------------------------------------
# the four mp_layers


def _run_jax(layer, xv, dyv, int_input=False):
    x = paddle.to_tensor(xv, stop_gradient=int_input)
    out = layer(x)
    (out * paddle.to_tensor(dyv)).sum().backward()
    grads = {n: p.grad.numpy().copy() for n, p in layer.named_parameters()
             if p.grad is not None}
    return out.numpy(), (None if int_input else x.grad.numpy()), grads


def _run_port(layer, xv, dyv, int_input=False):
    x = torch.from_numpy(xv)
    if not int_input:
        x.requires_grad_()
    out = layer(x)
    (out * torch.from_numpy(dyv)).sum().backward()
    grads = {n: p.grad.numpy().copy() for n, p in layer.named_parameters()
             if p.grad is not None}
    return out.detach().numpy(), (None if int_input else x.grad.numpy()), grads


def _same(got, want, tol=F32, gtol=F32_GRAD):
    (to, tx, tg), (jo, jx, jg) = got, want
    np.testing.assert_allclose(to, jo, **tol)
    if jx is not None:
        np.testing.assert_allclose(tx, jx, **gtol)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], **gtol, err_msg=n)


LAYERS = {
    "column_gather": lambda m: (m.ColumnParallelLinear(16, 32, gather_output=True),
                                (2, 8, 16), (2, 8, 32)),
    "column_split": lambda m: (m.ColumnParallelLinear(16, 32, gather_output=False),
                               (2, 8, 16), (2, 8, 32)),
    "row_parallel_input": lambda m: (m.RowParallelLinear(32, 16, input_is_parallel=True),
                                     (2, 8, 32), (2, 8, 16)),
    "row_full_input": lambda m: (m.RowParallelLinear(32, 16, has_bias=False),
                                 (2, 8, 32), (2, 8, 16)),
}


class TestMpLayers:
    @pytest.mark.parametrize("kind", list(LAYERS))
    def test_linear_forward_and_grads(self, hcgs, kind):
        paddle.seed(3)
        jl, xs, ys = LAYERS[kind](jmp)
        with torch.no_grad():
            tl = _carry(jl, LAYERS[kind](tmp)[0])
        rng = _rng(4)
        xv = rng.standard_normal(xs).astype(np.float32)
        dyv = rng.standard_normal(ys).astype(np.float32)
        _same(_run_port(tl, xv, dyv), _run_jax(jl, xv, dyv))
        w = tl.weight
        assert (w.split_axis, vars(w)["is_distributed"]) == \
            (jl.weight.split_axis, jl.weight.is_distributed)
        assert tuple(w.shape) == tuple(jl.weight.shape)

    def test_vocab_parallel_embedding(self, hcgs):
        paddle.seed(5)
        jl = jmp.VocabParallelEmbedding(64, 16)
        tl = _carry(jl, tmp.VocabParallelEmbedding(64, 16))
        rng = _rng(6)
        ids = rng.integers(0, 64, (2, 8)).astype(np.int64)
        dyv = rng.standard_normal((2, 8, 16)).astype(np.float32)
        got = _run_port(tl, ids, dyv, int_input=True)
        want = _run_jax(jl, ids, dyv, int_input=True)
        _same(got, want)
        np.testing.assert_array_equal(got[0], np.asarray(jl.weight.numpy())[ids])
        assert tl.weight.split_axis == 0

    def test_divisibility_refused(self, hcgs):
        for make in (lambda: tmp.ColumnParallelLinear(8, 15),
                     lambda: tmp.RowParallelLinear(15, 8),
                     lambda: tmp.VocabParallelEmbedding(15, 8)):
            with pytest.raises(ValueError, match="not divisible"):
                make()

    def test_overlap_ring_waits_for_a6c(self, hcgs, monkeypatch):
        col = tmp.ColumnParallelLinear(16, 32)
        monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", "1")
        with pytest.raises(NotImplementedError, match="A6c"):
            col(torch.zeros(2, 8, 16))

    def test_replicated_bias_held_once(self, hcgs):
        row = tmp.RowParallelLinear(32, 16)
        assert tuple(row.bias.shape) == (16,)
        assert vars(row.bias)["is_distributed"] is False
        col = tmp.ColumnParallelLinear(16, 32)
        assert col.bias.split_axis == 0 and tuple(col.bias.shape) == (32,)
        assert sum(p.numel() for p in row.parameters()) == 32 * 16 + 16


class TestParallelCrossEntropy:
    @pytest.mark.parametrize("ignore_index,unit_dim", [(-100, False), (-100, True),
                                                       (5, False)])
    def test_against_the_reference(self, hcgs, ignore_index, unit_dim):
        rng = _rng(7)
        lv = (3.0 * rng.standard_normal((2, 8, 32))).astype(np.float32)
        lab = rng.integers(0, 32, (2, 8)).astype(np.int64)
        lab[0, :3] = ignore_index
        lab[1, 4] = 5
        if unit_dim:
            lab = lab[..., None]
        jx = paddle.to_tensor(lv, stop_gradient=False)
        jloss = jmp.ParallelCrossEntropy(ignore_index=ignore_index)(jx, paddle.to_tensor(lab))
        jloss.sum().backward()
        tx = torch.from_numpy(lv).requires_grad_()
        tloss = tmp.ParallelCrossEntropy(ignore_index=ignore_index)(tx, torch.from_numpy(lab))
        tloss.sum().backward()
        assert tuple(tloss.shape) == tuple(jloss.shape) == (2, 8, 1)
        np.testing.assert_allclose(tloss.detach().numpy(), jloss.numpy(), **F32)
        np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **F32_GRAD)
        flat = F.cross_entropy(tx.detach().reshape(-1, 32), torch.from_numpy(lab).reshape(-1),
                               ignore_index=ignore_index, reduction="none")
        np.testing.assert_allclose(tloss.detach().numpy().reshape(-1), flat.numpy(), **F32)


# ---------------------------------------------------------------------------
# sequence parallelism


class TestSequenceParallel:
    def test_ops_round_trip_and_grads(self, hcgs):
        xv = _rng(8).standard_normal((2, 8, 16)).astype(np.float32)
        jx = paddle.to_tensor(xv)
        for op in ("ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp"):
            tx = torch.from_numpy(xv).requires_grad_()
            out = getattr(tsp, op).apply(tx)
            assert tuple(out.shape) == (2, 8, 16)
            np.testing.assert_array_equal(out.detach().numpy(),
                                          getattr(jsp, op).apply(jx).numpy())
            out.sum().backward()
            np.testing.assert_array_equal(tx.grad.numpy(), np.ones_like(xv))
        g = tsp.GatherOp.apply(tsp.ScatterOp.apply(torch.from_numpy(xv)))
        np.testing.assert_array_equal(g.numpy(), xv)

    def test_sp_linears_match_the_reference(self, hcgs):
        paddle.seed(9)
        jcol = jsp.ColumnSequenceParallelLinear(16, 32, has_bias=False, gather_output=False)
        jrow = jsp.RowSequenceParallelLinear(32, 16, has_bias=True, input_is_parallel=True)
        tcol = _carry(jcol, tsp.ColumnSequenceParallelLinear(16, 32, has_bias=False))
        trow = _carry(jrow, tsp.RowSequenceParallelLinear(32, 16))
        assert tsp.is_sequence_parallel_parameter(trow.bias)
        rng = _rng(10)
        xv = rng.standard_normal((2, 8, 16)).astype(np.float32)
        dyv = rng.standard_normal((2, 8, 16)).astype(np.float32)

        def block(col, row, sp_mod):
            return lambda x: sp_mod.GatherOp.apply(row(col(sp_mod.ScatterOp.apply(x))))

        jl, tl = paddle.nn.Layer(), torch.nn.Module()
        jl.col, jl.row, tl.col, tl.row = jcol, jrow, tcol, trow
        jl.forward = block(jcol, jrow, jsp)
        tl.forward = block(tcol, trow, tsp)
        _same(_run_port(tl, xv, dyv), _run_jax(jl, xv, dyv))

    def test_marked_norm_weight_grad_is_the_mp_sum(self, hcgs):
        """The reference's analytic case at tp 2: the gradient of
        sum(scale * x) over a sequence-parallel x is x summed over ALL
        tokens; on the port's single controller the norm weight sees every
        token, so no hook is needed for it."""
        rng = _rng(11)
        xv = rng.standard_normal((2, 8, 4)).astype(np.float32)
        sv = rng.standard_normal((4,)).astype(np.float32)
        scale = torch.from_numpy(sv).requires_grad_()
        (scale * tsp.ScatterOp.apply(torch.from_numpy(xv))).sum().backward()
        np.testing.assert_allclose(scale.grad.numpy(), xv.sum(axis=(0, 1)), **F32_GRAD)
        norm = ptt.nn.RMSNorm(16)
        grads = []
        x16 = rng.standard_normal((2, 8, 16)).astype(np.float32)
        for sp in (True, False):
            norm.weight.grad = None
            x = torch.from_numpy(x16)
            norm(tsp.ScatterOp.apply(x) if sp else x).sum().backward()
            grads.append(norm.weight.grad.numpy().copy())
        np.testing.assert_allclose(grads[0], grads[1], **F32_GRAD)

    def _block(self):
        m = torch.nn.Module()
        m.norm = ptt.nn.RMSNorm(16)
        m.col = tsp.ColumnSequenceParallelLinear(16, 32, has_bias=False)
        m.row = tsp.RowSequenceParallelLinear(32, 16, has_bias=False)
        return m

    def test_hooks_mark_norms_not_tp_weights(self, hcgs):
        m = tsp.register_sequence_parallel_allreduce_hooks(self._block(), accumulation_steps=4)
        assert tsp.is_sequence_parallel_parameter(m.norm.weight)
        assert not tsp.is_sequence_parallel_parameter(m.col.weight)
        assert not tsp.is_sequence_parallel_parameter(m.row.weight)
        assert m.norm.weight._sp_accumulation_steps == 4
        p = torch.zeros(4)
        assert not tsp.is_sequence_parallel_parameter(p)
        tsp.mark_as_sequence_parallel_parameter(p)
        assert tsp.is_sequence_parallel_parameter(p)

    def test_hooks_fail_loudly(self, hcgs):
        with pytest.raises(NotImplementedError, match="fuse"):
            tsp.register_sequence_parallel_allreduce_hooks(
                self._block(), fuse_sequence_parallel_allreduce=True)
        with pytest.raises(ValueError, match="accumulation_steps"):
            tsp.register_sequence_parallel_allreduce_hooks(self._block(), accumulation_steps=0)
        with pytest.raises(NotImplementedError, match="fuse"):
            jsp.register_sequence_parallel_allreduce_hooks(
                paddle.nn.Layer(), fuse_sequence_parallel_allreduce=True)

    @pytest.mark.parametrize("flag,env,live_mp,want", [
        (True, "0", True, True), (False, "1", True, False), (None, "0", True, False),
        (None, "1", False, True), (None, None, True, True), (None, None, False, False)])
    def test_enabled_precedence(self, monkeypatch, flag, env, live_mp, want):
        if env is None:
            monkeypatch.delenv("PADDLE_TPU_SP", raising=False)
        else:
            monkeypatch.setenv("PADDLE_TPU_SP", env)
        saved = jtopo.get_hybrid_communicate_group(), topology.get_hybrid_communicate_group()
        shape = (4, 1, 1, 1, 2) if live_mp else (8, 1, 1, 1, 1)
        jtopo.set_hybrid_communicate_group(jtopo.HybridCommunicateGroup(
            dp=shape[0], mp=shape[4]))
        topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(
            mesh=_port_mesh(shape)))
        try:
            assert tsp.sequence_parallel_enabled(flag) is want
            assert jsp.sequence_parallel_enabled(flag) is want
            assert tsp.sp_fingerprint() == jsp.sp_fingerprint()
        finally:
            jtopo.set_hybrid_communicate_group(saved[0])
            topology.set_hybrid_communicate_group(saved[1])


# ---------------------------------------------------------------------------
# the mesh wrappers


def _meshes(**degrees):
    n = math.prod(degrees.values())
    jmesh = jtopo.build_mesh(dp=degrees.get("data", 1), sharding=degrees.get("sharding", 1),
                             sep=degrees.get("sep", 1), mp=degrees.get("model", 1),
                             devices=jax.devices()[:n])
    shape = tuple(degrees.get(a, 1) for a in topology._HYBRID_AXES)
    return jmesh, _port_mesh(shape)


def _qkv(seed, b=2, s=32, hq=4, hkv=4, d=16):
    rng = _rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for h in (hq, hkv, hkv))


FLASH_DEGREES = [({"sep": 4}, 4), ({"sep": 4}, 2), ({"data": 2, "model": 2}, 4),
                 ({"data": 2, "model": 2, "sep": 2}, 2)]


class TestMeshWrappers:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("degrees,hkv", FLASH_DEGREES,
                             ids=["sep4", "sep4_gqa", "dp2_mp2", "dp2_mp2_sep2_gqa"])
    def test_flash_against_the_reference(self, degrees, hkv, causal):
        jmesh, tmesh = _meshes(**degrees)
        q, k, v = _qkv(12, hkv=hkv)
        assert tsharded.mesh_flash_supported(tmesh, q.shape, k.shape, has_mask=False,
                                             dropout_p=0.0, causal=causal)
        assert jsharded.mesh_flash_supported(jmesh, q.shape, k.shape, has_mask=False,
                                             dropout_p=0.0, causal=causal)
        w = _rng(13).standard_normal(q.shape).astype(np.float32)

        def jloss(a, b, c):
            return jnp.sum(jsharded.mesh_flash_attention(a, b, c, jmesh, causal=causal,
                                                         interpret=True) * w)

        jout = jsharded.mesh_flash_attention(*map(jnp.asarray, (q, k, v)), jmesh,
                                             causal=causal, interpret=True)
        jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        tout = tsharded.mesh_flash_attention(tq, tk, tv, tmesh, causal=causal)
        (tout * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=2e-4,
                                   atol=2e-4)
        for t, j, name in zip((tq, tk, tv), jgrads, "qkv"):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=5e-4, atol=5e-4,
                                       err_msg=name)

    @pytest.mark.parametrize("degrees,hkv", [({"model": 2, "sep": 2}, 4),
                                             ({"data": 2, "model": 2, "sep": 2}, 2)])
    def test_ulysses_against_the_reference(self, degrees, hkv):
        jmesh, tmesh = _meshes(**degrees)
        q, k, v = _qkv(14, hq=8, hkv=hkv * 2)
        assert tsharded.mesh_ulysses_flash_supported(tmesh, q.shape, k.shape, has_mask=False,
                                                     dropout_p=0.0, causal=True)
        jout = jsharded.mesh_ulysses_flash(*map(jnp.asarray, (q, k, v)), jmesh, causal=True,
                                           interpret=True)
        tout = tsharded.mesh_ulysses_flash(*map(torch.from_numpy, (q, k, v)), tmesh,
                                           causal=True)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-4, atol=2e-4)
        assert not tsharded.mesh_ulysses_flash_supported(tmesh, (2, 32, 6, 16), (2, 32, 6, 16),
                                                         has_mask=False, dropout_p=0.0,
                                                         causal=True)
        with pytest.raises(ValueError, match="Ulysses flash"):
            tsharded.mesh_ulysses_flash(*(torch.zeros(2, 32, 6, 16) for _ in range(3)), tmesh)

    def test_rms_norm_and_rope_against_the_reference(self):
        from paddle_tpu.models.llama import _rope_tables as jax_rope_tables

        jmesh, tmesh = _meshes(data=2, sep=2)
        rng = _rng(15)
        x = rng.standard_normal((2, 16, 128)).astype(np.float32)
        w = rng.standard_normal((128,)).astype(np.float32)
        assert tsharded.mesh_rms_norm_supported(tmesh, x.shape)
        assert tsharded.mesh_rms_norm_supported(tmesh, x.shape) == \
            jsharded.mesh_rms_norm_supported(jmesh, x.shape)
        for shape in ((2, 12, 128), (3, 16, 128), (2, 16, 64)):
            assert tsharded.mesh_rms_norm_supported(tmesh, shape) == \
                jsharded.mesh_rms_norm_supported(jmesh, shape) is False
        jout = jsharded.mesh_rms_norm(jnp.asarray(x), jnp.asarray(w), jmesh, 1e-6,
                                      interpret=True)
        tout = tsharded.mesh_rms_norm(torch.from_numpy(x), torch.from_numpy(w), tmesh, 1e-6)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)
        q, k, _ = _qkv(16, s=16, hq=4, hkv=2, d=8)
        cos, sin = jax_rope_tables(8, 16, 10000.0)
        assert tsharded.mesh_rope_supported(tmesh, q.shape, k.shape)
        jq, jk = jsharded.mesh_rope(jnp.asarray(q), jnp.asarray(k), cos, sin, jmesh,
                                    interpret=True)
        tq, tk = tsharded.mesh_rope(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(np.asarray(cos)),
                                    torch.from_numpy(np.asarray(sin)), tmesh)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **F32)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32)

    def test_rope_mesh_with_model_axis_bit_equal(self):
        """Blocks are independent heads and rows: over data × sep × model
        the wrapper equals one call on the whole tensor, bit for bit, and
        its gradient equals the rotation by -theta."""
        from paddle_tpu_torch.models.llama import _rope_tables
        from paddle_tpu_torch.ops.rope import rope_plain

        _, tmesh = _meshes(data=2, sep=2, model=2)
        q, k, _ = (torch.from_numpy(a) for a in _qkv(17, b=2, s=16, hq=4, hkv=2, d=8))
        cos, sin = _rope_tables(8, 16, 10000.0)
        pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
        wq, wk = rope_plain(q, k, cos, sin, pos)
        gq, gk = tsharded.mesh_rope(q, k, cos, sin, tmesh)
        assert torch.equal(gq, wq) and torch.equal(gk, wk)

    def test_functional_ops_route_through_the_live_mesh(self, monkeypatch):
        """Under a live single-controller mesh, ``F.rms_norm``, SDPA and
        the Llama rope go through the wrappers (as the reference's do) and
        equal the unrouted ops; a multi-process mesh never routes."""
        from paddle_tpu_torch.models.llama import _rope_tables, apply_rotary_pos_emb

        calls = []
        for name in ("mesh_rms_norm", "mesh_flash_attention", "mesh_rope"):
            orig = getattr(tsharded, name)

            def spy(*a, _orig=orig, _name=name, **k):
                calls.append(_name)
                return _orig(*a, **k)
            monkeypatch.setattr(F if name != "mesh_rope" else
                                __import__("paddle_tpu_torch.models.llama",
                                           fromlist=["x"]), name, spy)
        rng = _rng(18)
        x = torch.from_numpy(rng.standard_normal((4, 16, 128)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((128,)).astype(np.float32))
        q, k, v = (torch.from_numpy(a) for a in _qkv(19, b=4, s=16, hq=4, hkv=2, d=16))
        cos, sin = _rope_tables(16, 64, 10000.0)

        def run():
            return (F.rms_norm(x, w, 1e-6),
                    F.scaled_dot_product_attention(q, k, v, is_causal=True),
                    *apply_rotary_pos_emb(q, k, cos, sin, position_offset=3))

        want = run()
        assert calls == []
        saved = topology.get_hybrid_communicate_group()
        topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(
            mesh=_port_mesh((2, 1, 1, 2, 2))))
        try:
            got = run()
            assert calls == ["mesh_rms_norm", "mesh_flash_attention", "mesh_rope"]
            mesh = topology.get_hybrid_communicate_group().mesh
            topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(
                mesh=topology.Mesh(mesh.devices, mesh.axis_names,
                                   np.zeros(mesh.devices.shape, dtype=int))))
            assert tsharded.active_mesh() is None
            run()
            assert len(calls) == 3
        finally:
            topology.set_hybrid_communicate_group(saved)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w_.numpy(), **F32)


# ---------------------------------------------------------------------------
# a model of mp_layers through convert.py


class _JaxTiny(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.embed = jmp.VocabParallelEmbedding(64, 16)
        self.up = jmp.ColumnParallelLinear(16, 32, gather_output=False)
        self.down = jmp.RowParallelLinear(32, 16, input_is_parallel=True)
        self.norm = paddle.nn.RMSNorm(16)

    def forward(self, ids):
        return self.norm(self.down(paddle.nn.functional.gelu(self.up(self.embed(ids)))))


class _PortTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = tmp.VocabParallelEmbedding(64, 16)
        self.up = tmp.ColumnParallelLinear(16, 32, gather_output=False)
        self.down = tmp.RowParallelLinear(32, 16, input_is_parallel=True)
        self.norm = ptt.nn.RMSNorm(16)

    def forward(self, ids):
        return self.norm(self.down(F.gelu(self.up(self.embed(ids)))))


def test_mp_layers_model_carries_across_by_state_dict(hcgs):
    paddle.seed(20)
    jm = _JaxTiny()
    tm = _PortTiny()
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: v.shape for k, v in jsd.items()}
    load_numpy_state_dict(tm, jsd)
    ids = _rng(21).integers(0, 64, (2, 8)).astype(np.int64)
    with jax_flag_guard(use_fused_rms_norm=False):
        want = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("make", [
    lambda m: m.PipelineLayer([], num_stages=2),
    lambda m: m.LayerDesc(torch.nn.Linear, 4, 4),
    lambda m: m.SharedLayerDesc("embed", torch.nn.Linear),
    lambda m: m.PipelineParallel(None),
    lambda m: m.PipelineParallelWithInterleave(None)],
    ids=["PipelineLayer", "LayerDesc", "SharedLayerDesc", "PipelineParallel",
         "PipelineParallelWithInterleave"])
def test_pipeline_names_import_and_wait_for_a6c(make):
    from paddle_tpu_torch.distributed import meta_parallel

    with pytest.raises(NotImplementedError, match="A6c"):
        make(meta_parallel)
