"""The port's context parallelism (B10's ring and Ulysses) against the JAX
package, on the CPU.

- ``ring_attention`` and ``ulysses_attention`` against the reference's
  ``context_parallel.ring_attention`` / ``ulysses_attention`` on a ``sep``
  mesh of the virtual CPU devices, cp 2 and 4, causal and not, GQA, b = 2:
  forward within rtol 1e-4 / atol 1e-5, the q/k/v grads of a weighted sum
  within 1e-3 / 1e-4 (the reference tests' tolerances,
  ``test_context_parallel.py``);
- the same forward and grads against ``ops/sharded.mesh_flash_attention``
  with ``interpret=True``: the Pallas ring itself (B3/B3b/B3c per hop), at
  the smallest shapes with two blocks a chunk;
- ``ring_merge_plain`` against the reference's ``ring_flash._merge``, with
  rows whose lse is -inf on either side or both;
- the hop schedule: diag, full and skip hops per member, and the copies
  that the chunking of a b = 2 tensor needs;
- the port's mesh (``distributed.topology``): repeated members, the sep
  getters, the hybrid group that ``ring_attention`` falls back on, and the
  axes that wait for the NCCL core.

The port's ring on the CPU runs the card's ring loop over the plain twins.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed.meta_parallel import ring_attention as jax_ring_attention
from paddle_tpu.distributed.meta_parallel import ulysses_attention as jax_ulysses_attention
from paddle_tpu.distributed.topology import build_mesh as jax_build_mesh
from paddle_tpu.framework.flags import flag_guard as jax_flag_guard
from paddle_tpu.ops.pallas import ring_flash as jax_ring_flash
from paddle_tpu.ops.sharded import mesh_flash_attention as jax_mesh_flash_attention

from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.distributed.meta_parallel import ring_attention, ulysses_attention
from paddle_tpu_torch.ops import LAUNCHES, ring_flash
from paddle_tpu_torch.ops.attention import sdpa_reference
from paddle_tpu_torch.ops.sharded import active_mesh, mesh_flash_supported

torch.set_num_threads(1)

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)


def _inputs(seed, b=2, s=16, hq=4, hkv=2, d=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    w = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    return q, k, v, w


def _port_mesh(n):
    return topology.build_mesh(sep=n, devices=["cpu"] * n)


def _jax_mesh(n):
    return jax_build_mesh(sep=n, devices=jax.devices()[:n])


def _port_grads(fn, q, k, v, w):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _jax_grads(fn, q, k, v, w):
    """The reference's out and the q/k/v grads of sum(out * w), in one
    jitted program (eager autodiff through the shard_map ring compiles
    piece by piece, ten times slower)."""
    def run(a, b, c):
        out, pull = jax.vjp(fn, a, b, c)
        return out, pull(jnp.asarray(w))

    out, grads = jax.jit(run)(*map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want, tol, what):
    for g, w_, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w_, **tol, err_msg=f"{what} d{name}")


class TestAgainstReference:
    @pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
    @pytest.mark.parametrize("n", [2, 4])
    def test_ring_attention(self, n, causal):
        q, k, v, w = _inputs(10 + n + causal)
        out, grads = _port_grads(
            lambda a, b, c: ring_attention(a, b, c, mesh=_port_mesh(n), causal=causal),
            q, k, v, w)
        jout, jgrads = _jax_grads(
            lambda a, b, c: jax_ring_attention(a, b, c, mesh=_jax_mesh(n),
                                               causal=causal)._value,
            q, k, v, w)
        np.testing.assert_allclose(out, jout, **FWD)
        _close(grads, jgrads, GRAD, "ring")

    @pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
    @pytest.mark.parametrize("n, hkv", [(2, 2), (4, 4)])
    def test_ulysses_attention(self, n, hkv, causal):
        q, k, v, w = _inputs(20 + n + causal, hkv=hkv)
        out, grads = _port_grads(
            lambda a, b, c: ulysses_attention(a, b, c, mesh=_port_mesh(n), is_causal=causal),
            q, k, v, w)
        jout, jgrads = _jax_grads(
            lambda a, b, c: jax_ulysses_attention(a, b, c, mesh=_jax_mesh(n),
                                                  is_causal=causal)._value,
            q, k, v, w)
        np.testing.assert_allclose(out, jout, **FWD)
        _close(grads, jgrads, GRAD, "ulysses")

    @pytest.mark.parametrize("n, causal", [(2, False), (2, True), (4, True)],
                             ids=["cp2-full", "cp2-causal", "cp4-causal"])
    def test_against_the_pallas_ring(self, n, causal):
        """The Pallas ring in interpret mode, with 8-row blocks so that
        each chunk of 16 rows has two."""
        q, k, v, w = _inputs(30 + n + causal, s=16 * n)
        out, grads = _port_grads(
            lambda a, b, c: ring_attention(a, b, c, mesh=_port_mesh(n), causal=causal),
            q, k, v, w)
        mesh = _jax_mesh(n)
        with jax_flag_guard(flash_block_q=8, flash_block_k=8):
            jout, jgrads = _jax_grads(
                lambda a, b, c: jax_mesh_flash_attention(a, b, c, mesh, causal=causal,
                                                         interpret=True),
                q, k, v, w)
        np.testing.assert_allclose(out, jout, **FWD)
        _close(grads, jgrads, GRAD, "pallas ring")

    def test_ring_merge_matches_reference_merge(self):
        rng = np.random.default_rng(5)
        b, c, h, d = 2, 6, 3, 8
        o = rng.standard_normal((b, c, h, d)).astype(np.float32)
        o_i = rng.standard_normal((b, c, h, d)).astype(np.float32)
        lse = rng.standard_normal((b, h, c)).astype(np.float32)
        lse_i = rng.standard_normal((b, h, c)).astype(np.float32)
        lse[0, 0, 0] = lse_i[0, 0, 0] = -np.inf   # no live key on either side
        o[0, 0, 0] = 0.0
        lse[1, 2, 3] = -np.inf                     # running side empty
        o[1, 3, 2] = 0.0
        lse_i[0, 1, 5] = -np.inf                   # block side empty
        o_i[0, 5, 1] = 0.0
        got_o, got_lse = ring_flash.ring_merge_plain(
            torch.from_numpy(o.copy()), torch.from_numpy(lse.copy()),
            torch.from_numpy(o_i), torch.from_numpy(lse_i))
        want_o, want_lse = jax_ring_flash._merge(
            jnp.asarray(o.transpose(0, 2, 1, 3)), jnp.asarray(lse[..., None]),
            jnp.asarray(o_i.transpose(0, 2, 1, 3)),
            jnp.broadcast_to(jnp.asarray(lse_i[..., None]), (b, h, c, 128)))
        np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o).transpose(0, 2, 1, 3),
                                   rtol=2e-6, atol=1e-6)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0],
                                   rtol=2e-6, atol=1e-6)
        assert got_lse[0, 0, 0] == -np.inf and not got_o[0, 0, 0].any()

    def test_ring_merge_wrapper_takes_the_plain_twin_on_cpu(self):
        o, lse = torch.zeros(1, 2, 1, 4), torch.full((1, 1, 2), float("-inf"))
        o_i, lse_i = torch.ones(1, 2, 1, 4), torch.zeros(1, 1, 2)
        before = LAUNCHES["ring_merge"]
        got = ring_flash.ring_merge(o, lse, o_i, lse_i)
        assert got[0] is o and torch.equal(o, o_i) and torch.equal(lse, lse_i)
        assert LAUNCHES["ring_merge"] == before


class TestSchedule:
    @pytest.mark.parametrize("n", [1, 2, 3, 4])
    def test_hop_counts_per_member(self, n):
        causal = ring_flash.hop_schedule(n, True)
        for r in range(n):
            kinds = [hop[r] for hop in causal]
            assert (kinds.count("diag"), kinds.count("full"), kinds.count("skip")) == \
                (1, r, n - 1 - r)
            assert kinds[0] == "diag"       # hop 0 is the member's own chunk
        assert all(kind == "full" for hop in ring_flash.hop_schedule(n, False) for kind in hop)

    def test_chunk_copies(self):
        q, k, v, _ = _inputs(40)
        mesh = _port_mesh(2)
        before = dict(ring_flash.COPIES)
        ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh=mesh, causal=True)
        # b = 2: each of q, k and v splits into 2 strided chunks, copied;
        # every member is the CPU, so no chunk moves between devices
        assert ring_flash.COPIES["chunk"] - before["chunk"] == 6
        assert ring_flash.COPIES["peer"] == before["peer"]
        before = dict(ring_flash.COPIES)
        ring_attention(*(torch.from_numpy(x[:1]) for x in (q, k, v)), mesh=mesh, causal=True)
        assert ring_flash.COPIES == before  # b = 1: contiguous slices

    def test_errors(self):
        q, k, v, _ = _inputs(41, s=15)
        mesh = _port_mesh(4)
        with pytest.raises(ValueError, match="not divisible"):
            ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh=mesh)
        q, k, v, _ = _inputs(42, hkv=3)
        with pytest.raises(ValueError, match="divide"):
            ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh=mesh)
        q, k, v, _ = _inputs(43)
        with pytest.raises(ValueError, match="divisible by the sep degree"):
            ulysses_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh=mesh)
        with pytest.raises(NotImplementedError, match="scale"):
            ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh=mesh, scale=0.5)


class TestTopology:
    def test_mesh_with_repeated_members(self):
        mesh = topology.build_mesh(sep=-1, devices=["cpu"] * 3)
        assert mesh.shape == {"data": 1, "pipe": 1, "sharding": 1, "sep": 3, "model": 1}
        assert mesh.axis_devices("sep") == [torch.device("cpu")] * 3
        hcg = topology.HybridCommunicateGroup(mesh=mesh)
        assert hcg.get_sep_parallel_world_size() == 3
        assert hcg.get_sep_parallel_group().nranks == 3
        assert hcg.get_sep_parallel_rank() == 0
        assert hcg.topology().get_dim("model") == 1
        assert hcg.topology().get_dim("sep") == 3

    def test_other_axes_wait_for_nccl(self):
        # the data axis runs since A6a, the model axis since A6b, pipe and
        # sharding since A6c
        assert topology.build_mesh(dp=2, devices=["cpu"] * 2).shape["data"] == 2
        mesh = topology.build_mesh(mp=-1, sep=2, devices=["cpu"] * 4)
        assert (mesh.shape["model"], mesh.shape["sep"]) == (2, 2)
        assert topology.build_mesh(pp=2, devices=["cpu"] * 2).shape["pipe"] == 2
        mesh = topology.build_mesh(sharding=2, devices=["cpu"] * 2)
        assert mesh.shape["sharding"] == 2
        assert topology.HybridCommunicateGroup(mesh=mesh).get_sharding_parallel_group() \
            .nranks == 2
        with pytest.raises(ValueError, match="multiply"):
            topology.build_mesh(sep=2, devices=["cpu"] * 3)

    def test_ring_attention_takes_the_hybrid_group(self):
        q, k, v, _ = _inputs(44)
        qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
        assert active_mesh() is None
        with pytest.raises(RuntimeError, match="needs a mesh"):
            ring_attention(qt, kt, vt)
        topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(
            mesh=_port_mesh(2)))
        try:
            assert active_mesh().shape["sep"] == 2
            assert mesh_flash_supported(active_mesh(), q.shape, k.shape, has_mask=False,
                                        dropout_p=0.0, causal=True)
            got = ring_attention(qt, kt, vt, causal=True)
        finally:
            topology.set_hybrid_communicate_group(None)
        want = sdpa_reference(qt, kt, vt, is_causal=True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)
