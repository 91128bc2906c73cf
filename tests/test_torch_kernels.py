"""The port's kernel functions against the JAX package's Pallas kernels.

The plain PyTorch version beside each hand-written Hopper kernel
(``paddle_tpu_torch/ops``) is what a CPU tensor runs, and what
``chip_smoke.py`` holds each kernel against on the card.  Here it is held
against the TPU kernel it replaces, run in Pallas interpret mode on the CPU
as ``tests/test_pallas_kernels.py`` and ``tests/test_decode_attention.py``
run it, on the same numpy inputs at f32.

Tolerances: ``tests/op_test.py``'s float32 row (rtol 2e-5, atol 1e-6) for
RMSNorm and RoPE; for the attention reductions it is loosened to rtol 1e-4,
atol 1e-5, because the online softmax sums its exponentials tile by tile in
another order than the one-pass softmax, and the difference grows with the
number of keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.generation import rope_with_row_offsets as jax_rope_rows
from paddle_tpu.models.llama import _rope_tables as jax_rope_tables
from paddle_tpu.ops.attention import sdpa_reference as jax_sdpa
from paddle_tpu.ops.pallas import decode_attention as jax_decode
from paddle_tpu.ops.pallas import flash_attention_varlen as jax_flash_varlen
from paddle_tpu.ops.pallas import fused_rope as jax_rope
from paddle_tpu.ops.pallas.flash_attention import _flash_fwd as jax_flash_fwd
from paddle_tpu.ops.pallas.flash_attention import _fwd as jax_flash_internal_fwd
from paddle_tpu.ops.pallas.flash_attention import _to_internal as jax_to_internal
from paddle_tpu.ops.pallas.fused_norm import _rms_fwd as jax_rms_fwd

import paddle_tpu_torch as ptt
from paddle_tpu_torch.generation import cached_attention, rope_with_row_offsets
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import LAUNCHES, _build, use_kernel
from paddle_tpu_torch.ops.attention import sdpa_reference
from paddle_tpu_torch.ops.decode_attention import decode_attention
from paddle_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                  flash_attention_plain)
from paddle_tpu_torch.ops.fused_norm import fused_rms_norm
from paddle_tpu_torch.ops.rope import fused_rope, rope_plain

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)
ATTN = dict(rtol=1e-4, atol=1e-5)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


class TestRMSNorm:
    @pytest.mark.parametrize("shape", [(16, 128), (2, 8, 256), (8, 64)])
    def test_plain_matches_pallas(self, shape):
        x, w = _np(0, *shape), 1 + 0.1 * _np(1, shape[-1])
        out, (_, _, rstd) = jax_rms_fwd(jnp.asarray(x), jnp.asarray(w), 1e-5, True)
        got, got_rstd = fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
        _close(got, out, F32)
        _close(got_rstd.reshape(-1, 1), rstd, F32)

    def test_functional_matches_numpy(self):
        x, w = _np(2, 4, 32), _np(3, 32)
        want = x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6) * w
        _close(F.rms_norm(torch.from_numpy(x), torch.from_numpy(w)), want, F32)


class TestRope:
    @pytest.mark.parametrize("offset", [0, 5])
    @pytest.mark.parametrize("hq,hk", [(4, 4), (4, 2)])
    def test_plain_matches_pallas(self, offset, hq, hk):
        b, s, d = 2, 16, 16
        q, k = _np(3, b, s, hq, d), _np(4, b, s, hk, d)
        cos, sin = jax_rope_tables(d, 64, 10000.0)
        oq, ok = jax_rope(jnp.asarray(q), jnp.asarray(k), cos[offset:offset + s],
                          sin[offset:offset + s], True)
        tc, ts = _rope_tables(d, 64, 10000.0)
        pos = (offset + torch.arange(s, dtype=torch.int32))[None].expand(b, s)
        gq, gk = fused_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts, pos)
        _close(gq, oq, F32)
        _close(gk, ok, F32)

    def test_tables_match(self):
        for a, b in zip(_rope_tables(32, 128, 10000.0), jax_rope_tables(32, 128, 10000.0)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    @pytest.mark.parametrize("pos", [0, 7])
    def test_row_offsets_match(self, pos):
        """Left-padded rows rotate at pos + j - pad (clipped at 0)."""
        b, s, h, d = 3, 4, 2, 16
        q, k = _np(5, b, s, h, d), _np(6, b, s, h, d)
        pads = np.asarray([0, 3, 9], np.int32)
        cos, sin = jax_rope_tables(d, 32, 10000.0)
        oq, ok = jax_rope_rows(jnp.asarray(q), jnp.asarray(k), cos, sin, pos,
                               jnp.asarray(pads))
        tc, ts = _rope_tables(d, 32, 10000.0)
        gq, gk = rope_with_row_offsets(torch.from_numpy(q), torch.from_numpy(k),
                                       tc, ts, pos, torch.from_numpy(pads))
        _close(gq, oq, F32)
        _close(gk, ok, F32)

    def test_positions_clip_into_table(self):
        q = torch.from_numpy(_np(7, 1, 2, 1, 8))
        tc, ts = _rope_tables(8, 4, 10000.0)
        lo, _ = rope_plain(q, q, tc, ts, torch.tensor([[-3, 9]], dtype=torch.int32))
        want, _ = rope_plain(q, q, tc, ts, torch.tensor([[0, 3]], dtype=torch.int32))
        torch.testing.assert_close(lo, want, rtol=0, atol=0)


class TestFlashAttention:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
    def test_plain_matches_pallas(self, causal, hq, hkv):
        b, s, d = 2, 32, 16
        q, k, v = _np(8, b, s, hq, d), _np(9, b, s, hkv, d), _np(10, b, s, hkv, d)
        out, (_, _, _, _, lse) = jax_flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, causal, 8, 8, True)
        got, got_lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), causal)
        _close(got, out, ATTN)
        _close(got_lse, np.asarray(lse)[..., 0], ATTN)

    @pytest.mark.parametrize("causal", [False, True])
    def test_rectangular_causal_bottom_right(self, causal):
        """sq < sk: query row i sees keys <= i + sk - sq."""
        q, k, v = _np(11, 1, 16, 2, 16), _np(12, 1, 40, 2, 16), _np(13, 1, 40, 2, 16)
        out, _ = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None, causal, 8, 8, True)
        got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal)[0]
        _close(got, out, ATTN)

    @pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
    def test_varlen_matches_pallas(self, hq, hkv):
        """Row 1's pad (11) covers a whole 8-row query tile; its rows inside
        the padding are exact zeros in both."""
        b, s, d = 3, 24, 16
        q, k, v = _np(14, b, s, hq, d), _np(15, b, s, hkv, d), _np(16, b, s, hkv, d)
        pads = np.asarray([0, 11, 3], np.int32)
        out = jax_flash_varlen(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pads), block_q=8, block_k=8, interpret=True)
        got, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), True, torch.from_numpy(pads))
        _close(got, out, ATTN)
        assert not got[1, :11].any() and torch.isfinite(got).all()
        assert torch.isneginf(lse[1, :, :11]).all() and torch.isfinite(lse[1, :, 11:]).all()

    # the head dims the wgmma forward compiles (DP 64 and 128), at tiles of
    # 64 rows as the card's kernel takes them
    @pytest.mark.parametrize("d", [64, 128])
    def test_gqa_4_to_1_matches_pallas(self, d):
        q, k, v = _np(24, 2, 128, 8, d), _np(25, 2, 128, 2, d), _np(26, 2, 128, 2, d)
        out, (_, _, _, _, lse) = jax_flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, True, 64, 64, True)
        got, got_lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), True)
        _close(got, out, ATTN)
        _close(got_lse, np.asarray(lse)[..., 0], ATTN)

    @pytest.mark.parametrize("d", [64, 128])
    def test_causal_sq_below_sk_matches_pallas(self, d):
        """offset = sk - sq = 128: query row i sees keys <= i + 128."""
        q, k, v = _np(27, 1, 64, 4, d), _np(28, 1, 192, 2, d), _np(29, 1, 192, 2, d)
        out, (_, _, _, _, lse) = jax_flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, True, 64, 64, True)
        got, got_lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), True)
        _close(got, out, ATTN)
        _close(got_lse, np.asarray(lse)[..., 0], ATTN)

    @pytest.mark.parametrize("d", [64, 128])
    def test_varlen_pad_over_a_whole_block_matches_pallas(self, d):
        """Row 1's pad (100) covers the first 64-row query block and more:
        its padded rows are exact zeros with lse -inf, as in the Pallas
        kernel."""
        b, s, hq, hkv = 2, 192, 4, 2
        q, k, v = _np(30, b, s, hq, d), _np(31, b, s, hkv, d), _np(32, b, s, hkv, d)
        pads = np.asarray([0, 100], np.int32)
        out, lse = jax_flash_internal_fwd(
            *(jax_to_internal(jnp.asarray(x)) for x in (q, k, v)), scale=1.0 / np.sqrt(d),
            causal=True, block_q=64, block_k=64, interpret=True, pad_lens=jnp.asarray(pads))
        got, got_lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), True, torch.from_numpy(pads))
        _close(got, np.asarray(out).transpose(0, 2, 1, 3), ATTN)
        _close(got_lse, np.asarray(lse)[..., 0], ATTN)
        assert not got[1, :100].any() and torch.isfinite(got).all()
        assert torch.isneginf(got_lse[1, :, :100]).all()
        assert torch.isfinite(got_lse[1, :, 100:]).all() and torch.isfinite(got_lse[0]).all()

    def test_sdpa_reference_matches_jax(self):
        q, k, v = _np(17, 2, 8, 4, 16), _np(18, 2, 8, 2, 16), _np(19, 2, 8, 2, 16)
        mask = np.where(_np(20, 2, 1, 1, 8) > 0, 0.0, -1e9).astype(np.float32)
        want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        mask=jnp.asarray(mask), is_causal=True)
        got = sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(mask), True)
        _close(got, want, ATTN)

    def test_functional_routes_unmasked_causal_to_flash_function(self):
        q, k, v = (torch.from_numpy(_np(i, 1, 8, 2, 16)) for i in (21, 22, 23))
        got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.testing.assert_close(got, sdpa_reference(q, k, v, is_causal=True),
                                   **ATTN)


class TestDecodeAttention:
    def _case(self, seed, b, h, kv, d, C):
        return [_np(seed + i, *shape) for i, shape in enumerate(
            [(b, 1, h, d), (b, 1, kv, d), (b, 1, kv, d), (b, C, kv, d), (b, C, kv, d)])]

    def _run_both(self, arrays, pos, pads, blk):
        q, kn, vn, ck, cv = arrays
        jp = None if pads is None else jnp.asarray(pads)
        out, jck, jcv = jax_decode(*(jnp.asarray(a) for a in arrays), pos, jp,
                                   block_k=blk, interpret=True)
        tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        tp = None if pads is None else torch.from_numpy(pads)
        got, rk, rv = decode_attention(torch.from_numpy(q), torch.from_numpy(kn),
                                       torch.from_numpy(vn), tck, tcv, pos, tp)
        assert rk is tck and rv is tcv  # the caller's caches, updated in place
        return (out, jck, jcv), (got, tck, tcv)

    @pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1)])
    @pytest.mark.parametrize("pos", [21, 32])  # 32 sits on a block boundary
    def test_plain_matches_pallas(self, h, kv, pos):
        arrays = self._case(30, 2, h, kv, 16, 64)
        (out, _, _), (got, _, _) = self._run_both(arrays, pos, None, 16)
        _close(got, out, ATTN)

    def test_padded_rows_and_pad_at_or_past_pos(self):
        """Per-row left padding, with one row whose pad equals pos and one
        past it: those rows attend only their new token."""
        pos = 12
        pads = np.asarray([0, 5, pos, 20], np.int32)
        arrays = self._case(40, 4, 4, 2, 16, 32)
        (out, _, _), (got, _, _) = self._run_both(arrays, pos, pads, 16)
        _close(got, out, ATTN)
        vn = torch.from_numpy(arrays[2])
        torch.testing.assert_close(got[3].reshape(2, 2, 16),
                                   vn[3, 0][:, None, :].expand(2, 2, 16), **F32)

    def test_append_writes_row_pos_only(self):
        pos = 16
        arrays = self._case(50, 2, 4, 2, 16, 32)
        (_, jck, jcv), (_, tck, tcv) = self._run_both(arrays, pos, None, 16)
        np.testing.assert_array_equal(tck.numpy(), np.asarray(jck))
        np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv))
        _, kn, vn, ck, cv = arrays
        np.testing.assert_array_equal(tck[:, pos].numpy(), kn[:, 0])
        np.testing.assert_array_equal(tcv[:, pos].numpy(), vn[:, 0])
        for got, orig in ((tck, ck), (tcv, cv)):
            np.testing.assert_array_equal(np.delete(got.numpy(), pos, axis=1),
                                          np.delete(orig, pos, axis=1))

    def test_rejects_pos_outside_cache(self):
        arrays = [torch.from_numpy(a) for a in self._case(60, 1, 2, 2, 8, 8)]
        with pytest.raises(ValueError, match="outside the cache"):
            decode_attention(*arrays, 8)

    def test_cached_attention_decode_step_matches_dense_reference(self):
        """generation.cached_attention's s == 1 step against the grouped
        einsum it replaces (the reference's path with the kernel off)."""
        q, kn, vn, ck, cv = (torch.from_numpy(a) for a in self._case(70, 2, 4, 2, 16, 24))
        pads = torch.tensor([0, 4], dtype=torch.int32)
        got, _, _ = cached_attention(q, kn, vn, ck.clone(), cv.clone(), 9, pads)
        ck2, cv2 = ck.clone(), cv.clone()
        ck2[:, 9], cv2[:, 9] = kn[:, 0], vn[:, 0]
        keys, vals = ck2[:, :10].repeat_interleave(2, 2), cv2[:, :10].repeat_interleave(2, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, keys) / 4.0
        s = s.masked_fill(torch.arange(10) < pads[:, None, None, None], float("-inf"))
        want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vals)
        torch.testing.assert_close(got, want, **ATTN)


class TestSeamAndBuild:
    def test_cpu_tensors_take_the_plain_versions(self):
        before = dict(LAUNCHES)
        x = torch.ones(2, 8)
        assert not use_kernel("use_fused_rms_norm", x)
        F.rms_norm(x, torch.ones(8))
        fused_rms_norm(x, torch.ones(8))
        assert LAUNCHES == before

    def test_flags_keep_reference_names(self):
        names = ["use_fused_rms_norm", "use_fused_rope", "use_flash_attention",
                 "use_decode_attention", "use_fused_swiglu", "flash_block_q",
                 "flash_block_k", "decode_block_k", "generate_cache_size"]
        assert set(names) <= set(ptt.get_flags())
        with ptt.flag_guard(use_flash_attention=False):
            assert ptt.get_flags("use_flash_attention") == {"use_flash_attention": False}
        assert ptt.get_flags("use_flash_attention")["use_flash_attention"] is True
        with pytest.raises(KeyError):
            ptt.set_flags({"no_such_flag": 1})

    def test_build_needs_nvcc(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build.shutil, "which", lambda *_: None)
        monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
        with pytest.raises(RuntimeError, match="nvcc was not found"):
            _build.build(["rms_norm"])

    def test_build_target_follows_the_sources(self, monkeypatch, tmp_path):
        for src in _build.CSRC.iterdir():
            (tmp_path / src.name).write_bytes(src.read_bytes())
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        before = {n: _build._target(n) for n in _build.SOURCES}
        (tmp_path / "rope.cu").write_text("// edited\n", encoding="utf-8")
        after = {n: _build._target(n) for n in _build.SOURCES}
        assert after["rope"] != before["rope"]
        assert all(after[n] == before[n] for n in _build.SOURCES if n != "rope")
        (tmp_path / "common.cuh").write_text("// edited\n", encoding="utf-8")
        assert all(_build._target(n) != after[n] for n in _build.SOURCES)
