"""The port's tensor-parallel serving engine (``ServingEngine(tp=n)``,
ROADMAP A6b) against the JAX engine, on the CPU (the counterpart of
``test_disagg.py``'s ``TestTPDecode``).

``llama_tiny`` (2 layers, vocab 96, f32, the JAX model's weights carried
across), ``test_disagg.py``'s prompts (5, 11 and 20 tokens, eos 5):
- ``tp=2`` token-exact against the JAX engine with ``tp=2`` (its params
  and arenas on a two-device ``model`` mesh) and against the port's
  ``tp=1``, on f32, int8 and fp8 pages; each member's arenas hold its kv
  heads; pool bytes a token in all and a member;
- ``tp=3`` raises "must divide", ``tp=2`` with ``cp=2`` raises, and
  ``PADDLE_TPU_SERVE_TP=2`` builds a TP engine; the members wrap
  round-robin over the visible devices; the model's split parameters keep
  their global shapes;
- under ``tp=2``: the prefix cache, the offload tier under pool pressure,
  page frames crossing between ``tp=1`` and ``tp=2`` engines (exported by
  one, imported by the other, decoded from), ``recover()`` from a journal
  and ``speculative=3``, each token-exact against ``tp=1``.

Engine sizes are explicit: ``tests/conftest.py`` pins the serving
environment variables for the whole suite.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.engine import Request as JaxRequest

from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.serving import ServingEngine, TokenSink
from paddle_tpu_torch.serving import disagg
from paddle_tpu_torch.serving.engine import Request

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

TINY = dict(num_hidden_layers=2, vocab_size=96, max_position_embeddings=128)
KW = dict(max_batch=3, page_tokens=8, num_pages=32, max_pages_per_seq=6)
OFFLOAD_KW = dict(max_batch=2, page_tokens=8, num_pages=9, max_pages_per_seq=8)
KINDS = ["bf16", "int8", "fp8"]


@pytest.fixture(autouse=True)
def _request_ids():
    """Both packages number requests from a class counter; restore them."""
    saved = JaxRequest._next_rid, Request._next_rid
    yield
    JaxRequest._next_rid, Request._next_rid = saved


def _jax_model():
    """A fresh same-seeded JAX model per engine: a tp > 1 JAX engine
    commits the parameters onto its mesh in place."""
    paddle.seed(3)
    m = JaxLlama(jax_llama_tiny(**TINY))
    m.eval()
    return m


_WEIGHTS = {}


def _model():
    """A fresh port model with the JAX model's weights: a tp > 1 engine
    takes its model's parameters for itself."""
    if not _WEIGHTS:
        _WEIGHTS.update({k: np.asarray(v.numpy())
                         for k, v in _jax_model().state_dict().items()})
    tm = LlamaForCausalLM(llama_tiny(**TINY), device="cpu")
    load_numpy_state_dict(tm, _WEIGHTS)
    return tm.eval()


def _prompts(seed=0, lens=(5, 11, 20)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, n).astype(np.int32) for n in lens]


def _serve(eng, prompts, max_new=6, eos=5):
    rids = [eng.submit(p, max_new_tokens=max_new, eos_token_id=eos) for p in prompts]
    outs = eng.run()
    eng.pool.check_leaks(allow_shared=eng.prefix is not None) \
        if isinstance(eng, ServingEngine) else eng.pool.check_leaks()
    return [list(outs[r]) for r in rids]


@pytest.mark.parametrize("kv_dtype", KINDS)
def test_tp2_token_exact_vs_jax_tp2_and_tp1(kv_dtype):
    prompts = _prompts()
    eng = ServingEngine(_model(), tp=2, kv_dtype=kv_dtype, **KW)
    assert eng.tp == 2 and len(eng._shards) == 2
    kv, d = 2, 16                     # llama_tiny: 2 kv heads of 16
    for key, arrs in eng._arenas.items():
        want = (32, 8, kv // 2, d) if key in ("k", "v") else (32, 8, kv // 2)
        assert all(tuple(a.shape) == want for ar in eng._shards for a in ar[key]), key
    got = _serve(eng, prompts)
    tp1 = _serve(ServingEngine(_model(), kv_dtype=kv_dtype, **KW), prompts)
    jeng = JaxEngine(_jax_model(), tp=2, kv_dtype=kv_dtype, **KW)
    assert jeng._mesh is not None and jeng.tp == 2
    want = _serve(jeng, prompts)
    assert got == want
    assert got == tp1
    s = eng.meter.summary()
    assert s["kv_bytes_per_token"] == jeng.meter.summary()["kv_bytes_per_token"]
    assert eng.meter.kv_bytes_per_token_member == s["kv_bytes_per_token"] / 2
    assert eng.pool.member_bytes_per_token() == eng.pool.bytes_per_token() / 2


def test_refusals_and_env(monkeypatch):
    with pytest.raises(ValueError, match="must divide"):
        ServingEngine(_model(), tp=3, **KW)
    with pytest.raises(ValueError, match="must divide"):
        JaxEngine(_jax_model(), tp=3, **KW)
    with pytest.raises(ValueError, match="cannot combine"):
        ServingEngine(_model(), tp=2, cp=2, **KW)
    monkeypatch.setenv("PADDLE_TPU_SERVE_TP", "2")
    eng = ServingEngine(_model(), **KW)
    assert eng.tp == 2 and eng.tp_devices == [torch.device("cpu")] * 2
    assert eng.meter.kv_bytes_per_token_member * 2 == eng.meter.kv_bytes_per_token


def test_members_wrap_and_params_keep_global_shapes():
    """Members go round-robin over the visible devices from the model's;
    each split parameter keeps its global [in, out] shape and gains one
    view a member (no copy on a shared device)."""
    mesh = disagg.decode_mesh(4, devices=["cpu", "cpu"])
    assert mesh.axis_devices("model") == [torch.device("cpu")] * 4
    tm = _model()
    n = disagg.shard_llama_params(tm, disagg.decode_mesh(2, devices=["cpu"]))
    assert n == 2 * 7
    q = tm.llama.layers[0].self_attn.q_proj.weight
    o = tm.llama.layers[0].self_attn.o_proj.weight
    assert tuple(q.shape) == (64, 64) and (q.split_axis, vars(q)["is_distributed"]) == (1, True)
    assert [tuple(s.shape) for s in q.shards] == [(64, 32), (64, 32)]
    assert [tuple(s.shape) for s in o.shards] == [(32, 64), (32, 64)]
    assert q.shards[1].untyped_storage().data_ptr() == q.untyped_storage().data_ptr()
    assert not hasattr(tm.llama.embed_tokens.weight, "shards")
    assert disagg.arena_partition_spec("ks") == (None, None, "model")
    assert disagg.arena_partition_spec("k") == (None, None, "model", None)
    arenas = {"k": [torch.arange(2 * 1 * 4 * 3.0).reshape(2, 1, 4, 3)],
              "ks": [torch.arange(8.0).reshape(2, 1, 4)]}
    shards = disagg.shard_arenas(arenas, disagg.decode_mesh(2, devices=["cpu"]))
    assert torch.equal(torch.cat([s["k"][0] for s in shards], 2), arenas["k"][0])
    assert torch.equal(torch.cat([s["ks"][0] for s in shards], 2), arenas["ks"][0])
    assert all(s["k"][0].is_contiguous() for s in shards)


def test_prefix_cache_token_exact():
    rng = np.random.default_rng(2)
    shared = list(rng.integers(1, 96, 17))
    prompts = [np.asarray(shared + list(rng.integers(1, 96, n)), np.int32) for n in (5, 7, 3)]
    outs = {}
    for tp in (1, 2):
        eng = ServingEngine(_model(), tp=tp, prefix_cache=16, **KW)
        outs[tp] = [_serve(eng, [p], max_new=8, eos=None)[0] for p in prompts]
        assert eng.prefix.summary()["hits"] == 2
    assert outs[1] == outs[2]


@pytest.mark.parametrize("kv_dtype", KINDS)
def test_offload_round_trip_token_exact(kv_dtype):
    """Two 20-token prompts outgrow a 9-page pool: the victim's pages go
    to the host tier and back (each frame joining and splitting the
    members' kv heads), and the streams equal the roomy tp=1 engine's."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 96, 20).astype(np.int32) for _ in range(2)]
    want = _serve(ServingEngine(_model(), kv_dtype=kv_dtype, **dict(OFFLOAD_KW, num_pages=32)),
                  prompts, max_new=20, eos=None)
    eng = ServingEngine(_model(), tp=2, offload=True, kv_dtype=kv_dtype, **OFFLOAD_KW)
    got = _serve(eng, prompts, max_new=20, eos=None)
    s = eng.meter.summary()
    assert s["kv_offloads"] >= 1 and s["kv_recalls"] >= 1 and s["evictions"] == 0
    assert got == want


@pytest.mark.parametrize("kv_dtype", KINDS)
@pytest.mark.parametrize("src_tp,dst_tp", [(1, 2), (2, 1)])
def test_frames_cross_between_tp1_and_tp2(kv_dtype, src_tp, dst_tp):
    """A request's pages exported by one engine and imported into another
    of the other ``tp`` hold every kv head: exported again they are the
    same bytes, and the next decode step's logits from them equal the
    source engine's."""
    p = _prompts(3, (19,))[0]
    src = ServingEngine(_model(), tp=src_tp, kv_dtype=kv_dtype, **KW)
    dst = ServingEngine(_model(), tp=dst_tp, kv_dtype=kv_dtype, **KW)
    rid = src.submit(p, max_new_tokens=6)
    src.step()
    src.step()
    r = src._active[0]
    pages = src.pool.table(rid)
    frames = src._export_pages(pages)
    assert all(f["k"].shape == (2, 8, 2, 16) for f in frames)
    dst.pool.alloc("moved", len(pages))
    dst_pages = dst.pool.table("moved")
    dst._import_pages(dst_pages, frames)
    back = dst._export_pages(dst_pages)
    for a, b in zip(frames, back):
        for key in a:
            assert torch.equal(a[key].view(torch.uint8), b[key].view(torch.uint8)), key

    def step_logits(eng, table):
        tok = torch.tensor([[r.generated[-1]]])
        t = np.full((1, eng.max_pages_per_seq), 0, np.int64)
        t[0, :len(table)] = table
        return eng._forward(tok, torch.tensor([r.pos]), torch.from_numpy(t),
                            torch.tensor([1]))[0, 0]

    np.testing.assert_allclose(step_logits(dst, dst_pages).numpy(),
                               step_logits(src, pages).numpy(), rtol=1e-5, atol=1e-5)


def test_recover_token_exact(tmp_path):
    """A tp=2 engine abandoned mid-stream, recovered into a fresh tp=2
    engine from its journal: every stream equals tp=1's, every sink token
    once."""
    prompts = _prompts(11, (5, 9, 7))
    want = _serve(ServingEngine(_model(), **KW), prompts, eos=None)
    jdir, spath = str(tmp_path / "j"), str(tmp_path / "out.jsonl")
    sink = TokenSink(spath)
    eng = ServingEngine(_model(), tp=2, journal=jdir, on_token=sink, **KW)
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    for _ in range(2):
        eng.step()
    assert TokenSink.collect(spath) and not eng._results
    sink.close()
    sink = TokenSink(spath)
    eng2 = ServingEngine(_model(), tp=2, journal=jdir, on_token=sink, **KW)
    info = eng2.recover()
    outs = eng2.run()
    sink.close()
    assert info["replayed"] == 3
    streams = TokenSink.collect(spath)          # raises on a duplicate
    for r, w in zip(rids, want):
        assert list(outs[r]) == w and streams[r] == w


def test_speculative_token_exact():
    """``speculative=3`` under tp=2: every decode forward is 4 wide over
    the members, and the streams equal the serial tp=1 engine's."""
    rng = np.random.default_rng(5)
    base = list(rng.integers(1, 96, 6))
    prompts = [np.asarray(base * 3 + list(rng.integers(1, 96, n)), np.int32) for n in (2, 4)]
    want = _serve(ServingEngine(_model(), **KW), prompts, max_new=12, eos=None)
    eng = ServingEngine(_model(), tp=2, speculative=3, **KW)
    assert eng._spec_width == 4
    assert _serve(eng, prompts, max_new=12, eos=None) == want


def test_sharded_decode_gate():
    """``decode_attention_sharded_supported`` answers for the H100 decode
    kernels on a member's shapes: the reference's cases, except that the
    TPU cache-length rule (C >= block_k) does not apply."""
    from paddle_tpu.ops.pallas.decode_attention import \
        decode_attention_sharded_supported as jax_ok
    from paddle_tpu_torch.ops.decode_attention import \
        decode_attention_sharded_supported as ok

    cases = [((4, 1, 8, 64), (4, 256, 4, 64), dict(tp=2)),
             ((4, 1, 8, 64), (4, 256, 4, 64), dict(tp=1)),
             ((4, 1, 8, 64), (4, 256, 4, 64), dict(tp=4, int8=True)),
             ((4, 1, 8, 64), (4, 256, 4, 64), dict(tp=4, fp8=True)),
             ((4, 1, 8, 64), (4, 256, 4, 64), dict(tp=3)),           # ragged
             ((4, 1, 8), (4, 256, 4, 64), dict(tp=2)),               # rank
             ((4, 2, 8, 64), (4, 256, 4, 64), dict(tp=2)),           # two query tokens
             ((4, 1, 8, 64), (4, 256, 4, 64), dict(tp=2, int8=True, fp8=True))]
    for q, c, kw in cases:
        assert ok(q, c, **kw) == jax_ok(q, c, **kw), (q, c, kw)
    assert ok((4, 1, 8, 64), (4, 128, 4, 64), tp=2)              # C < block_k: the departure
    assert not jax_ok((4, 1, 8, 64), (4, 128, 4, 64), tp=2)
    assert not ok((4, 1, 8, 72), (4, 256, 4, 72), tp=2, int8=True)   # int8 d % 16
    # the kernel_fallback events (A8) are ported: an accepted shape records none
    assert ok((4, 1, 8, 64), (4, 256, 4, 64), tp=2, emit_fallback=True)
