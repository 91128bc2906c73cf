"""The port's disaggregated prefill (``serving/disagg.py``: the page
frames, ``PrefillWorker``, ``take_prefilled``, ``DisaggCoordinator``; the
engine's ``prefill_export`` and ``submit_prefilled``) against the JAX
package's, on the CPU.

- The reference's ``tests/test_disagg.py`` classes of this slice run on
  the port through ``port_reference``: the frames, the depot's KV stream
  (one-shot take, commit, fencing), the prefill tier end to end with a
  worker's death mid-stream, the router's tiers, the report and the fleet
  meter.  Its copy-on-write pool, prefix cache and TP decode classes are
  held by earlier slices' files (``test_torch_prefix_offload.py``,
  ``test_torch_tp_serving.py``).  A frame's planes unpack as host torch
  tensors here (the reference's numpy arrays need ``ml_dtypes`` for bf16
  and e4m3), so the round trip compares their dtypes by name.
- Frames cross the packages: pages the JAX engine exported, packed by the
  JAX package, unpack in the port and decode token-exact after
  ``submit_prefilled``, and the other way round, for f32 and int8 pages; a bf16 and an e4m3 plane cross by bytes.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.disagg import pack_kv_frame as jax_pack
from paddle_tpu.serving.disagg import unpack_kv_frame as jax_unpack

from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.models import LlamaForCausalLM as TorchLlama
from paddle_tpu_torch.models import llama_tiny
from paddle_tpu_torch.serving import ServingEngine as TorchEngine
from paddle_tpu_torch.serving.disagg import pack_kv_frame as torch_pack
from paddle_tpu_torch.serving.disagg import unpack_kv_frame as torch_unpack

from test_torch_telemetry import _port_on_cpu, port_reference  # noqa: F401

torch.set_num_threads(1)

port_reference(
    "test_disagg", globals(),
    drop=("TestCOWPool", "TestPrefixCache", "TestPrefixEngine", "TestTPDecode"),
    subs=[("from paddle_tpu_torch.ops.pallas.decode_attention import",
           "from paddle_tpu_torch.ops.decode_attention import"),
          ("            assert rt[k].dtype == frame[k].dtype",
           "            assert str(rt[k].dtype).split('.')[-1] == str(frame[k].dtype)")])


ENGINE = dict(max_batch=2, page_tokens=8, num_pages=24, max_pages_per_seq=6)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(3)
    jm = JaxLlama(jax_llama_tiny(num_hidden_layers=2, vocab_size=96,
                                 max_position_embeddings=128))
    jm.eval()
    tm = TorchLlama(llama_tiny(num_hidden_layers=2, vocab_size=96,
                               max_position_embeddings=128), device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


PROMPTS = [np.random.default_rng(s).integers(1, 96, n).astype(np.int32)
           for s, n in ((0, 23), (1, 17))]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_frames_cross_the_packages_token_exact(pair, kv_dtype, direction):
    jm, tm = pair
    kw = dict(ENGINE, kv_dtype="int8") if kv_dtype == "int8" else ENGINE
    jex, tex = JaxEngine(jm, **kw), TorchEngine(tm, **kw)
    jdec, tdec = JaxEngine(jm, **kw), TorchEngine(tm, **kw)
    local = TorchEngine(tm, **kw)
    lrids = [local.submit(p, max_new_tokens=6) for p in PROMPTS]
    louts = local.run()
    src, dst = (jex, tdec) if direction == "jax_to_port" else (tex, jdec)
    pack, unpack = (jax_pack, torch_unpack) if direction == "jax_to_port" \
        else (torch_pack, jax_unpack)
    rids = []
    for p in PROMPTS:
        first, frames = src.prefill_export(p)
        wire = [unpack(pack(f)) for f in frames]
        assert len(wire) == -(-len(p) // ENGINE["page_tokens"])
        assert sorted(wire[0]) == (["k", "ks", "v", "vs"] if kv_dtype == "int8" else ["k", "v"])
        rids.append(dst.submit_prefilled(p, first, wire, max_new_tokens=6))
    outs = dst.run()
    for rid, lrid in zip(rids, lrids):
        assert [int(t) for t in outs[rid]] == [int(t) for t in louts[lrid]], (rid, direction)


def test_a_frame_packs_to_the_same_bytes_in_both_packages(pair):
    """The port's frames (torch tensors) pack to the reference's bytes for
    the same values (numpy arrays)."""
    rng = np.random.default_rng(5)
    frame = {"k": rng.standard_normal((2, 8, 2, 16)).astype(np.float32),
             "ks": rng.standard_normal((2, 8, 2)).astype(np.float32),
             "v": rng.integers(-127, 128, (2, 8, 2, 16)).astype(np.int8)}
    assert torch_pack({k: torch.from_numpy(v) for k, v in frame.items()}) == jax_pack(frame)
    assert torch_pack(frame) == jax_pack(frame)


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn"])
def test_low_precision_planes_cross_by_bytes(dtype):
    import ml_dtypes

    vals = np.random.default_rng(9).standard_normal((2, 8, 2, 16)).astype(np.float32)
    arr = vals.astype(getattr(ml_dtypes, dtype))
    t = torch.from_numpy(vals).to(getattr(torch, dtype))
    mine = torch_unpack(jax_pack({"k": arr}))["k"]
    assert mine.dtype == t.dtype and torch.equal(mine.view(torch.uint8), t.view(torch.uint8))
    theirs = jax_unpack(torch_pack({"k": t}))["k"]
    assert theirs.dtype == arr.dtype
    np.testing.assert_array_equal(theirs.view(np.uint8), arr.view(np.uint8))
