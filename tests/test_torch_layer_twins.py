"""The models and the engines' layer stacks are the port's ``nn.Layer``s,
as the reference's are (ROADMAP §C8): ``sublayers()``,
``named_sublayers()``, ``full_name()``, ``parameters()``,
``clear_gradients()`` and ``set_state_dict()`` give the reference's
results, family by family (Llama, GPT, the hybrid Llama, the pipeline
engines and ``PipelineLayer``, a loaded ``TranslatedLayer``), on the same
numpy weights.  A plain tensor attribute of a model (the rope tables, an
MoE layer's ``l_aux``) adds no ``state_dict`` key.
"""

import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
from paddle_tpu import jit as jjit
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_moe_tiny as jax_llama_moe_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.models import GPTForCausalLM, LlamaForCausalLM, gpt_tiny, llama_moe_tiny
from paddle_tpu_torch.models import llama_tiny
from paddle_tpu_torch.nn import Layer

from test_torch_hybrid import _clear_groups, _hcgs, _np  # noqa: F401
from test_torch_pipeline import _jmesh, _pmesh

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")
    yield


def _stem(name: str) -> str:
    """A full name without its instance counter (``llamaforcausallm_3``)."""
    return re.sub(r"_\d+$", "", name)


def _same_layer_api(tm, jm, *, classes=True):
    assert isinstance(tm, Layer)
    if classes:
        assert [type(s).__name__ for s in tm.sublayers()] == \
            [type(s).__name__ for s in jm.sublayers()]
    assert [n for n, _ in tm.named_sublayers()] == [n for n, _ in jm.named_sublayers()]
    assert _stem(tm.full_name()) == _stem(jm.full_name())
    params = tm.parameters()
    assert isinstance(params, list) and len(params) == len(jm.parameters())
    assert list(tm.state_dict()) == list(jm.state_dict())
    # set_state_dict takes the reference's values (numpy), every key
    state = _np(jm.state_dict())
    tm.set_state_dict(state)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.detach().float().numpy(), state[k].astype(np.float32),
                                      err_msg=k)


def _cleared(tm, loss):
    loss.backward()
    assert any(p.grad is not None for p in tm.parameters())
    tm.clear_gradients()
    assert all(p.grad is None for p in tm.parameters())


def _cleared_reference(jm, loss):
    loss.backward()
    jm.clear_gradients()
    assert all(p.grad is None for p in jm.parameters())


IDS = np.random.default_rng(0).integers(1, 200, (2, 12)).astype(np.int64)


@pytest.mark.parametrize("family", ["llama", "llama_moe", "gpt"])
def test_model_is_a_layer_as_in_the_reference(family):
    paddle.seed(1)
    jm, tm = {
        "llama": lambda: (JaxLlama(jax_llama_tiny()), LlamaForCausalLM(llama_tiny())),
        "llama_moe": lambda: (JaxLlama(jax_llama_moe_tiny()),
                              LlamaForCausalLM(llama_moe_tiny())),
        "gpt": lambda: (JaxGPT(jax_gpt_tiny()), GPTForCausalLM(gpt_tiny())),
    }[family]()
    _same_layer_api(tm, jm)
    labels = np.roll(IDS, -1, 1)
    loss, _ = tm(torch.from_numpy(IDS), labels=torch.from_numpy(labels))
    jloss, _ = jm(paddle.to_tensor(IDS.astype(np.int32)), labels=paddle.to_tensor(labels))
    np.testing.assert_allclose(float(loss), float(jloss.numpy()), rtol=1e-4)
    _cleared(tm, loss)
    _cleared_reference(jm, jloss)
    # plain tensor attributes (rope tables, l_aux) stay out of the state
    assert not any("rope" in k or "l_aux" in k for k in tm.state_dict())


def test_hybrid_llama_is_a_layer_as_in_the_reference():
    from paddle_tpu.models.llama_parallel import LlamaForCausalLMHybrid as JHybrid
    from paddle_tpu_torch.models.llama_parallel import LlamaForCausalLMHybrid

    jhcg, hcg = _hcgs(dp=2, pp=2, mp=2)
    kw = dict(num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    paddle.seed(0)
    jm = JHybrid(jax_llama_tiny(**kw), jhcg)
    tm = LlamaForCausalLMHybrid(llama_tiny(**kw), hcg)
    _same_layer_api(tm, jm)
    loss = tm(torch.from_numpy(IDS), labels=torch.from_numpy(np.roll(IDS, -1, 1)))[0]
    _cleared(tm, loss)


def _blocks(pkg_nn, n, width, seed=0, **kw):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        blk = pkg_nn.Sequential(pkg_nn.Linear(width, width, **kw), pkg_nn.Tanh())
        w = (rng.standard_normal((width, width)) * 0.3).astype(np.float32)
        b = (rng.standard_normal((width,)) * 0.1).astype(np.float32)
        blk.set_state_dict({"0.weight": w, "0.bias": b})
        out.append(blk)
    return out


@pytest.mark.parametrize("engine", ["ScannedLayers", "GPipeLayers", "OneFOneBLayers"])
def test_pipeline_engines_are_layers_as_in_the_reference(engine):
    mse = (lambda o, y: ((o - y) ** 2).mean())
    extra = {"ScannedLayers": lambda m: dict(mesh=m),
             "GPipeLayers": lambda m: dict(mesh=m, num_microbatches=2),
             "OneFOneBLayers": lambda m: dict(mesh=m, num_microbatches=2, loss_fn=mse)}[engine]
    jm = getattr(jdist, engine)(_blocks(jnn, 4, 8), **extra(_jmesh(2)))
    tm = getattr(dist, engine)(_blocks(ptt.nn, 4, 8, device="cpu"), **extra(_pmesh(2)))
    _same_layer_api(tm, jm)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32))
    _cleared(tm, (tm(x) ** 2).mean())


def test_pipeline_layer_is_a_layer_as_in_the_reference():
    from paddle_tpu.distributed.meta_parallel import PipelineLayer as JPipelineLayer
    from paddle_tpu_torch.distributed.meta_parallel import PipelineLayer

    jm = JPipelineLayer(_blocks(jnn, 4, 8), num_stages=2)
    tm = PipelineLayer(_blocks(ptt.nn, 4, 8, device="cpu"), num_stages=2)
    _same_layer_api(tm, jm)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32))
    _cleared(tm, (tm(x) ** 2).mean())


def test_translated_layer_is_a_layer_as_in_the_reference(tmp_path):
    """A loaded program: no sublayers and no parameters (they are frozen
    inside the program), its sidecar parameters as the state dict."""
    jnet = jnn.Sequential(jnn.Linear(4, 3), jnn.Tanh())
    net = ptt.nn.Sequential(ptt.nn.Linear(4, 3, device="cpu"), ptt.nn.Tanh())
    load_numpy_state_dict(net, _np(jnet.state_dict()))
    spec = [jit.InputSpec([None, 4], "float32")]
    jit.save(net, str(tmp_path / "m"), input_spec=spec)
    jjit.save(jnet, str(tmp_path / "j"), input_spec=[jjit.InputSpec([None, 4], "float32")])
    tl, jtl = jit.load(str(tmp_path / "m")), jjit.load(str(tmp_path / "j"))
    assert isinstance(tl, Layer)
    assert tl.sublayers() == [] and jtl.sublayers() == []
    assert tl.parameters() == [] and jtl.parameters() == []
    assert _stem(tl.full_name()) == _stem(jtl.full_name())
    assert sorted(tl.state_dict()) == sorted(jtl.state_dict())
    tl.clear_gradients()
    x = np.random.default_rng(4).standard_normal((2, 4)).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).numpy(),
                               jtl(paddle.to_tensor(x)).numpy(), rtol=1e-5, atol=1e-6)
