"""``inference.Config`` / ``create_predictor`` of the port (ROADMAP A3d)
over a program that ``jit.save`` wrote: the reference's three cases
(``tests/test_inference.py``), the saved ``ernie_tiny`` with two inputs
(``input_ids``, ``token_type_ids``) held against the JAX package's
predictor on the same weights and ids, and the device refusals: an
exported program runs on the device it was traced on, so
``enable_use_gpu`` on a program saved on the CPU raises, naming the
program's device (the reference's knob is inert; ROADMAP §C).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu.models import ernie as jernie

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.inference import Config, PrecisionType, Predictor, create_predictor
from paddle_tpu_torch.models import ernie

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
ATTN = dict(rtol=1e-4, atol=1e-5)   # attention reductions (test_torch_train.py)


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")
    yield
    ptt.set_device(None)


def _carry(jm, tm):
    load_numpy_state_dict(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return tm


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    ptt.set_device("cpu")
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    model = _carry(jm, tnn.Sequential(tnn.Linear(8, 16), tnn.Tanh(), tnn.Linear(16, 4)))
    path = str(tmp_path_factory.mktemp("pred") / "net")
    jit.save(model, path, input_spec=[jit.InputSpec([2, 8])])
    paddle.jit.save(jm, path + "_ref", input_spec=[paddle.jit.InputSpec([2, 8])])
    ptt.set_device(None)
    return path, model


class TestPredictor:
    def test_handle_roundtrip_matches_layer(self, saved_model):
        path, model = saved_model
        predictor = create_predictor(Config(path))
        names = predictor.get_input_names()
        assert names == ["input_0"]
        x = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
        h = predictor.get_input_handle(names[0])
        h.copy_from_cpu(x)
        assert h.shape() == [2, 8]
        x[:] = 0.0                         # the handle holds a copy
        predictor.run()
        out_names = predictor.get_output_names()
        assert out_names == ["output_0"]
        out = predictor.get_output_handle(out_names[0]).copy_to_cpu()
        x = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
        np.testing.assert_allclose(out, model(torch.from_numpy(x)).detach().numpy(), **F32)
        ref = jax_create_predictor(JaxConfig(path + "_ref"))
        ref.get_input_handle("input_0").copy_from_cpu(x)
        ref.run()
        np.testing.assert_allclose(out, ref.get_output_handle("output_0").copy_to_cpu(), **F32)

    def test_config_accepts_pdmodel_suffix_and_knobs(self, saved_model):
        path, _ = saved_model
        cfg = Config(path + ".pdmodel")
        assert cfg.model_path() == path
        cfg.enable_memory_optim()
        cfg.enable_mkldnn()
        cfg.switch_ir_optim(False)
        cfg.enable_tensorrt_engine()
        cfg.set_cpu_math_library_num_threads(2)
        cfg.disable_gpu()                  # the program's own device: accepted
        predictor = create_predictor(cfg)
        assert predictor.get_input_names()
        with pytest.raises(ValueError, match="sidecar"):
            Config(path, path + ".other")
        assert Config(path, path + ".pdiparams").model_path() == path

    def test_errors(self, saved_model):
        path, _ = saved_model
        predictor = create_predictor(Config(path))
        with pytest.raises(RuntimeError, match="not set"):
            predictor.run()
        h = predictor.get_input_handle("input_0")
        with pytest.raises(RuntimeError, match="holds no data"):
            h.copy_to_cpu()

    def test_device_refusal_names_the_program_device(self, saved_model):
        """The departure: no silent move of a program to another device."""
        path, _ = saved_model
        cfg = Config(path)
        cfg.enable_use_gpu(100, 0, PrecisionType.Half)
        with pytest.raises(ValueError, match="saved on cpu"):
            create_predictor(cfg)

    def test_params_only_save_has_no_program(self, tmp_path):
        path = str(tmp_path / "ponly")
        jit.save(tnn.Linear(4, 2), path)
        with pytest.raises(ValueError, match="no .pdmodel program"):
            create_predictor(Config(path))


def test_ernie_predictor_matches_reference(tmp_path):
    """ERNIE's two inputs through the handles, two batch shapes of one
    program, against the port's eager forward and the JAX package's
    predictor (a static program a shape)."""
    paddle.seed(0)
    jm = jernie.ErnieForSequenceClassification(jernie.ernie_tiny(hidden_dropout_prob=0.0), 3)
    jm.eval()
    tm = _carry(jm, ernie.ErnieForSequenceClassification(
        ernie.ernie_tiny(hidden_dropout_prob=0.0), 3, device="cpu")).eval()
    path = str(tmp_path / "ernie")
    jit.save(tm, path, input_spec=[jit.InputSpec([None, "seq"], "int64", "input_ids"),
                                   jit.InputSpec([None, "seq"], "int64", "token_type_ids")])
    predictor = create_predictor(Config(path))
    assert predictor.get_input_names() == ["input_0", "input_1"]
    for i, (b, s) in enumerate(((2, 12), (3, 20))):
        rng = np.random.default_rng(i)
        ids = rng.integers(0, 256, (b, s)).astype(np.int64)
        seg = rng.integers(0, 2, (b, s)).astype(np.int64)
        predictor.get_input_handle("input_0").copy_from_cpu(ids)
        predictor.get_input_handle("input_1").copy_from_cpu(seg)
        predictor.run()
        got = predictor.get_output_handle("output_0").copy_to_cpu()
        with torch.no_grad():
            eager = tm(torch.from_numpy(ids), torch.from_numpy(seg))
        np.testing.assert_allclose(got, eager.numpy(), **F32)
        jpath = str(tmp_path / f"jernie{i}")
        paddle.jit.save(jm, jpath, input_spec=[paddle.jit.InputSpec([b, s], "int64")] * 2)
        ref = jax_create_predictor(JaxConfig(jpath))
        for n, a in zip(ref.get_input_names(), (ids, seg)):
            ref.get_input_handle(n).copy_from_cpu(a)
        ref.run()
        np.testing.assert_allclose(got, ref.get_output_handle("output_0").copy_to_cpu(), **ATTN)


def test_bf16_output_widens_to_f32(tmp_path):
    """numpy has no bf16: a bf16 program output comes back widened (exact)."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = tnn.Linear(4, 3).to(dtype="bfloat16")

        def forward(self, ids):
            return self.lin(ids.to(torch.bfloat16))

    net = Net()
    path = str(tmp_path / "bf16")
    jit.save(net, path, input_spec=[jit.InputSpec([None, 4], "int64")])
    ids = np.arange(8, dtype=np.int64).reshape(2, 4)
    predictor = create_predictor(Config(path))
    predictor.get_input_handle("input_0").copy_from_cpu(ids)
    predictor.run()
    got = predictor.get_output_handle("output_0").copy_to_cpu()
    want = net(torch.from_numpy(ids))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.detach().float().numpy())


def test_from_model_keeps_the_decode_path():
    with pytest.raises(TypeError, match="generate"):
        Predictor.from_model(tnn.Linear(2, 2))
