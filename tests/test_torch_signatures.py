"""Calls written for the JAX package keep working on the port: the
parameters of every public callable of ``paddle_tpu_torch`` against its
twin at the same module path of ``paddle_tpu``, and the repairs of the
signature and path faults ROADMAP §C2 filed (``Linear``'s positional
order, ``padding_idx``, the reference's flags).

The rule, for each port callable whose module and name the reference has:
- every reference parameter is a parameter of the port's;
- the port's positional parameters start with the reference's, in order,
  so a positional call means the same in both;
- a parameter only the port has is keyword-only, or comes after all of the
  reference's (the port's ``std``, ``generator``, ``device``, ``dtype``).
The deliberate departures are listed in ``DEPARTURES`` with their reasons,
and keyword-only additions that change what a call does in
``KEYWORD_DEPARTURES``.
"""

import importlib
import importlib.util
import inspect
import pkgutil
import types

import numpy as np
import pytest
import torch

import paddle_tpu_torch

torch.set_num_threads(1)

# module of the port with no module of its own in the reference
NO_TWIN = {
    "paddle_tpu_torch.convert": "moves JAX weights into the port; nothing to mirror",
    "paddle_tpu_torch.nn.layers": "old path of nn.layer.common/norm, kept importable",
    "paddle_tpu_torch.nn.rnn": "old path of nn.layer.rnn, kept importable",
    "paddle_tpu_torch.ops._build": "builds the CUDA kernels; the reference has Pallas",
    "paddle_tpu_torch.ops.custom_ops": "the kernels as torch.library operators for "
                                       "torch.export; the reference exports StableHLO",
    "paddle_tpu_torch.ops.decode_attention": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.ops.flash_attention": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.ops.fused_ln_swiglu": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.ops.fused_norm": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.ops.ring_flash": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.ops.rope": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.vision.models._common": "the zoo's shared layout and device helpers; "
                                              "the reference repeats them in each model file",
}

DEPARTURES = {
    # the core (ROADMAP A3c, §C)
    "paddle_tpu_torch.tensor.Tensor": "is torch.Tensor, built by torch's own constructors "
        "(paddle.to_tensor(value, stop_gradient=...) takes the reference's arguments)",
    "paddle_tpu_torch.tensor.tensor.Tensor": "is torch.Tensor (as paddle_tpu_torch.tensor.Tensor)",
    "paddle_tpu_torch.device.Place": "wraps a torch.device (or its name), not a jax.Device",
    **{f"paddle_tpu_torch.tensor._op_utils.{name}": "builds an op from a torch function "
       "(fn), where the reference's takes a jnp one (jfn)"
       for name in ("unary_op", "binary_op", "nondiff")},
    **{f"paddle_tpu_torch.tensor.{name}": "as paddle_tpu_torch.tensor._op_utils's"
       for name in ("unary_op", "binary_op", "nondiff")},
}

# keyword-only parameters only the port has that change what a call does
# (the signature rule allows them; they are listed so that a reader of a
# call written for the reference knows); ROADMAP §C
KEYWORD_DEPARTURES = {
    "paddle_tpu_torch.distributed.auto_parallel.ProcessMesh": (
        "devices",
        "names the members, so several may share a card or the CPU (as "
        "fleet.init(devices=...) allows); the reference takes jax.devices() "
        "and refuses a mesh larger than them, as the port does without it"),
    # the image layers and the recurrent layers (ROADMAP A3b) build on the
    # default device, the card unless the caller asks for the CPU; each
    # also takes the port's keyword-only dtype (and generator where it
    # draws random weights)
    **{f"paddle_tpu_torch.nn.layer.{mod}.{name}": (
        "device", "the device the layer builds its parameters and buffers on")
       for mod, names in (
           ("conv", ("Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
                     "Conv3DTranspose")),
           ("norm", ("BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
                     "SyncBatchNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
                     "InstanceNorm3D")),
           ("common", ("Bilinear",)),
           ("rnn", ("SimpleRNN", "LSTM", "GRU")))
       for name in names},
    "paddle_tpu_torch.vision.models.resnet.ResNet": (
        "device", "the device the model is built on, which also resolves "
        "data_format='auto'; generator= draws its weights"),
    # the rest of the zoo (ROADMAP A9's first item), as ResNet
    **{f"paddle_tpu_torch.vision.models.{mod}.{name}": (
        "device", "the device the model is built on, which also resolves "
        "data_format='auto'; generator= draws its weights")
       for mod, names in (("lenet", ("LeNet",)), ("alexnet", ("AlexNet",)), ("vgg", ("VGG",)),
                          ("squeezenet", ("SqueezeNet",)),
                          ("mobilenet", ("MobileNetV1", "MobileNetV2")),
                          ("mobilenetv3", ("MobileNetV3Small", "MobileNetV3Large")),
                          ("shufflenetv2", ("ShuffleNetV2",)), ("densenet", ("DenseNet",)),
                          ("googlenet", ("GoogLeNet",)), ("inceptionv3", ("InceptionV3",)))
       for name in names},
    # the MoE layer and gates with weights of their own (ROADMAP A9's MoE)
    **{f"paddle_tpu_torch.incubate.distributed.models.moe.{name}": (
        "device", "the device the layer draws its weights on (the enclosing "
        "placement's, else the default device, if None); generator= draws them")
       for name in ("ExpertParallelMLP", "NaiveGate", "GShardGate", "SwitchGate")},
    "paddle_tpu_torch.incubate.autotune.resolve_conv_data_format": (
        "device", "the layout is resolved for this device (the default device if "
        "None): incubate.autotune.CARD_LAYOUT on the card, NCHW on the CPU; the "
        "reference asks whether it runs on a TPU"),
}


# torch.Tensor's own methods of the reference's method table whose torch
# meaning differs from the reference's (ROADMAP §C): ``Tensor`` is
# torch.Tensor, so these keep torch's meaning; the free functions
# (paddle.transpose(x, perm), ...) take the reference's signatures
METHOD_DEPARTURES = {
    "transpose": "torch swaps two dims (x.transpose(0, 1)); paddle.transpose(x, perm) permutes",
    "max": "torch's x.max(dim) returns (values, indices) and takes one dim; paddle.max(x, axis)",
    "min": "as max",
    "split": "torch's split takes the size of each part; paddle.split(x, num_or_sections, axis)",
    "numpy": "torch's numpy() refuses a card tensor and one that requires grad; "
             "x.detach().cpu().numpy()",
    "gather": "torch gathers along dim by an index of x's rank; paddle.gather(x, index, axis) "
              "takes slices",
    "scatter": "torch's scatter(dim, index, src); paddle.scatter(x, index, updates) sets rows",
    "scatter_": "as scatter",
    "index_select": "torch's index_select(dim, index); paddle.index_select(x, index, axis)",
    "index_add": "torch's index_add(dim, index, source); paddle.index_add(x, index, axis, value)",
    "index_fill": "torch's index_fill(dim, index, value); paddle.index_fill(x, index, axis, value)",
    "index_put": "torch's index_put(indices, values) matches; kept for the list's completeness",
    "sort": "torch's sort returns (values, indices); paddle.sort(x, axis) returns values",
    "median": "torch's median takes the lower middle and, with dim, returns indices too; "
              "paddle.median averages the two middles",
    "mode": "torch's mode returns (values, indices); paddle.mode returns (values, counts)",
    "unique": "torch's unique(sorted, return_inverse, return_counts, dim); paddle.unique's "
              "flags follow numpy's",
    "where": "torch's x.where(condition, y) takes x where condition holds; "
             "paddle.where(condition, x, y)",
    "norm": "torch's norm(p, dim); paddle.linalg.norm(x, p, axis)",
    "svd": "torch's Tensor.svd returns V, not V^H; paddle.linalg.svd returns (U, S, VH)",
    "triangular_solve": "torch's triangular_solve(A) solves with self as b; "
                        "paddle.linalg.triangular_solve(x, y)",
    "histogram": "torch's histogram returns (counts, edges); paddle.histogram returns counts",
    "cov": "torch's cov(correction=); paddle.linalg.cov(x, rowvar, ddof)",
    "expand": "torch's expand(*sizes); paddle.expand(x, shape) (x.expand([4, 8]) works in both)",
    "flip": "torch's flip(dims) needs dims; paddle.flip(x, axis)",
    "view": "torch's view(*shape) or view(dtype): the same calls work",
}


def _twins():
    """``module.name`` of every public callable of the port whose module
    and name the reference has too (both lists are fixed by the sources)."""
    out = []
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
        if info.name.endswith("__main__") or info.name in NO_TWIN:
            continue
        mod = importlib.import_module(info.name)
        ref = importlib.import_module("paddle_tpu" + info.name[len("paddle_tpu_torch"):])
        names = getattr(mod, "__all__", None) or [
            n for n, v in vars(mod).items()
            if not n.startswith("_") and getattr(v, "__module__", None) == info.name]
        out += [f"{info.name}.{n}" for n in names
                if callable(getattr(mod, n, None)) and callable(getattr(ref, n, None))]
    return out


def _params(obj):
    sig = inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)
    return [p for p in sig.parameters.values() if p.name != "self"
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _positional(params):
    return [p.name for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


CALLABLES = _twins()


def test_the_walk_covers_the_port():
    assert len(CALLABLES) > 80
    for name in DEPARTURES:
        assert name in CALLABLES, name


@pytest.mark.parametrize("path", CALLABLES)
def test_signature_matches_reference(path):
    mod_name, name = path.rsplit(".", 1)
    port = getattr(importlib.import_module(mod_name), name)
    ref = getattr(importlib.import_module("paddle_tpu" + mod_name[len("paddle_tpu_torch"):]),
                  name)
    mine, theirs = _params(port), _params(ref)
    missing = [p.name for p in theirs if p.name not in {q.name for q in mine}]
    ref_pos, my_pos = _positional(theirs), _positional(mine)
    reordered = my_pos[:len(ref_pos)] != ref_pos[:len(my_pos)]
    ref_names = {p.name for p in theirs}
    extra = [p.name for p in mine if p.name not in ref_names
             and p.kind != p.KEYWORD_ONLY and p.name in my_pos[:len(ref_pos)]]
    faults = dict(missing=missing, reordered=reordered, extra_before=extra)
    if path in DEPARTURES:
        assert any(faults.values()), f"{path} now matches: drop its departure"
        return
    assert not any(faults.values()), f"{path}: {faults}; port {my_pos}, reference {ref_pos}"


@pytest.mark.parametrize("path", sorted(KEYWORD_DEPARTURES))
def test_keyword_departures_are_keyword_only_and_port_only(path):
    mod_name, name = path.rsplit(".", 1)
    port = getattr(importlib.import_module(mod_name), name)
    ref = getattr(importlib.import_module("paddle_tpu" + mod_name[len("paddle_tpu_torch"):]),
                  name)
    keyword = KEYWORD_DEPARTURES[path][0]
    mine = {p.name: p for p in _params(port)}
    assert path in CALLABLES and mine[keyword].kind == inspect.Parameter.KEYWORD_ONLY
    assert keyword not in {p.name for p in _params(ref)}


def test_reference_flags_all_defined():
    import paddle_tpu

    mine = paddle_tpu_torch.get_flags()
    assert set(paddle_tpu.get_flags()) <= set(mine)


def test_set_flags_check_nan_inf():
    import paddle_tpu

    for package in (paddle_tpu, paddle_tpu_torch):
        package.set_flags({"check_nan_inf": True})
        try:
            assert package.get_flags("check_nan_inf") == {"check_nan_inf": True}
        finally:
            package.set_flags({"check_nan_inf": False})


def test_define_flag_type_and_writable():
    from paddle_tpu_torch.framework import flags

    try:
        flags.define_flag("test_signatures_ro", 3, "", type=float, writable=False)
        assert flags.get_flags("test_signatures_ro") == {"test_signatures_ro": 3}
        with pytest.raises(ValueError, match="not writable"):
            flags.set_flags({"test_signatures_ro": 4})
        flags.define_flag("test_signatures_typed", 1, "", type=float)
        flags.set_flags({"test_signatures_typed": "2.5"})
        assert flags.get_flags("test_signatures_typed")["test_signatures_typed"] == 2.5
    finally:
        for name in ("test_signatures_ro", "test_signatures_typed"):
            flags._values.pop(name, None)
            flags._casters.pop(name, None)
            flags._read_only.discard(name)


def test_linear_third_positional_is_weight_attr():
    """``Linear(4, 8, False)`` means weight_attr=False in both packages: a
    weight cannot be left out, so both refuse it (the port once dropped the
    bias instead)."""
    import paddle_tpu.nn as jnn

    for nn in (jnn, paddle_tpu_torch.nn):
        with pytest.raises(ValueError, match="attr=False"):
            nn.Linear(4, 8, False)
    lin = paddle_tpu_torch.nn.Linear(4, 8, None, False, device="cpu")
    assert lin.bias is None and tuple(lin.weight.shape) == (4, 8)
    named = paddle_tpu_torch.nn.Linear(4, 8, "w_0", device="cpu")
    assert named.weight.param_name == "w_0" and named.bias.param_name is None


def test_padding_idx_zeros_rows():
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as JF

    import paddle_tpu_torch.nn.functional as F

    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    ids = np.array([[0, 2, 5], [2, 2, 1]], np.int64)
    want = JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w), padding_idx=2).numpy()
    got = F.embedding(torch.from_numpy(ids), torch.from_numpy(w), padding_idx=2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[0, 1].any() and got[0, 0].abs().sum() > 0
    for pad in (2, -1):
        jemb = jnn.Embedding(6, 3, padding_idx=pad)
        emb = paddle_tpu_torch.nn.Embedding(6, 3, padding_idx=pad, device="cpu")
        row = pad % 6
        np.testing.assert_array_equal(emb.weight[row].detach().numpy(),
                                      jemb.weight.numpy()[row])
        assert not emb.weight[row].any()
        assert not emb(torch.tensor([row])).any()


def test_cross_entropy_axis_and_use_softmax():
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF

    import paddle_tpu_torch.nn.functional as F

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 3)).astype(np.float32)     # classes on axis 1
    labels = rng.integers(0, 5, (2, 1, 3))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for x, kw in ((logits, {}), (probs, dict(use_softmax=False)),
                  (logits, dict(label_smoothing=0.1, reduction="none"))):
        want = JF.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(labels), axis=1,
                                **kw).numpy()
        got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(labels), axis=1, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_rms_norm_without_weight_and_sdpa_scale():
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.ops.attention import sdpa_reference as jax_sdpa

    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops.attention import sdpa_reference

    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    np.testing.assert_allclose(F.rms_norm(torch.from_numpy(x), name="n").numpy(),
                               JF.rms_norm(paddle.to_tensor(x)).numpy(), rtol=1e-5, atol=1e-6)
    q, k, v = (rng.standard_normal((1, 4, 2, 8)).astype(np.float32) for _ in range(3))
    got = sdpa_reference(*map(torch.from_numpy, (q, k, v)), is_causal=True, scale=0.3)
    want = np.asarray(jax_sdpa(q, k, v, is_causal=True, scale=0.3))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_unported_arguments_raise_with_their_queue_item():
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate.nn.functional import fused_layer_norm
    from paddle_tpu_torch.ops.sharded import mesh_flash_attention
    from paddle_tpu_torch.optimizer import Adam, AdamW

    # ROADMAP A4 ported these: they are taken now, as in the reference
    params = [torch.nn.Parameter(torch.zeros(2))]
    for cls, kw in ((Adam, dict(amsgrad=True)), (Adam, dict(lazy_mode=True)),
                    (Adam, dict(use_multi_tensor=True)), (AdamW, dict(amsgrad=True))):
        cls(parameters=params, **kw)
    amp.decorate(torch.nn.Linear(2, 2), save_dtype="float32")
    # ROADMAP A7b ported this: it is taken now, as in the reference
    amp.GradScaler().attach_health_guard(None)
    x = torch.zeros(2, 4)
    with pytest.raises(NotImplementedError, match="quantized"):
        fused_layer_norm(x, torch.ones(4), torch.zeros(4), quant_scale=1.0)
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="scale"):
        mesh_flash_attention(q, q, q, None, scale=0.5)


# ---------------------------------------------------------------------------
# C3: the ported names at the reference's paths (ROADMAP §C)
# ---------------------------------------------------------------------------
# a reference name the port defines elsewhere as another object (the same
# word for a different function), which waits for its own item here
NAME_CLASHES = {}


def _port_modules():
    return ["paddle_tpu_torch"] + [
        info.name for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                                    "paddle_tpu_torch.")
        if not info.name.endswith("__main__") and info.name not in NO_TWIN]


def _port_defined():
    """Every public name the port defines (a function or class of the port,
    under any module)."""
    names = set()
    for mod_name in _port_modules():
        for n, v in vars(importlib.import_module(mod_name)).items():
            if not n.startswith("_") and not isinstance(v, types.ModuleType) and \
                    str(getattr(v, "__module__", "") or "").startswith("paddle_tpu_torch"):
                names.add(n)
    return names


def _reference_public(ref):
    """The public names of a reference module: its ``__all__``, else every
    name of it that holds an object of the reference package."""
    names = getattr(ref, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n, v in vars(ref).items() if not n.startswith("_") and (
        (isinstance(v, types.ModuleType) and v.__name__.startswith("paddle_tpu.")) or
        str(getattr(v, "__module__", "") or "").startswith("paddle_tpu"))]


def _has_module(name):
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:     # its parent package is not there
        return False


def _c3_cases():
    """(port module, name) pairs, sorted: every module of both packages is
    imported first, so that the list does not hang on what a worker
    imported before."""
    defined = _port_defined()
    pairs = []
    for mod_name in _port_modules():
        ref_name = "paddle_tpu" + mod_name[len("paddle_tpu_torch"):]
        if _has_module(ref_name):
            pairs.append((mod_name, importlib.import_module(ref_name)))
    cases = set()
    for mod_name, ref in pairs:
        for n in _reference_public(ref):
            v = getattr(ref, n, None)
            if isinstance(v, types.ModuleType):
                # a submodule: reachable where the port has its twin
                twin = "paddle_tpu_torch" + v.__name__[len("paddle_tpu"):]
                if v.__name__.startswith("paddle_tpu.") and _has_module(twin):
                    cases.add((mod_name, n))
            elif n in defined and (mod_name, n) not in NAME_CLASHES:
                cases.add((mod_name, n))
    return sorted(cases)


C3_CASES = _c3_cases()


def test_c3_walk_covers_the_core():
    paths = {f"{m}.{n}" for m, n in C3_CASES}
    assert len(C3_CASES) > 800
    for path in ("paddle_tpu_torch.seed", "paddle_tpu_torch.to_tensor",
                 "paddle_tpu_torch.no_grad", "paddle_tpu_torch.grad",
                 "paddle_tpu_torch.Generator", "paddle_tpu_torch.save", "paddle_tpu_torch.io",
                 "paddle_tpu_torch.distributed", "paddle_tpu_torch.framework.set_flags",
                 "paddle_tpu_torch.serving.decode_mesh",
                 "paddle_tpu_torch.incubate.nn.functional.swiglu",
                 # ROADMAP A3d and A7a
                 "paddle_tpu_torch.jit.to_static", "paddle_tpu_torch.jit.save",
                 "paddle_tpu_torch.jit.load", "paddle_tpu_torch.jit.InputSpec",
                 "paddle_tpu_torch.jit.TranslatedLayer",
                 "paddle_tpu_torch.inference.Config",
                 "paddle_tpu_torch.inference.create_predictor",
                 "paddle_tpu_torch.distributed.checkpoint.save_state_dict",
                 "paddle_tpu_torch.distributed.checkpoint.load_state_dict",
                 "paddle_tpu_torch.distributed.checkpoint.Snapshotter",
                 "paddle_tpu_torch.distributed.checkpoint.resume",
                 "paddle_tpu_torch.distributed.checkpoint.latest_checkpoint",
                 "paddle_tpu_torch.distributed.fleet.elastic.PreemptionGuard",
                 "paddle_tpu_torch.distributed.health.host_fingerprint",
                 # ROADMAP A7b
                 "paddle_tpu_torch.distributed.health.HealthGuard",
                 "paddle_tpu_torch.distributed.health.HealthPolicy",
                 "paddle_tpu_torch.distributed.health.SpikeDetector",
                 "paddle_tpu_torch.distributed.health.RewindLedger",
                 "paddle_tpu_torch.distributed.health.SDCMonitor",
                 "paddle_tpu_torch.distributed.health.StragglerMonitor",
                 "paddle_tpu_torch.distributed.fleet.FaultDomain",
                 "paddle_tpu_torch.distributed.fleet.fault_domain",
                 "paddle_tpu_torch.distributed.fleet.elastic.ElasticManager",
                 "paddle_tpu_torch.distributed.fleet.elastic.FileStore",
                 "paddle_tpu_torch.distributed.fleet.elastic.Supervisor",
                 "paddle_tpu_torch.distributed.fleet.elastic.FleetSupervisor",
                 "paddle_tpu_torch.distributed.fleet.elastic.emergency_handler",
                 "paddle_tpu_torch.distributed.rpc",
                 "paddle_tpu_torch.distributed.FleetSupervisor"):
        assert path in paths, path


@pytest.mark.parametrize("mod_name,name", C3_CASES, ids=[f"{m}.{n}" for m, n in C3_CASES])
def test_reference_name_reachable_at_its_path(mod_name, name):
    """A name the port has is reachable where the reference exports it."""
    getattr(importlib.import_module(mod_name), name)


def test_c3_calls():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import seed, set_flags  # noqa: F401
    from paddle_tpu_torch.incubate.nn.functional import swiglu
    from paddle_tpu_torch.serving import decode_mesh, shard_arenas, shard_llama_params  # noqa

    assert swiglu is paddle.nn.functional.swiglu
    assert isinstance(paddle.seed(0), paddle.Generator)
    for name in ("io", "distributed", "vision", "metric", "incubate", "telemetry",
                 "inference", "generation", "models", "serving"):
        assert isinstance(getattr(paddle, name), types.ModuleType), name
    for name in ("to_tensor", "Tensor", "no_grad", "grad", "float32", "Generator", "save",
                 "load", "Parameter", "is_tensor", "enable_grad", "set_grad_enabled",
                 "is_grad_enabled", "finfo", "iinfo", "Place", "CPUPlace", "DeviceGuard",
                 "device_count", "synchronize", "is_compiled_with_cuda", "in_dynamic_mode",
                 "linalg", "autograd"):
        assert getattr(paddle, name) is not None, name


@pytest.mark.parametrize("path,item", [
    ("paddle_tpu_torch.profiler", "A10"), ("paddle_tpu_torch.hapi", "A10"),
    ("paddle_tpu_torch.Model", "A10"), ("paddle_tpu_torch.fft", "A10"),
    ("paddle_tpu_torch.sparse", "A10"), ("paddle_tpu_torch.onnx", "A10"),
    ("paddle_tpu_torch.quantization", "A10"), ("paddle_tpu_torch.static", "A10"),
    ("paddle_tpu_torch.serving.Autoscaler", "A8"),
    ("paddle_tpu_torch.telemetry.blackbox", "A8"),
    ("paddle_tpu_torch.vision.ops", "A10"),
    ("paddle_tpu_torch.serving.Router", "A8"), ("paddle_tpu_torch.device.Stream", "A10"),
    ("paddle_tpu_torch.serving.check_decode_donation", "A10"),
    ("paddle_tpu_torch.telemetry.prometheus_text", "A8")])
def test_unported_name_raises_with_its_item(path, item):
    """A name whose item is still open raises naming it; the A8 names
    (ported) resolve to their reference twins' kinds."""
    mod_name, name = path.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    if item == "A8":
        ref = importlib.import_module("paddle_tpu" + mod_name[len("paddle_tpu_torch"):])
        mine, theirs = getattr(mod, name), getattr(ref, name)
        assert type(mine) is type(theirs) or (callable(mine) and callable(theirs)), path
    else:
        with pytest.raises(NotImplementedError, match=item):
            getattr(mod, name)
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name_anywhere")


@pytest.mark.parametrize("name", sorted(METHOD_DEPARTURES))
def test_method_departures_keep_torch_meaning(name):
    import paddle_tpu as jpaddle
    import torch

    from paddle_tpu_torch import tensor as T

    assert name in T.TORCH_METHODS or name == "numpy"
    assert getattr(torch.Tensor, name) is getattr(torch._C.TensorBase, name, None) or \
        getattr(torch.Tensor, name).__qualname__.startswith(("Tensor.", "_TensorBase.",
                                                             "TensorBase."))
    assert hasattr(jpaddle.Tensor, name)


def test_attached_methods_are_the_port_functions():
    import torch

    from paddle_tpu_torch import tensor as T

    for name in sorted(T.METHODS - T.TORCH_METHODS):
        fn = getattr(torch.Tensor, name)
        assert fn.__module__.startswith("paddle_tpu_torch.tensor"), name


# ---------------------------------------------------------------------------
# The method walk: every public method of every twin class (ROADMAP §C5-C8)
# ---------------------------------------------------------------------------
# a twin class that is a torch.nn.Module and not the port's nn.Layer: the
# reference's Layer methods are torch's or missing there (ROADMAP §C8, closed:
# none is left)
LAYER_DEPARTURES = {}

# one method of a twin class that departs from the reference's, and why
METHOD_WALK_DEPARTURES = {
    "paddle_tpu_torch.jit.TrainStep.lower": "lowers the step to an XLA program for the "
        "analysis linter; the eager step has none (ROADMAP A10: compile/ and analysis/)",
    "paddle_tpu_torch.distributed.engine.DistributedTrainStep.lower": "as TrainStep.lower "
        "(ROADMAP A10)",
    "paddle_tpu_torch.tensor.Tensor.tpu": "moves an array to a TPU: JAX only",
    "paddle_tpu_torch.tensor.Tensor.backward": "torch's first parameter is gradient; a "
        "positional call means the same, and grad_tensor= is taken as a keyword (C7)",
    "paddle_tpu_torch.tensor.Tensor.unique_consecutive": "torch's unique_consecutive("
        "return_inverse, return_counts, dim); paddle.unique_consecutive(x, ...) takes the "
        "reference's",
    # torch's own methods whose signatures can be read (the others are
    # builtins, which the walk cannot compare; METHOD_DEPARTURES lists them)
    **{f"paddle_tpu_torch.tensor.Tensor.{name}": f"METHOD_DEPARTURES: {METHOD_DEPARTURES[name]}"
       for name in ("norm", "split", "unique")},
}


def _walk_classes():
    """(port path, port class, reference class) of every public class of
    the port whose module and name the reference has."""
    out, seen = [], set()
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
        if info.name.endswith("__main__") or info.name in NO_TWIN:
            continue
        mod = importlib.import_module(info.name)
        ref = importlib.import_module("paddle_tpu" + info.name[len("paddle_tpu_torch"):])
        names = getattr(mod, "__all__", None) or [
            n for n, v in vars(mod).items()
            if not n.startswith("_") and getattr(v, "__module__", None) == info.name]
        for n in names:
            mine, theirs = getattr(mod, n, None), getattr(ref, n, None)
            if inspect.isclass(mine) and inspect.isclass(theirs) and \
                    (mine, theirs) not in seen:
                seen.add((mine, theirs))
                out.append((f"{info.name}.{n}", mine, theirs))
    return sorted(out, key=lambda t: t[0])


def _reference_methods(cls):
    """{name: (function, whether the reference's nn.Layer defines it)} of
    the public methods the reference package defines on ``cls`` or its
    bases."""
    out = {}
    for klass in cls.__mro__:
        if not (klass.__module__ or "").startswith("paddle_tpu"):
            continue
        layer = klass.__name__ == "Layer" and klass.__module__.startswith("paddle_tpu.nn")
        for n, v in vars(klass).items():
            if n.startswith("_") or n in out:
                continue
            if isinstance(v, (staticmethod, classmethod)):
                v = v.__func__
            if inspect.isfunction(v):
                out[n] = (v, layer)
    return out


def _method_faults(port, ref):
    """{method: (fault, whether the reference's nn.Layer defines it)}: a
    method the port lacks, or whose parameters break the rule of
    ``test_signature_matches_reference``."""
    faults = {}
    for name, (theirs, layer) in _reference_methods(ref).items():
        mine = inspect.getattr_static(port, name, None)
        if isinstance(mine, (staticmethod, classmethod)):
            mine = mine.__func__
        if mine is None or isinstance(mine, property) or not callable(mine):
            faults[name] = ("missing", layer)
            continue
        try:
            mp, tp = _params(mine), _params(theirs)
        except (TypeError, ValueError):      # a builtin of torch: no signature to read
            continue
        missing = [p.name for p in tp if p.name not in {q.name for q in mp}]
        ref_pos, my_pos = _positional(tp), _positional(mp)
        if missing or my_pos[:len(ref_pos)] != ref_pos[:len(my_pos)]:
            faults[name] = (f"missing {missing}, port {my_pos}, reference {ref_pos}", layer)
    return faults


WALK_CLASSES = _walk_classes()


def test_method_walk_covers_the_port():
    paths = {p for p, _, _ in WALK_CLASSES}
    walked = {c for _, c, _ in WALK_CLASSES}
    assert len(WALK_CLASSES) > 300
    for path in ("paddle_tpu_torch.tensor.Tensor", "paddle_tpu_torch.jit.TrainStep",
                 "paddle_tpu_torch.distributed.parallel.DataParallel",
                 "paddle_tpu_torch.distributed.health.guard.HealthGuard",
                 "paddle_tpu_torch.distributed.health.sdc.SDCMonitor",
                 "paddle_tpu_torch.distributed.health.straggler.StragglerMonitor",
                 "paddle_tpu_torch.distributed.fleet.fault_domain.FaultDomain",
                 "paddle_tpu_torch.distributed.fleet.elastic.supervisor.Supervisor",
                 "paddle_tpu_torch.distributed.fleet.elastic.gang.FleetSupervisor",
                 "paddle_tpu_torch.distributed.overlap.bucketer.GradientBucketer",
                 *LAYER_DEPARTURES):
        mod_name, name = path.rsplit(".", 1)
        assert getattr(importlib.import_module(mod_name), name) in walked, path
    for path in LAYER_DEPARTURES:
        assert path in paths, path
    for name in METHOD_WALK_DEPARTURES:
        assert name.rsplit(".", 1)[0] in paths, name


@pytest.mark.parametrize("path,port,ref", WALK_CLASSES, ids=[p for p, _, _ in WALK_CLASSES])
def test_class_methods_match_reference(path, port, ref):
    """Every public method the reference defines on a twin class is a
    method of the port's, under the signature rule; the departures are
    listed, and a listed one that no longer departs fails too."""
    faults = _method_faults(port, ref)
    unlisted = {name: fault for name, (fault, layer) in faults.items()
                if f"{path}.{name}" not in METHOD_WALK_DEPARTURES
                and not (layer and path in LAYER_DEPARTURES)}
    assert not unlisted, f"{path}: {unlisted}"
    stale = [name for name in METHOD_WALK_DEPARTURES
             if name.rsplit(".", 1)[0] == path and name.rsplit(".", 1)[1] not in faults]
    assert not stale, f"{path}: listed departures that now match: {stale}"
    if path in LAYER_DEPARTURES:
        assert any(layer for _, layer in faults.values()), f"{path} is a Layer now"


def _table_names():
    from paddle_tpu_torch import tensor as T

    return sorted(n for n in T.METHODS if n in dir(torch.Tensor))


@pytest.mark.parametrize("name", _table_names())
def test_method_table_name_is_not_a_removed_stub(name):
    """C6: every name of the reference's method table that torch.Tensor has
    runs on a 2 x 2 input, or fails for its arguments; none is one of
    torch's stubs that raise "removed"."""
    x = torch.tensor([[3.0, 1.0], [1.0, 2.0]])
    try:
        getattr(x.clone(), name)()
    except Exception as e:      # a missing argument is fine; a removed stub is not
        assert "removed" not in str(e) and "deprecated" not in str(e), (name, e)


def test_solve_and_eig_methods_match_reference():
    import paddle_tpu as jpaddle

    a = np.array([[3.0, 1.0], [1.0, 2.0]], np.float32)
    b = np.array([[9.0], [8.0]], np.float32)
    want = jpaddle.to_tensor(a).solve(jpaddle.to_tensor(b)).numpy()
    np.testing.assert_allclose(torch.from_numpy(a).solve(torch.from_numpy(b)).numpy(), want,
                               rtol=1e-6)
    np.testing.assert_allclose(want, [[2.0], [3.0]], rtol=1e-6)
    w, v = torch.from_numpy(a).eig()
    jw, jv = jpaddle.to_tensor(a).eig()
    order = np.argsort(-w.real.numpy())
    np.testing.assert_allclose(w.real.numpy()[order], np.sort(np.asarray(jw.numpy()).real)[::-1],
                               rtol=1e-6)
    np.testing.assert_allclose(w.real.numpy()[order], [3.618034, 1.381966], rtol=1e-6)
    # each vector an eigenvector of a for its value
    for k in range(2):
        vec = v[:, k].real.numpy()
        np.testing.assert_allclose(a @ vec, w[k].real.numpy() * vec, rtol=1e-5, atol=1e-6)
