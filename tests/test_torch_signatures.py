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
The deliberate departures are listed in ``DEPARTURES`` with their reasons.
"""

import importlib
import inspect
import pkgutil

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
    "paddle_tpu_torch.ops.decode_attention": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.ops.flash_attention": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.ops.fused_ln_swiglu": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.ops.fused_norm": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.ops.ring_flash": "kernel module; reference ops/pallas/",
    "paddle_tpu_torch.ops.rope": "kernel module; reference ops/pallas/",
}

DEPARTURES = {
    "paddle_tpu_torch.inference.Predictor":
        "built from a model (Predictor.from_model); the handle-based "
        "Predictor(Config) over a saved program waits for ROADMAP A3",
    "paddle_tpu_torch.nn.layer.rnn.RNNCellBase":
        "a torch.nn.Module; the reference's Layer base (name_scope, dtype) "
        "waits for ROADMAP A3",
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
    with pytest.raises(NotImplementedError, match="A3"):
        paddle_tpu_torch.nn.Linear(4, 8, "w_0", device="cpu")


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

    params = [torch.nn.Parameter(torch.zeros(2))]
    for cls, kw in ((Adam, dict(amsgrad=True)), (Adam, dict(lazy_mode=True)),
                    (Adam, dict(use_multi_tensor=True)), (AdamW, dict(amsgrad=True))):
        with pytest.raises(NotImplementedError, match="A4"):
            cls(parameters=params, **kw)
    with pytest.raises(NotImplementedError, match="A4"):
        amp.decorate(torch.nn.Linear(2, 2), save_dtype="float32")
    x = torch.zeros(2, 4)
    with pytest.raises(NotImplementedError, match="quantized"):
        fused_layer_norm(x, torch.ones(4), torch.zeros(4), quant_scale=1.0)
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="scale"):
        mesh_flash_attention(q, q, q, None, scale=0.5)
