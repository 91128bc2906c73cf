"""The port's core tensor API against the JAX package's, on the CPU: the
dtype names and their int64 rule, the generators (by their laws: JAX's and
torch's bits differ), ``to_tensor`` and the attributes ``Tensor``
(``torch.Tensor``) gains, the method table, the tensor functions of
``creation``, ``math``, ``manipulation``, ``logic``, ``search``, ``linalg``,
``einsum`` and ``random``, the cases of ``tests/test_tensor.py``, and a
replay of ``tests/test_op_numerics.py``'s ``OP_TABLE``: each entry's op,
rebuilt with the port as ``paddle`` and ``F``, run through both packages on
the same inputs, forward and grads, under ``tests/op_test.py``'s tables.
"""

import types

import numpy as np
import pytest
import torch

import op_test
import paddle_tpu as jpaddle
import test_op_numerics as ref_table

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import serving as port_serving
from paddle_tpu_torch.framework import dtype as D

torch.set_num_threads(1)

F32 = op_test.TOLERANCES["float32"]


@pytest.fixture(autouse=True)
def _on_cpu():
    paddle.set_device("cpu")
    yield
    paddle.set_device(None)


def np_t(shape, seed=0, dtype="float32"):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def host(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# OP_TABLE replay
# ---------------------------------------------------------------------------
def port_op(op):
    """``op`` with the port in place of the reference's ``paddle``, ``F`` and
    KV quantizers (its code is the reference's own)."""
    env = {**op.__globals__, "paddle": paddle, "F": F,
           "quantize_kv": port_serving.quantize_kv, "dequantize_kv": port_serving.dequantize_kv}
    for name in ("_kv_roundtrip_op", "_kv_scale_op", "_kv_dequant_op"):
        fn = op.__globals__.get(name)
        if fn is not None:
            env[name] = types.FunctionType(fn.__code__, env, fn.__name__)
    return types.FunctionType(op.__code__, env, op.__name__, op.__defaults__, op.__closure__)


def run_port(op, arrays, dtype, stop_gradient=True):
    tensors = [paddle.to_tensor(a.astype(np.float32)).astype(dtype) if a.dtype.kind == "f"
               else paddle.to_tensor(a) for a in arrays]
    for t in tensors:
        t.stop_gradient = stop_gradient
    return op(*tensors), tensors


def port_grads(op, arrays, dtype, grad_indices):
    out, tensors = run_port(op, arrays, dtype, stop_gradient=False)
    w = np.cos(np.arange(int(np.prod(out.shape)) or 1, dtype=np.float32))
    wt = paddle.to_tensor(w.reshape(tuple(out.shape) or (1,))).astype(out.dtype)
    loss = (out * wt).sum() if out.dim() else out * wt.reshape([])
    loss.backward()
    grads = []
    for i in grad_indices:
        assert tensors[i].grad is not None, f"no grad reached input {i}"
        grads.append(host(tensors[i].grad.float()))
    return grads


def check_port_op(name, ref_op, ref, inputs, dtypes=("float32", "bfloat16"), grad=True,
                  grad_indices=None, tol=None, grad_tol=None, numeric_eps=None):
    """``check_op``'s contract for the port, with the JAX package beside
    the numpy reference: each dtype's forward within the tolerance of both,
    the f32 grads within the f32 grad row of the JAX package's analytic
    grads, the bf16 grads within the bf16 row of the f32 ones."""
    tol = {**op_test.TOLERANCES, **(tol or {})}
    grad_tol = {**op_test.GRAD_TOLERANCES, **(grad_tol or {})}
    inputs = [np.asarray(a) for a in inputs]
    if grad_indices is None:
        grad_indices = [i for i, a in enumerate(inputs) if a.dtype.kind == "f"]
    op = port_op(ref_op)
    want = None if ref is None else np.asarray(ref(*inputs), dtype=np.float32)
    for dt in dtypes:
        got = host(run_port(op, inputs, dt)[0].astype("float32"))
        jax_out, _ = op_test._run_op(ref_op, inputs, dt)
        jax_out = np.asarray(jax_out.astype("float32").numpy())
        t = tol[dt]
        for label, target in (("numpy", want), ("JAX package", jax_out)):
            if target is not None:
                np.testing.assert_allclose(got, target, rtol=t["rtol"], atol=t["atol"],
                                           err_msg=f"[{name}] forward at {dt} vs {label}")
    if not grad or not grad_indices:
        return
    g32 = port_grads(op, inputs, "float32", grad_indices)
    j32 = op_test._analytic_grads(ref_op, inputs, "float32", grad_indices)
    t = grad_tol["float32"]
    for i, (a, b) in enumerate(zip(g32, j32)):
        np.testing.assert_allclose(a, b, rtol=t["rtol"], atol=t["atol"],
                                   err_msg=f"[{name}] f32 grad of input {grad_indices[i]}")
    if "bfloat16" in dtypes:
        gbf = port_grads(op, inputs, "bfloat16", grad_indices)
        t = grad_tol["bfloat16"]
        for i, (a, b) in enumerate(zip(gbf, g32)):
            np.testing.assert_allclose(a, b, rtol=t["rtol"], atol=t["atol"],
                                       err_msg=f"[{name}] bf16 grad of input "
                                               f"{grad_indices[i]} vs f32")


def test_op_table_is_the_reference_s():
    assert len(ref_table.OP_TABLE) >= 100


@pytest.mark.parametrize("name,op,ref,inputs,kw", ref_table.OP_TABLE,
                         ids=[t[0] for t in ref_table.OP_TABLE])
def test_op_table_replay(name, op, ref, inputs, kw):
    check_port_op(name, op, ref, inputs, **{**kw, **ref_table.WHITE_LIST.get(name, {})})


def test_replay_catches_a_wrong_forward():
    with pytest.raises(AssertionError, match="forward"):
        check_port_op("bad", eval("lambda x: paddle.tanh(x) + 0.1", {"paddle": jpaddle}),
                      np.tanh, [ref_table.rand(3, 3)], grad=False)


# ---------------------------------------------------------------------------
# dtypes (framework/dtype.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,want", [
    ("float32", torch.float32), ("bf16", torch.bfloat16), ("half", torch.float16),
    ("float", torch.float32), ("double", torch.float64), ("int64", torch.int64),
    ("bool", torch.bool), (np.float32, torch.float32), (np.dtype("int32"), torch.int32),
    (float, torch.float32), (int, torch.int64), (torch.uint8, torch.uint8)])
def test_convert_dtype(spec, want):
    assert D.convert_dtype(spec) == want == D.canonical_dtype(spec)


def test_dtype_names_and_predicates_against_reference():
    from paddle_tpu.framework import dtype as JD

    for name in ("bfloat16", "float16", "float32", "float64", "int8", "int16", "int32",
                 "int64", "uint8", "bool_", "complex64", "complex128"):
        port, ref = getattr(paddle, name), getattr(JD, name)
        assert str(port).split(".")[1] == np.dtype(ref).name.replace("bool", "bool")
        assert D.is_floating_point(port) == JD.is_floating_point(ref)
        assert D.is_integer(port) == JD.is_integer(ref)
    assert D.default_float_dtype() == torch.float32
    for name in ("float32", "bfloat16", "float16"):
        assert paddle.finfo(name).eps == float(JD.finfo(name).eps)
        assert paddle.finfo(name).max == float(JD.finfo(name).max)
    assert paddle.iinfo("int32").max == JD.iinfo("int32").max


def test_int64_rule():
    """The port keeps torch's 64-bit types where the reference folds them
    (ROADMAP §C): indices are int64, f64 arrays stay f64."""
    x = paddle.to_tensor(np_t((3, 4)))
    assert paddle.argmax(x, axis=1).dtype == torch.int64
    assert paddle.topk(x, 2)[1].dtype == torch.int64
    assert paddle.nonzero(x > 0).dtype == torch.int64
    assert paddle.arange(5).dtype == torch.int64
    assert paddle.to_tensor(np.zeros(2)).dtype == torch.float64
    assert paddle.to_tensor([1.0, 2.0]).dtype == torch.float32
    assert jpaddle.to_tensor(np.zeros(2)).dtype == np.float32   # the reference folds


# ---------------------------------------------------------------------------
# generators (framework/random.py, tensor/random.py): laws, not bits
# ---------------------------------------------------------------------------
def test_seed_replays_every_draw():
    def draws():
        p = paddle.rand([16])
        return [paddle.rand([8]), paddle.randn([8]), paddle.randint(0, 10, [8]),
                paddle.randperm(8), paddle.multinomial(p / p.sum(), 4), paddle.bernoulli(p),
                paddle.uniform([8]), paddle.normal(0.0, 1.0, [8]), paddle.gaussian([4]),
                paddle.standard_normal([4]), paddle.rand_like(p), paddle.randn_like(p),
                paddle.randint_like(p, 0, 5), paddle.poisson(p), F.gumbel_softmax(p)]

    assert isinstance(paddle.seed(42), paddle.Generator)
    first = draws()
    paddle.seed(42)
    for a, b in zip(first, draws()):
        assert torch.equal(a, b)


def test_generator_state_round_trips():
    g = paddle.Generator(5)
    assert g.initial_seed == 5
    state = g.get_state()
    a = torch.rand(4, generator=g.generator("cpu"))
    g.set_state(state)
    assert torch.equal(a, torch.rand(4, generator=g.generator("cpu")))
    kids = g.split(3)
    assert len(kids) == 3 and len({k.initial_seed for k in kids}) == 3
    k1, k2 = g.next_key(), g.next_key()
    assert isinstance(k1, torch.Generator)
    assert not torch.equal(torch.rand(4, generator=k1), torch.rand(4, generator=k2))
    state = paddle.get_rng_state()
    x = paddle.rand([6])
    paddle.set_rng_state(state)
    assert torch.equal(x, paddle.rand([6]))


def test_key_scope_and_next_key():
    from paddle_tpu_torch.framework.random import bulk_key, key_scope, next_key

    with key_scope(3):
        a = paddle.rand([5])
        k = next_key()
    with key_scope(paddle.Generator(3)):
        assert torch.equal(a, paddle.rand([5]))
    assert isinstance(k, torch.Generator)
    with key_scope(torch.Generator().manual_seed(1)):
        b = paddle.randn([3])
    assert torch.equal(b, torch.randn(3, generator=torch.Generator().manual_seed(1)))
    assert bulk_key(k) is k


def test_draw_laws_against_reference():
    paddle.seed(0)
    jpaddle.seed(0)
    n = 20000
    for port, ref in ((paddle.uniform([n], min=-2.0, max=3.0),
                       jpaddle.uniform([n], min=-2.0, max=3.0).numpy()),
                      (paddle.normal(1.5, 2.0, [n]), jpaddle.normal(1.5, 2.0, [n]).numpy())):
        p = host(port)
        assert abs(p.mean() - ref.mean()) < 4 * ref.std() / np.sqrt(n) * np.sqrt(2)
        assert abs(p.std() - ref.std()) / ref.std() < 0.03
    u = host(paddle.uniform([n], min=-2.0, max=3.0))
    assert u.min() >= -2.0 and u.max() < 3.0
    r = host(paddle.randint(0, 10, [n]))
    assert r.min() == 0 and r.max() == 9 and abs(r.mean() - 4.5) < 0.1
    np.testing.assert_array_equal(np.sort(host(paddle.randperm(16))), np.arange(16))
    p = torch.full((n,), 0.3)
    assert abs(float(paddle.bernoulli(p).mean()) - 0.3) < 4 * np.sqrt(0.21 / n)
    x = torch.zeros(n)
    paddle.exponential_(x, 2.0)
    assert abs(float(x.mean()) - 0.5) < 4 * 0.5 / np.sqrt(n)
    probs = torch.tensor([0.1, 0.2, 0.7])
    m = paddle.multinomial(probs, n, replacement=True)
    freq = torch.bincount(m, minlength=3).float() / n
    assert float((freq - probs).abs().max()) < 4 * np.sqrt(0.25 / n)
    assert sorted(host(paddle.multinomial(probs, 3)).tolist()) == [0, 1, 2]


def test_seeded_uniform_and_gaussian_take_their_own_generator():
    a = paddle.uniform([4], seed=9)
    paddle.seed(1)
    assert torch.equal(a, paddle.uniform([4], seed=9))
    assert torch.equal(paddle.gaussian([4], seed=9), paddle.gaussian([4], seed=9))


# ---------------------------------------------------------------------------
# Tensor, to_tensor, the attributes and the method table
# ---------------------------------------------------------------------------
def test_tensor_is_torch_tensor():
    assert paddle.Tensor is torch.Tensor
    t = paddle.to_tensor([[1.0, 2.0]])
    assert paddle.is_tensor(t) and not paddle.is_tensor(np.zeros(1))
    assert t.stop_gradient and not t.requires_grad
    assert paddle.to_tensor(t) is not t
    assert paddle.to_tensor(np.ones(2, np.float32), dtype="bfloat16").dtype == torch.bfloat16
    assert paddle.to_tensor(3).dtype == torch.int64 and paddle.to_tensor(True).dtype == torch.bool
    assert paddle.to_tensor([paddle.to_tensor(1.0), 2.0]).tolist() == [1.0, 2.0]
    assert not paddle.to_tensor([1, 2], stop_gradient=False).requires_grad


def test_to_tensor_place_and_default_device():
    assert paddle.to_tensor([1.0], place=paddle.CPUPlace()).device.type == "cpu"
    assert paddle.to_tensor([1.0], place="cpu").place == paddle.CPUPlace()
    paddle.set_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="set_device"):
            paddle.to_tensor([1.0])
        with pytest.raises(RuntimeError, match="set_device"):
            paddle.zeros([2])


def test_stop_gradient_tracks_requires_grad():
    x = paddle.to_tensor([1.0, 2.0])
    x.stop_gradient = False
    assert x.requires_grad
    y = x * 2
    assert not y.stop_gradient
    y.stop_gradient = False             # a computed tensor: keeps its grad
    (y * y).sum().backward()
    np.testing.assert_allclose(host(y.grad), [4.0, 8.0])
    with pytest.raises(RuntimeError, match="detach"):
        y.stop_gradient = True
    i = paddle.to_tensor([1, 2])
    i.stop_gradient = False             # an integer leaf never requires grad
    assert i.stop_gradient
    w = paddle.Parameter(np.ones(2, np.float32))
    assert isinstance(w, torch.nn.Parameter) and not w.stop_gradient and w.persistable


def test_tensor_attributes():
    x = paddle.to_tensor(np_t((2, 3)), stop_gradient=False)
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.gradient(), np.full((2, 3), 3.0))
    x.clear_grad()
    assert x.grad is None and x.gradient() is None
    x.clear_gradient()
    assert x.place == paddle.CPUPlace() and x.place.platform == "cpu"
    assert x.astype("int32").dtype == torch.int32 and x.cast(paddle.bfloat16).dtype == \
        torch.bfloat16
    y = paddle.zeros([2, 3])
    y.set_value(np.ones((2, 3), np.float32))
    assert float(y.sum()) == 6.0
    with pytest.raises(ValueError, match="shape"):
        y.set_value(np.ones(3, np.float32))


def test_method_table():
    from paddle_tpu_torch import tensor as T

    x = paddle.to_tensor(np_t((2, 3)))
    assert T.METHODS >= T.TORCH_METHODS and len(T.METHODS) == 204
    for name in T.METHODS:
        assert callable(getattr(x, name)), name
    np.testing.assert_allclose(host(x.pad([1, 1, 2, 2], value=0.0)).shape, (4, 7))
    np.testing.assert_allclose(host(x.scale(2.0, 1.0)), host(x) * 2 + 1, rtol=1e-6)
    np.testing.assert_allclose(host(x.take_along_axis(paddle.to_tensor([[0], [2]]), 1)),
                               host(x)[[0, 1], [0, 2]][:, None])
    assert bool(x.equal_all(x)) and x.greater_than(x - 1).all()
    z = paddle.zeros([2, 3])
    assert z.reshape_([3, 2]) is z and tuple(z.shape) == (3, 2)
    # names torch has keep torch's meaning (METHOD_DEPARTURES)
    assert tuple(x.transpose(0, 1).shape) == (3, 2)
    assert tuple(paddle.transpose(x, [1, 0]).shape) == (3, 2)


# ---------------------------------------------------------------------------
# the tensor functions against the JAX package (signatures the table
# leaves out)
# ---------------------------------------------------------------------------
A = np_t((3, 4), 1)
B = np_t((3, 4), 2)
POS = np.abs(np_t((3, 4), 3)) + 0.3
SPD = (lambda m: m @ m.T + 4 * np.eye(4, dtype=np.float32))(np_t((4, 4), 4))
IDX = np.array([0, 2])

CASES = [
    # creation
    ("zeros ones full", lambda P: [P.zeros([2, 3]), P.ones([2], "int32"), P.full([2], 7.5),
                                   P.empty([2])], []),
    ("arange linspace logspace eye", lambda P: [
        P.arange(5), P.arange(1, 10, 2), P.arange(0.0, 1.0, 0.25), P.linspace(0, 1, 5),
        P.logspace(0, 2, 3), P.eye(3), P.eye(2, 3)], []),
    ("like", lambda P, a: [P.zeros_like(a), P.ones_like(a, "int32"), P.full_like(a, 2.0),
                           P.empty_like(a)], [A]),
    ("diag", lambda P, a: [P.diag(a[0]), P.diag(a[0], 1, 5.0), P.diag(a, -1), P.diagflat(a),
                           P.diag_embed(a), P.tril(a, 1), P.triu(a, -1)], [A]),
    ("indices meshgrid", lambda P, a: [P.tril_indices(3, 4, 1), P.triu_indices(3, 4, 1),
                                       *P.meshgrid(a[0], a[1, :2])], [A]),
    ("assign clone numel complex", lambda P, a: [
        P.assign(a), P.clone(a), P.numel(a), P.as_real(P.complex(a, a * 2)),
        P.as_real(P.as_complex(P.stack([a, a], -1)))], [A]),
    # math
    ("elementwise", lambda P, a, q: [
        P.abs(a), P.frac(a * 3), P.expm1(a), P.log2(q), P.log10(q), P.rsqrt(q), P.sign(a),
        P.reciprocal(q), P.square(a), P.neg(a), P.stanh(a), P.nan_to_num(a), P.logit(a.abs(), 0.1),
        P.increment(P.clone(a), 2.0), P.gcd(P.arange(6), P.full([6], 4)),
        P.bitwise_xor(P.arange(4), P.full([4], 3)), P.floor_divide(q * 5, q + 1),
        P.remainder(q * 5, q + 1), P.multiplex([a, a * 2], P.to_tensor([[1], [0], [1]]))],
     [A, POS]),
    ("reductions keepdim", lambda P, a, q: [
        P.sum(a, axis=[0, 1], keepdim=True), P.mean(a, axis=-1, keepdim=True),
        P.prod(q, axis=[0, 1]), P.max(a, axis=0, keepdim=True), P.amax(a), P.min(a),
        P.nanmean(a), P.all(a > -5, axis=1), P.any(a > 1, axis=[0, 1]),
        P.logsumexp(a, axis=[0, 1]), P.count_nonzero(a > 0, axis=1),
        P.sum(P.arange(4), dtype="float32"), P.std(a), P.var(a, axis=0, unbiased=False),
        P.median(a), P.quantile(a, [0.25, 0.5], axis=1), P.cumsum(a), P.cumprod(q),
        P.cummax(a, axis=0)[1], P.cummin(a)[0], P.trace(a, 1), P.diagonal(a, -1)], [A, POS]),
    ("products", lambda P, a, b: [
        P.matmul(a, b, transpose_x=True), P.mm(a, b.T), P.dot(a[0], b[0]), P.inner(a, b),
        P.outer(a, b[0]), P.kron(a, b[:2, :2]), P.addmm(a[:, :3], a, b.T, 0.5, 2.0),
        P.einsum("ij,ij->i", a, b), P.einsum("ij->ji", a)], [A, B]),
    ("checks", lambda P, a, b: [P.isclose(a, b, 1.0, 1.0), P.allclose(a, a), P.equal_all(a, b),
                                P.isnan(a), P.isinf(a / 0.0), P.histogram(a, 4)], [A, B]),
    # manipulation
    ("shape", lambda P, a: [
        P.reshape(a, [2, -1]), P.flatten(a[None], 1, 2), P.squeeze(a[None, :, None]),
        P.unsqueeze(a, -1), P.moveaxis(a[None], [0, 1], [2, 0]), P.broadcast_to(a[0], [2, 4]),
        P.expand_as(a[:1], a), *P.broadcast_tensors([a, a[0]]), P.cast(a, "int32"),
        P.view(a, [4, 3]), P.crop(a, [2, 2], [1, 1]), P.tile(a, [1, 2])], [A]),
    ("split stack", lambda P, a: [*P.split(a, [1, -1, 2], axis=1), *P.unstack(a),
                                  P.stack([a, a], -1), P.concat([a, a], -1)], [A]),
    ("index", lambda P, a, b, i: [
        P.gather(a, i, axis=1), P.index_sample(a, P.to_tensor([[1, 0], [2, 3], [0, 0]])),
        P.index_put(a, (i,), b[:2]), P.index_put(a, (i,), b[:2], True),
        P.scatter(a, i, b[:2], overwrite=False), P.scatter_nd(i[:, None], b[:2], [4, 4]),
        P.put_along_axis(a, P.to_tensor([[1], [2], [0]]), 9.0, 1, "add"),
        P.slice(a, [0, 1], [1, 0], [3, 2]), P.strided_slice(a, [1], [0], [4], [2]),
        P.masked_select(a, a > 0), P.repeat_interleave(a, 2), P.roll(a, [1, 2], [0, 1]),
        P.flip(a, [0, 1]), P.rot90(a, 2), P.as_strided(a, [2, 2], [1, 2])], [A, B, IDX]),
    ("pad modes", lambda P, a: [P.pad(a, [1, 2]), P.pad(a, [1, 0, 0, 2], value=3.0),
                                P.pad(a[None], [2, 1], mode="replicate"),
                                P.pad(a[None, None], [1, 1, 1, 1], mode="circular")], [A]),
    ("unique", lambda P, a: [*P.unique(P.to_tensor([3, 1, 3, 2, 1]), True, True, True),
                             *P.unique_consecutive(P.to_tensor([1, 1, 2, 2, 1]), True, True),
                             P.tensordot(a, a, [[1], [1]])], [A]),
    # logic, search
    ("logic", lambda P, a, b: [
        P.logical_xor(a > 0, b > 0), P.logical_or(a > 0, b > 0), P.not_equal(a, b),
        P.greater_equal(a, 0.0), P.is_empty(a), P.is_empty(P.zeros([0]))], [A, B]),
    ("search", lambda P, a, b: [
        P.argmax(a), P.argmax(a, axis=0, keepdim=True), P.argmin(a, axis=-1),
        P.argsort(a, axis=0, descending=True), P.sort(a, axis=0), *P.topk(a, 2, axis=0,
                                                                            largest=False),
        *P.kthvalue(a, 2, axis=1, keepdim=True), *P.mode(P.to_tensor([[1, 2, 2], [3, 3, 1]])),
        *P.where(a > 0), P.where(a > 0, a, 0.0), P.nonzero(a > 0),
        P.searchsorted(P.to_tensor([[0.0, 1.0], [-1.0, 0.0], [0.0, 0.5]]), a[:, :2],
                       right=True), P.index_fill(a, P.to_tensor([1]), 1, -1.0),
        P.masked_scatter(a, a > 0, b), P.isin(a, a[0])], [A, B]),
    # linalg
    ("linalg", lambda P, s, a: [
        P.linalg.norm(a, 3, axis=1), P.linalg.norm(a, "fro", [0, 1]), P.linalg.norm(a, 2.5),
        P.linalg.vector_norm(a, 1.0), P.linalg.matrix_norm(a, "nuc"),
        P.linalg.qr(s)[1].abs(), P.linalg.svd(s)[1], P.linalg.eigh(s)[0],
        P.linalg.matrix_rank(s), P.linalg.cond(s), P.linalg.cov(a, rowvar=False),
        P.linalg.corrcoef(a), P.linalg.multi_dot([a, a.T]), P.linalg.svdvals(s),
        P.linalg.cholesky(s, upper=True), P.linalg.triangular_solve(
            P.tril(s), s[:, :2], upper=False, transpose=True)],
     [SPD, A]),
]


def _run(P, fn, arrays):
    return fn(P, *[P.to_tensor(a) for a in arrays])


def _np(v):
    if isinstance(v, torch.Tensor):
        return host(v)
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


@pytest.mark.parametrize("label,fn,arrays", CASES, ids=[c[0] for c in CASES])
def test_tensor_functions_against_reference(label, fn, arrays):
    got, want = _run(paddle, fn, arrays), _run(jpaddle, fn, arrays)
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, f"{label} [{i}]: {g.shape} vs {w.shape}"
        if w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f"{label} [{i}]")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} [{i}]")


def test_in_place_forms_keep_autograd():
    x = paddle.to_tensor(np_t((2, 3)), stop_gradient=False)
    y = x * 2
    paddle.reshape_(y, [3, 2])
    paddle.unsqueeze_(y, 0)
    paddle.squeeze_(y, 0)
    assert tuple(y.shape) == (3, 2)
    paddle.scatter_(y, paddle.to_tensor([0]), paddle.zeros([1, 2]))
    (y * paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(3, 2))).sum().backward()
    want = 2 * np.arange(6, dtype=np.float32)
    want[:2] = 0
    np.testing.assert_allclose(x.gradient(), want.reshape(2, 3))
    with pytest.raises(RuntimeError, match="leaf"):
        paddle.reshape_(x, [3, 2])
    z = paddle.to_tensor([1.0, 2.0])
    assert paddle.where_(z > 1, z, paddle.zeros_like(z)) is z and z.tolist() == [0.0, 2.0]


def test_check_nan_inf_raises():
    x = paddle.to_tensor([0.0, 1.0])
    paddle.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="log"):
            paddle.log(x)
        assert float(paddle.exp(x).sum()) > 0
    finally:
        paddle.set_flags({"check_nan_inf": False})
    assert torch.isinf(paddle.log(x)).any()


# ---------------------------------------------------------------------------
# the cases of tests/test_tensor.py on the port (torch's departures:
# ``shape`` is a torch.Size, ``dtype`` a torch dtype, ``numpy()`` refuses a
# tensor that requires grad)
# ---------------------------------------------------------------------------
class TestTensorCases:
    def test_to_tensor(self):
        x = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
        assert list(x.shape) == [2, 2] and x.dtype == paddle.float32
        np.testing.assert_allclose(x.numpy(), [[1, 2], [3, 4]])

    def test_zeros_ones_full(self):
        assert paddle.zeros([2, 3]).numpy().sum() == 0
        assert paddle.ones([2, 3]).numpy().sum() == 6
        np.testing.assert_allclose(paddle.full([2], 7.5).numpy(), [7.5, 7.5])

    def test_arange_linspace(self):
        np.testing.assert_allclose(paddle.arange(5).numpy(), np.arange(5))
        np.testing.assert_allclose(paddle.arange(1, 10, 2).numpy(), np.arange(1, 10, 2))
        np.testing.assert_allclose(paddle.linspace(0, 1, 5).numpy(), np.linspace(0, 1, 5),
                                   rtol=1e-6)

    def test_eye_tril_triu(self):
        np.testing.assert_allclose(paddle.eye(3).numpy(), np.eye(3))
        a = np_t((4, 4))
        np.testing.assert_allclose(paddle.tril(paddle.to_tensor(a)).numpy(), np.tril(a))
        np.testing.assert_allclose(paddle.triu(paddle.to_tensor(a), 1).numpy(), np.triu(a, 1))

    def test_like_variants(self):
        x = paddle.to_tensor(np_t((2, 3)))
        assert list(paddle.zeros_like(x).shape) == [2, 3]
        assert paddle.ones_like(x).numpy().sum() == 6
        np.testing.assert_allclose(paddle.full_like(x, 2).numpy(), np.full((2, 3), 2.0))

    def test_elementwise_binary(self):
        a, b = np_t((3, 4), 1), np_t((3, 4), 2)
        x, y = paddle.to_tensor(a), paddle.to_tensor(b)
        np.testing.assert_allclose((x + y).numpy(), a + b, rtol=1e-6)
        np.testing.assert_allclose((x - y).numpy(), a - b, rtol=1e-6)
        np.testing.assert_allclose((x * y).numpy(), a * b, rtol=1e-6)
        np.testing.assert_allclose((x / y).numpy(), a / b, rtol=1e-5)
        np.testing.assert_allclose(paddle.maximum(x, y).numpy(), np.maximum(a, b))

    def test_scalar_ops_preserve_dtype(self):
        x = paddle.to_tensor(np_t((2, 2)), dtype="bfloat16")
        assert (x + 1.5).dtype == paddle.to_tensor(0, dtype="bfloat16").dtype
        assert (2.0 * x).dtype == x.dtype
        assert paddle.add(x, 1.5).dtype == paddle.maximum(x, 0.5).dtype == torch.bfloat16

    def test_unary(self):
        a = np.abs(np_t((3, 3))) + 0.1
        x = paddle.to_tensor(a)
        np.testing.assert_allclose(paddle.log(x).numpy(), np.log(a), rtol=1e-5)
        np.testing.assert_allclose(paddle.sqrt(x).numpy(), np.sqrt(a), rtol=1e-6)
        np.testing.assert_allclose(paddle.exp(x).numpy(), np.exp(a), rtol=1e-5)
        np.testing.assert_allclose(x.tanh().numpy(), np.tanh(a), rtol=1e-6)

    def test_reductions(self):
        a = np_t((2, 3, 4))
        x = paddle.to_tensor(a)
        np.testing.assert_allclose(x.sum().numpy(), a.sum(), rtol=1e-5)
        np.testing.assert_allclose(x.mean(axis=1).numpy(), a.mean(1), rtol=1e-5)
        np.testing.assert_allclose(paddle.max(x, axis=[0, 2]).numpy(), a.max((0, 2)))
        np.testing.assert_allclose(x.sum(axis=-1, keepdim=True).numpy(),
                                   a.sum(-1, keepdims=True), rtol=1e-5)

    def test_matmul(self):
        a, b = np_t((3, 4)), np_t((4, 5))
        out = paddle.matmul(paddle.to_tensor(a), paddle.to_tensor(b))
        np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-5)
        out_t = paddle.matmul(paddle.to_tensor(a.T), paddle.to_tensor(b), transpose_x=True)
        np.testing.assert_allclose(out_t.numpy(), a @ b, rtol=1e-5)

    def test_cumsum_clip(self):
        a = np_t((3, 4))
        x = paddle.to_tensor(a)
        np.testing.assert_allclose(x.cumsum(axis=1).numpy(), a.cumsum(1), rtol=1e-5)
        np.testing.assert_allclose(x.clip(-0.5, 0.5).numpy(), a.clip(-0.5, 0.5))

    def test_einsum(self):
        a, b = np_t((2, 3)), np_t((3, 4))
        out = paddle.einsum("ij,jk->ik", paddle.to_tensor(a), paddle.to_tensor(b))
        np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-5)

    def test_reshape_transpose(self):
        a = np_t((2, 3, 4))
        x = paddle.to_tensor(a)
        assert list(x.reshape([6, 4]).shape) == [6, 4]
        assert list(x.reshape([-1]).shape) == [24]
        np.testing.assert_allclose(paddle.transpose(x, [2, 0, 1]).numpy(), a.transpose(2, 0, 1))

    def test_concat_stack_split(self):
        a, b = np_t((2, 3)), np_t((2, 3), 1)
        x, y = paddle.to_tensor(a), paddle.to_tensor(b)
        np.testing.assert_allclose(paddle.concat([x, y], axis=0).numpy(),
                                   np.concatenate([a, b], 0))
        np.testing.assert_allclose(paddle.stack([x, y], axis=1).numpy(), np.stack([a, b], 1))
        parts = paddle.split(paddle.to_tensor(np_t((6, 2))), 3, axis=0)
        assert len(parts) == 3 and list(parts[0].shape) == [2, 2]
        parts = paddle.split(paddle.to_tensor(np_t((7, 2))), [2, 5], axis=0)
        assert list(parts[1].shape) == [5, 2]

    def test_squeeze_unsqueeze_tile(self):
        x = paddle.to_tensor(np_t((1, 3, 1)))
        assert list(x.squeeze().shape) == [3]
        assert list(x.squeeze(axis=0).shape) == [3, 1]
        assert list(x.unsqueeze(0).shape) == [1, 1, 3, 1]
        assert list(paddle.tile(paddle.ones([2]), [3]).shape) == [6]

    def test_gather_scatter(self):
        a = np_t((5, 3))
        x = paddle.to_tensor(a)
        idx = paddle.to_tensor(np.array([0, 2, 4]))
        np.testing.assert_allclose(paddle.gather(x, idx).numpy(), a[[0, 2, 4]])
        upd = paddle.to_tensor(np.ones((2, 3), "float32"))
        out = paddle.scatter(x, paddle.to_tensor(np.array([1, 3])), upd)
        assert out.numpy()[1].sum() == 3.0

    def test_indexing(self):
        a = np_t((4, 5))
        x = paddle.to_tensor(a)
        np.testing.assert_allclose(x[1].numpy(), a[1])
        np.testing.assert_allclose(x[:, 2:4].numpy(), a[:, 2:4])
        np.testing.assert_allclose(x[::2, -1].numpy(), a[::2, -1])
        x[0] = 0.0
        assert x.numpy()[0].sum() == 0.0

    def test_where_topk_sort(self):
        a = np_t((3, 5))
        x = paddle.to_tensor(a)
        np.testing.assert_allclose(
            paddle.where(x > 0, x, paddle.zeros_like(x)).numpy(), np.where(a > 0, a, 0))
        vals, idx = paddle.topk(x, 2, axis=-1)
        np.testing.assert_allclose(vals.numpy(), np.sort(a, -1)[:, ::-1][:, :2], rtol=1e-6)
        np.testing.assert_allclose(paddle.sort(x, axis=-1).numpy(), np.sort(a, -1))

    def test_pad(self):
        out = paddle.to_tensor(np_t((2, 3))).pad([1, 1, 2, 2], value=0.0)
        assert list(out.shape) == [4, 7]

    def test_comparisons(self):
        a, b = np_t((3,)), np_t((3,), 1)
        x, y = paddle.to_tensor(a), paddle.to_tensor(b)
        np.testing.assert_array_equal((x > y).numpy(), a > b)
        np.testing.assert_array_equal(paddle.logical_and(x > 0, y > 0).numpy(),
                                      (a > 0) & (b > 0))

    def test_argmax_nonzero(self):
        a = np_t((3, 4))
        x = paddle.to_tensor(a)
        assert int(x.argmax().numpy()) == int(a.argmax())
        np.testing.assert_array_equal(paddle.argmax(x, axis=1).numpy(), a.argmax(1))
        nz = paddle.nonzero(paddle.to_tensor(np.array([0, 1, 0, 2])))
        np.testing.assert_array_equal(nz.numpy().reshape(-1), [1, 3])

    def test_solve_inv_det(self):
        a = np_t((3, 3)) + 3 * np.eye(3, dtype="float32")
        b = np_t((3, 2))
        x = paddle.to_tensor(a)
        np.testing.assert_allclose(paddle.linalg.inv(x).numpy(), np.linalg.inv(a), rtol=1e-4)
        np.testing.assert_allclose(paddle.linalg.solve(x, paddle.to_tensor(b)).numpy(),
                                   np.linalg.solve(a, b), rtol=1e-4)
        np.testing.assert_allclose(paddle.linalg.det(x).numpy(), np.linalg.det(a), rtol=1e-4)

    def test_norm(self):
        a = np_t((3, 4))
        np.testing.assert_allclose(paddle.linalg.norm(paddle.to_tensor(a)).numpy(),
                                   np.linalg.norm(a), rtol=1e-5)

    def test_astype(self):
        x = paddle.to_tensor([1.5, 2.5])
        assert x.astype("int32").numpy().dtype == np.int32
        assert x.astype(paddle.bfloat16).astype("float32").numpy()[0] == 1.5

    def test_set_device_cpu(self):
        paddle.set_device("cpu")
        assert paddle.get_device().type == "cpu"

    def test_flags(self):
        paddle.set_flags({"check_nan_inf": True})
        assert paddle.get_flags("check_nan_inf")["check_nan_inf"] is True
        paddle.set_flags({"check_nan_inf": False})

    def test_item_float_len(self):
        x = paddle.to_tensor([3.0])
        assert float(x[0]) == 3.0
        assert len(x) == 1

    def test_seed_reproducible(self):
        paddle.seed(42)
        a = paddle.rand([4]).numpy()
        paddle.seed(42)
        np.testing.assert_array_equal(a, paddle.rand([4]).numpy())

    def test_shapes_and_ranges(self):
        u = paddle.uniform([1000], min=0.0, max=1.0)
        assert u.numpy().min() >= 0.0 and u.numpy().max() <= 1.0
        r = paddle.randint(0, 10, [100])
        assert r.numpy().min() >= 0 and r.numpy().max() < 10
        np.testing.assert_array_equal(np.sort(paddle.randperm(16).numpy()), np.arange(16))


def test_device_names():
    assert paddle.device_count("cpu") == 1
    assert paddle.CPUPlace() == paddle.Place("cpu") and repr(paddle.CPUPlace()) == "Place(cpu:0)"
    with paddle.DeviceGuard("cpu"):
        assert paddle.zeros([1]).device.type == "cpu"
    paddle.synchronize("cpu")
    assert paddle.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert paddle.in_dynamic_mode() and not paddle.is_compiled_with_tpu()
    from paddle_tpu_torch import device

    assert device.get_all_devices()[-1] == "cpu:0"
    assert device.current_device() == paddle.CPUPlace()
    with pytest.raises(NotImplementedError, match="A10"):
        device.Stream
    with pytest.raises(NotImplementedError, match="A3d"):
        paddle.enable_static()
