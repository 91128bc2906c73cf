"""The port's autograd against the JAX package's, on the CPU: every case of
``tests/test_autograd.py`` outside ``TestJitInterop`` (the port has no JAX
tracing: ``Tensor`` is ``torch.Tensor`` and torch's autograd is the tape),
each run through both packages on the same inputs, plus ``paddle.grad``
with unused inputs and ``create_graph``, ``PyLayer`` (saved tensors,
keyword arguments, non-tensor arguments, refusal to be instantiated),
``backward`` over several roots, the grad-mode switches, and ``jacobian``
/ ``hessian`` / ``vjp`` / ``jvp`` of several functions against the
reference's ``jax.jacrev``/``jax.hessian`` results.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import autograd as jautograd

import paddle_tpu_torch as paddle
from paddle_tpu_torch import autograd
from paddle_tpu_torch.autograd import PyLayer

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=1e-6)    # tests/op_test.py, float32


@pytest.fixture(autouse=True)
def _on_cpu():
    paddle.set_device("cpu")
    yield
    paddle.set_device(None)


def leaf(P, a):
    t = P.to_tensor(a)
    t.stop_gradient = False
    return t


def val(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def both(fn):
    """``fn(P)`` for the port and the reference: a list of arrays each."""
    return [[val(t) for t in fn(P)] for P in (paddle, jpaddle)]


def assert_same(fn, **tol):
    got, want = both(fn)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **(tol or F32))


# ---------------------------------------------------------------------------
# tests/test_autograd.py TestBackward
# ---------------------------------------------------------------------------
class TestBackward:
    def test_backward_grad_tensor_keyword(self):
        """C7: ``backward(grad_tensor=...)``, the reference's keyword, as
        a positional call does in both packages."""
        def run(P, **kw):
            w = leaf(P, np.ones(3, "float32"))
            g = P.to_tensor(np.array([1.0, 2.0, 3.0], "float32"))
            (w * 2).backward(**kw, **({"grad_tensor": g} if not kw else {}))
            return [w.grad]

        assert_same(run)
        np.testing.assert_allclose(both(run)[0][0], [2.0, 4.0, 6.0])

        def positional(P):
            w = leaf(P, np.ones(3, "float32"))
            (w * 2).backward(P.to_tensor(np.array([1.0, 2.0, 3.0], "float32")))
            return [w.grad]

        assert_same(positional)
        w = leaf(paddle, np.ones(3, "float32"))
        with pytest.raises(TypeError, match="not both"):
            (w * 2).backward(torch.ones(3), grad_tensor=torch.ones(3))

    def test_simple_chain(self):
        def run(P):
            x = leaf(P, np.array([2.0, 3.0], "float32"))
            (x * x).sum().backward()
            return [x.grad]

        assert_same(run)
        np.testing.assert_allclose(both(run)[0][0], [4.0, 6.0])

    def test_branching(self):
        def run(P):
            x = leaf(P, np.array([1.0, 2.0], "float32"))
            ((x * 2) + (x * 3)).sum().backward()
            return [x.grad]

        assert_same(run)

    def test_matmul_grad(self):
        a = np.random.default_rng(0).standard_normal((3, 4)).astype("float32")
        b = np.random.default_rng(1).standard_normal((4, 2)).astype("float32")

        def run(P):
            x, y = leaf(P, a), leaf(P, b)
            P.matmul(x, y).sum().backward()
            return [x.grad, y.grad]

        assert_same(run)

    def test_grad_accumulation(self):
        def run(P):
            x = leaf(P, np.array([1.0], "float32"))
            (x * 2).sum().backward()
            (x * 3).sum().backward()
            g = x.grad
            x.clear_grad()
            assert x.grad is None
            return [g]

        assert_same(run)

    def test_stop_gradient_blocks(self):
        def run(P):
            x = leaf(P, np.array([1.0], "float32"))
            y = P.to_tensor(np.array([2.0], "float32"))
            (x * y).sum().backward()
            assert y.grad is None
            return [x.grad]

        assert_same(run)

    def test_detach(self):
        def run(P):
            x = leaf(P, np.array([3.0], "float32"))
            y = (x * x).detach()
            (y * x).sum().backward()
            return [x.grad]

        assert_same(run)
        np.testing.assert_allclose(both(run)[0][0], [9.0])

    def test_non_scalar_needs_grad_tensor(self):
        def run(P):
            x = leaf(P, np.ones((2, 2), "float32"))
            y = x * 2
            with pytest.raises(RuntimeError):
                y.backward()
            y.backward(P.ones([2, 2]))
            return [x.grad]

        assert_same(run)

    def test_no_grad_context(self):
        for P in (paddle, jpaddle):
            x = leaf(P, np.array([1.0], "float32"))
            with P.no_grad():
                y = x * 2
            assert y.stop_gradient

    def test_hook_fires_and_scales(self):
        def run(P):
            x = leaf(P, np.array([1.0, 1.0], "float32"))
            seen = []

            def hook(g):
                seen.append(val(g).copy())
                return g * 2

            x.register_hook(hook)
            (x * 3).sum().backward()
            assert len(seen) == 1
            return [seen[0], x.grad]

        assert_same(run)

    def test_setitem_grad_flows(self):
        def run(P):
            x = leaf(P, np.ones((3,), "float32"))
            y = x * 2
            y[0] = 0.0
            y.sum().backward()
            return [x.grad]

        assert_same(run)
        np.testing.assert_allclose(both(run)[0][0], [0.0, 2.0, 2.0])

    def test_paddle_grad_api(self):
        def run(P):
            x = leaf(P, np.array([2.0], "float32"))
            y = x * x * x
            (g,) = P.grad(y, x, retain_graph=True)
            assert x.grad is None      # paddle.grad must not pollute .grad
            return [g]

        assert_same(run)

    def test_broadcast_grad(self):
        def run(P):
            x = leaf(P, np.ones((3, 1), "float32"))
            y = leaf(P, np.ones((1, 4), "float32"))
            (x + y).sum().backward()
            return [x.grad, y.grad]

        assert_same(run)


# ---------------------------------------------------------------------------
# paddle.grad and backward beyond the reference's cases
# ---------------------------------------------------------------------------
def test_grad_leaves_every_grad_as_it_was():
    def run(P):
        x = leaf(P, np.array([1.0, 2.0], "float32"))
        w = leaf(P, np.array([3.0, 4.0], "float32"))
        (x * w).sum().backward()
        before = [val(x.grad).copy(), val(w.grad).copy()]
        (g,) = P.grad((x * w * w).sum(), x)
        assert np.array_equal(val(x.grad), before[0]) and np.array_equal(val(w.grad), before[1])
        return [g]

    assert_same(run)


def test_grad_unused_input_zeros_unless_allow_unused():
    def run(P):
        x = leaf(P, np.array([1.0, 2.0], "float32"))
        u = leaf(P, np.array([5.0], "float32"))
        gx, gu = P.grad((x * x).sum(), [x, u], retain_graph=True)
        got = P.grad((x * x).sum(), [x, u], allow_unused=True)
        assert got[1] is None
        return [gx, gu]

    assert_same(run)
    np.testing.assert_allclose(both(run)[0][1], [0.0])


def test_grad_outputs_and_several_outputs():
    def run(P):
        x = leaf(P, np.array([1.0, 2.0], "float32"))
        y1, y2 = x * x, x * 3
        (g,) = P.grad([y1, y2], x, [P.to_tensor(np.array([1.0, 0.5], "float32")),
                                   P.ones([2])])
        return [g]

    assert_same(run)


def test_double_backward():
    x0 = np.array([0.3, -1.2, 2.0], "float32")
    x = leaf(paddle, x0)
    (g,) = paddle.grad((x ** 3).sum(), x, create_graph=True)
    (gg,) = paddle.grad((g * g).sum(), x)
    # d/dx sum((3x^2)^2) = 36 x^3
    np.testing.assert_allclose(val(gg), 36 * x0 ** 3, rtol=1e-5)
    np.testing.assert_allclose(val(g), 3 * x0 ** 2, rtol=1e-6)


def test_backward_several_roots():
    def run(P):
        x = leaf(P, np.array([1.0, 2.0], "float32"))
        P.autograd.backward([(x * x).sum(), (x * 3).sum()])
        return [x.grad]

    assert_same(run)


def test_grad_modes():
    x = leaf(paddle, np.array([1.0], "float32"))
    assert paddle.is_grad_enabled()
    with paddle.set_grad_enabled(False):
        assert not paddle.is_grad_enabled() and (x * 2).stop_gradient
    with paddle.no_grad():
        with paddle.enable_grad():
            assert not (x * 2).stop_gradient

    @paddle.no_grad()
    def f(t):
        return t * 2

    @paddle.no_grad
    def h(t):
        return t * 2

    assert f(x).stop_gradient and h(x).stop_gradient and paddle.is_grad_enabled()
    paddle.set_grad_enabled(False)
    try:
        assert not paddle.is_grad_enabled()
    finally:
        paddle.set_grad_enabled(True)


# ---------------------------------------------------------------------------
# PyLayer (tests/test_autograd.py TestPyLayer, through both packages)
# ---------------------------------------------------------------------------
def _double(P):
    class Double(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * 2

    return Double


def _split_merge(P):
    class SplitMerge(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            return x * 2, x * 3

        @staticmethod
        def backward(ctx, ga, gb):
            return ga * 2 + gb * 3

    return SplitMerge


class TestPyLayer:
    def test_custom_forward_backward(self):
        def run(P):
            x = leaf(P, np.array([3.0], "float32"))
            y = _double(P).apply(x)
            y.sum().backward()
            return [y, x.grad]

        assert_same(run)
        np.testing.assert_allclose(both(run)[0][1], [2.0])

    def test_multi_output(self):
        def run(P):
            x = leaf(P, np.array([1.0], "float32"))
            a, b = _split_merge(P).apply(x)
            (a * 2 + b * 3).sum().backward()
            return [x.grad]

        assert_same(run)
        np.testing.assert_allclose(both(run)[0][0], [13.0])


def test_pylayer_kwargs_and_non_tensor_args():
    def make(P):
        class ScaleBy(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, w, factor, shift=0.0):
                ctx.save_for_backward(x, w)
                ctx.attrs["factor"] = factor
                return x * w * factor + shift

            @staticmethod
            def backward(ctx, g):
                x, w = ctx.saved_tensor()
                f = ctx.attrs["factor"]
                return g * w * f, g * x * f

        return ScaleBy

    def run(P):
        x = leaf(P, np.array([1.0, 2.0], "float32"))
        w = leaf(P, np.array([3.0, -1.0], "float32"))
        y = make(P).apply(x, w, 0.5, shift=1.0)
        y.sum().backward()
        return [y, x.grad, w.grad]

    assert_same(run)


def test_pylayer_refuses_instantiation_and_grad_flows_only_when_asked():
    with pytest.raises(RuntimeError, match="apply"):
        _double(paddle)()
    x = paddle.to_tensor(np.array([1.0], "float32"))
    y = _double(paddle).apply(x)
    assert y.stop_gradient
    assert issubclass(autograd.LegacyPyLayer, PyLayer)
    ctx = autograd.PyLayerContext()
    ctx.save_for_backward(1, 2)
    assert ctx.saved_tensor() == (1, 2) == ctx.saved_tensors


def test_pylayer_paddle_grad_and_none_grads():
    class Pick(PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            return a * 1.0

        @staticmethod
        def backward(ctx, g):
            return g, None

    a = leaf(paddle, np.array([1.0, 2.0], "float32"))
    b = leaf(paddle, np.array([3.0], "float32"))
    ga, gb = paddle.grad(Pick.apply(a, b).sum(), [a, b])
    np.testing.assert_allclose(val(ga), [1.0, 1.0])
    np.testing.assert_allclose(val(gb), [0.0])


# ---------------------------------------------------------------------------
# TestFunctionalAutograd, through both packages
# ---------------------------------------------------------------------------
class TestFunctionalAutograd:
    def test_jacobian_analytic(self):
        assert_same(lambda P: [P.autograd.jacobian(
            lambda v: v * v, P.to_tensor(np.array([1.0, 2.0, 3.0], np.float32)))])

    def test_jacobian_batched(self):
        x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
        jac = autograd.jacobian(lambda v: v ** 3, paddle.to_tensor(x), batch_axis=0)
        assert list(jac.shape) == [2, 2, 2]
        assert_same(lambda P: [P.autograd.jacobian(lambda v: v ** 3, P.to_tensor(x),
                                                   batch_axis=0)])

    def test_jacobian_fwd_matches_rev(self):
        x = np.random.default_rng(0).standard_normal(4).astype(np.float32)
        for mode in ("rev", "fwd"):
            assert_same(lambda P: [P.autograd.jacobian(lambda v: P.sin(v) * v, P.to_tensor(x),
                                                       mode=mode)], rtol=1e-5, atol=1e-6)

    def test_jacobian_several_inputs(self):
        a = np.array([1.0, 2.0], np.float32)
        b = np.array([0.5, -1.0], np.float32)
        assert_same(lambda P: list(P.autograd.jacobian(
            lambda u, v: P.exp(u) * v, (P.to_tensor(a), P.to_tensor(b)))), rtol=1e-5)

    def test_hessian_quadratic(self):
        A = np.array([[2.0, 1.0], [1.0, 4.0]], np.float32)

        def run(P):
            x = P.to_tensor(np.array([1.0, -1.0], np.float32))
            return [P.autograd.hessian(
                lambda v: 0.5 * (P.matmul(v, P.to_tensor(A)) * v).sum(), x)]

        assert_same(run, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(both(run)[0][0], A, rtol=1e-5)

    def test_hessian_of_a_nonlinear_function(self):
        x = np.array([0.3, -0.7, 1.1], np.float32)
        assert_same(lambda P: [P.autograd.hessian(
            lambda v: (P.tanh(v) ** 3).sum() + (v[0] * v[1]), P.to_tensor(x))],
            rtol=1e-5, atol=1e-6)

    def test_hessian_rejects_vector_output(self):
        for P in (paddle, jpaddle):
            with pytest.raises(ValueError, match="scalar"):
                P.autograd.hessian(lambda v: v * 2, P.to_tensor(np.ones(3, np.float32)))

    def test_vjp_jvp_consistency(self):
        def run(P):
            x = P.to_tensor(np.array([0.5, 1.5], np.float32))
            v = P.to_tensor(np.array([1.0, 0.0], np.float32))
            out, pullback = P.autograd.vjp(lambda t: P.exp(t), x, v)
            out2, pushfwd = P.autograd.jvp(lambda t: P.exp(t), x, v)
            return [out, pullback, out2, pushfwd]

        assert_same(run, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(both(run)[0][1], [np.exp(0.5), 0.0], rtol=1e-5)

    def test_vjp_jvp_defaults(self):
        x = np.array([0.2, -0.4, 0.9], np.float32)
        assert_same(lambda P: [*P.autograd.vjp(lambda t: P.sin(t) * t, P.to_tensor(x)),
                               *P.autograd.jvp(lambda t: P.sin(t) * t, P.to_tensor(x))],
                    rtol=1e-6, atol=1e-6)

    def test_layer_params_are_constants(self):
        lin = paddle.nn.Linear(3, 2, device="cpu")
        x = paddle.to_tensor(np.ones(3, np.float32))
        jac = autograd.jacobian(lambda v: lin(v), x)
        np.testing.assert_allclose(val(jac), val(lin.weight).T, rtol=1e-5)
        assert lin.weight.grad is None


def test_reference_pylayer_import_paths():
    assert jautograd.PyLayer and autograd.PyLayer and paddle.autograd.PyLayerContext
    for name in autograd.__all__:
        assert hasattr(jautograd, name) and hasattr(autograd, name)
