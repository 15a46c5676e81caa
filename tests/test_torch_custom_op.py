"""``mx.operator`` (CustomOp, CustomOpProp, register, the ``Custom`` op),
the port against the JAX package on the CPU (cases after
``tests/test_custom_op.py``): forward with keyword parameters, backward,
two inputs and outputs, auxiliary states, the default zero backward,
inside eager and hybridized Gluon blocks, in a symbol bound through the
Executor, and the errors. Each op is written once as ``make(mx)`` and
registered in both packages; f32 within 2e-5 of each tensor's largest
value.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt

CPU = mt.cpu()


def _close(got, want, tol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) / scale <= tol


def make(mx):
    """The test ops, registered in package ``mx``."""

    @mx.operator.register("t_sqr")
    class SqrProp(mx.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr(self.scale)

    class Sqr(mx.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0] * in_data[0] * self.scale)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        2 * self.scale * in_data[0] * out_grad[0])

    @mx.operator.register("t_twosum")
    class TwoSumProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "diff"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return TwoSum()

    class TwoSum(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] + in_data[1])
            self.assign(out_data[1], req[1], in_data[0] - in_data[1])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] + out_grad[1])
            self.assign(in_grad[1], req[1], out_grad[0] - out_grad[1])

    @mx.operator.register("t_scaled")
    class ScaledProp(mx.operator.CustomOpProp):
        """One auxiliary state (a running scale) read by the forward; the
        backward uses the forward's output (need_top_grad)."""

        def list_arguments(self):
            return ["data"]

        def list_auxiliary_states(self):
            return ["factor"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [[1]]

        def create_operator(self, ctx, shapes, dtypes):
            return Scaled()

    class Scaled(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        mx.nd.tanh(in_data[0]) * aux[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0] / aux[0]
            self.assign(in_grad[0], req[0], out_grad[0] * (1 - y * y)
                        * aux[0])

    @mx.operator.register("t_fwdonly")
    class FwdOnlyProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return FwdOnly()

    class FwdOnly(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 5)

    @mx.operator.register("t_mode")
    class ModeProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Mode()

    class Mode(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0] * (2.0 if is_train else 1.0))


make(jmx)
make(mt)
X = np.array([[1.0, -2.0, 3.0], [0.5, 4.0, -1.5]], np.float32)


def _both(run):
    out = []
    for mx in (jmx, mt):
        with mx.cpu():
            out.append([np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                                   else v) for v in run(mx)])
    return out


def _forward(mx):
    x = mx.nd.array(X)
    return [mx.nd.Custom(x, op_type="t_sqr"),
            mx.nd.Custom(x, op_type="t_sqr", scale=3.0)]


def _backward(mx):
    x = mx.nd.array(X)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="t_sqr", scale="0.5")
        (y * mx.nd.array(X[::-1].copy())).sum().backward()
    return [y, x.grad]


def _multi_io(mx):
    a, b = mx.nd.array(X), mx.nd.array(X * 10)
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        s, d = mx.nd.Custom(a, b, op_type="t_twosum")
        loss = (s * 2).sum() + d.sum()
    loss.backward()
    return [s, d, a.grad, b.grad]


def _aux(mx):
    x = mx.nd.array(X)
    x.attach_grad()
    f = mx.nd.array([0.7])
    with mx.autograd.record():
        y = mx.nd.Custom(x, f, op_type="t_scaled")
        y.sum().backward()
    return [y, x.grad]


def _default_backward(mx):
    x = mx.nd.array(X)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="t_fwdonly")
        y.sum().backward()
    return [y, x.grad]


def _mode(mx):
    x = mx.nd.array(X)
    with mx.autograd.record():
        train = mx.nd.Custom(x, op_type="t_mode")
    return [mx.nd.Custom(x, op_type="t_mode"), train]


@pytest.mark.parametrize("run", [_forward, _backward, _multi_io, _aux,
                                 _default_backward, _mode],
                         ids=lambda f: f.__name__[1:])
def test_custom_op_matches_jax(run):
    """Outputs and gradients of the Custom op as the JAX package's."""
    j, t = _both(run)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        _close(a, b)


def test_custom_op_values():
    with CPU:
        y, g = _backward(mt)
        np.testing.assert_allclose(g.asnumpy(), X * X[::-1], rtol=1e-6)
        y, g = _default_backward(mt)
        np.testing.assert_array_equal(g.asnumpy(), np.zeros_like(X))
        assert "t_sqr" in mt.operator.get_all_registered()


@pytest.mark.parametrize("hybridize", [False, True])
def test_custom_op_in_gluon_block(hybridize):
    """``F.Custom`` in a hybrid_forward, eager and hybridized: outputs and
    the input's gradient."""
    def run(mx):
        class Net(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, x):
                return F.Custom(x, op_type="t_sqr", scale=2.0) + x

        net = Net()
        if hybridize:
            net.hybridize()
        x = mx.nd.array(X)
        x.attach_grad()
        with mx.autograd.record():
            y = net(x)
            y.sum().backward()
        return [y, x.grad]
    j, t = _both(run)
    for a, b in zip(t, j):
        _close(a, b)


def test_custom_op_symbolic():
    """``mx.sym.Custom`` bound through the Executor, forward and
    backward."""
    def run(mx):
        data = mx.sym.Variable("data")
        out = mx.sym.Custom(data, op_type="t_sqr", scale=1.5, name="sq")
        ex = out.simple_bind(mx.cpu(), data=X.shape)
        y = ex.forward(is_train=True, data=mx.nd.array(X))[0]
        ex.backward(out_grads=mx.nd.ones(X.shape))
        return [y, ex.grad_dict["data"]]
    j, t = _both(run)
    for a, b in zip(t, j):
        _close(a, b)


def test_custom_op_errors():
    for mx in (jmx, mt):
        with mx.cpu():
            with pytest.raises(Exception, match="not registered"):
                mx.nd.Custom(mx.nd.zeros((2,)), op_type="not_a_real_op")
            with pytest.raises(Exception, match="expected 2 arguments"):
                mx.nd.Custom(mx.nd.zeros((2,)), op_type="t_twosum")
            with pytest.raises(Exception, match="CustomOpProp"):
                mx.operator.register("bad")(int)
            with pytest.raises(Exception, match="deprecated"):
                mx.operator.NumpyOp()
