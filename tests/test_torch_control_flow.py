"""Control flow, the port against the JAX package on the CPU (cases after
``tests/test_contrib_control_flow.py`` and
``tests/test_symbol_control_flow.py``):

- ``mx.nd.contrib.foreach`` / ``while_loop`` / ``cond`` and their
  gradients under ``autograd.record()``; ``autograd.capture``;
- ``mx.sym.contrib.foreach`` / ``while_loop`` / ``cond`` bound through the
  Executor: outputs, gradients, free weights as graph arguments, a
  BatchNorm inside a body (its moving statistics carried through the loop
  and written by a training forward), JSON save / load across packages,
  shape inference, and the graph-level sparse ops.

The same numpy inputs go through both packages; f32 within 2e-5 of each
tensor's largest value.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.symbol import symbol as tsym

CPU = mt.cpu()


def _reset():
    jsym._NAME_COUNTER.clear()
    tsym._NAME_COUNTER.clear()


def _close(got, want, tol=2e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) / scale <= tol, what


def _both(run, *args):
    out = []
    for mx in (jmx, mt):
        _reset()
        with mx.cpu():
            out.append(run(mx, *args))
    return out


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    return [x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)]


def _assert_all_close(j, t, tol=2e-5):
    j, t = _flat(j), _flat(t)
    assert len(j) == len(t)
    for i, (a, b) in enumerate(zip(t, j)):
        _close(a, b, tol, f"item {i}")


# ---------------------------------------------------------------------------
# mx.nd.contrib
# ---------------------------------------------------------------------------

def _nd_foreach_cumsum(mx):
    def body(item, state):
        new = state + item
        return new, new
    outs, final = mx.nd.contrib.foreach(
        body, mx.nd.array(np.arange(5).astype(np.float32)),
        mx.nd.zeros((1,)))
    return outs, final


def _nd_foreach_rnn(mx):
    T, N, H = 4, 2, 3
    x = mx.nd.array(np.random.RandomState(0).randn(T, N, H)
                    .astype(np.float32))
    w = mx.nd.array(np.eye(H, dtype=np.float32) * 0.5)

    def body(xt, h):
        new_h = mx.nd.op.tanh(xt + mx.nd.op.dot(h, w))
        return new_h, new_h
    return mx.nd.contrib.foreach(body, x, mx.nd.zeros((N, H)))


def _nd_foreach_multi(mx):
    rs = np.random.RandomState(1)
    a = mx.nd.array(rs.randn(3, 2).astype(np.float32))
    b = mx.nd.array(rs.randn(3, 2).astype(np.float32))

    def body(items, states):
        x, y = items
        s0, s1 = states
        return [x * s0, y + s1], [s0 + x, s1 * 0.5 + y]
    return mx.nd.contrib.foreach(body, [a, b],
                                 [mx.nd.ones((2,)), mx.nd.zeros((2,))])


def _nd_while(mx):
    def func(i, s):
        return s + i, [i + 1, s + i]
    return mx.nd.contrib.while_loop(lambda i, s: i < 5, func,
                                    [mx.nd.array([0.0]), mx.nd.array([0.0])],
                                    max_iterations=10)


def _nd_while_no_step(mx):
    return mx.nd.contrib.while_loop(
        lambda i: i < 0, lambda i: ([i * 2, i + 3], i + 1),
        mx.nd.array([1.0]), max_iterations=3)


def _nd_cond(mx):
    a, b = mx.nd.array([5.0]), mx.nd.array([3.0])
    return [mx.nd.contrib.cond(a > b, lambda: a * 2, lambda: b * 10),
            mx.nd.contrib.cond(a < b, lambda: a * 2, lambda: b * 10),
            mx.nd.contrib.cond(a > b, lambda: [a, b * 2],
                               lambda: [b, a])]


@pytest.mark.parametrize("run", [_nd_foreach_cumsum, _nd_foreach_rnn,
                                 _nd_foreach_multi, _nd_while,
                                 _nd_while_no_step, _nd_cond],
                         ids=lambda f: f.__name__[4:])
def test_nd_control_flow_matches_jax(run):
    j, t = _both(run)
    _assert_all_close(j, t)


def test_nd_foreach_cumsum_and_rnn_values():
    _reset()
    with CPU:
        outs, final = _nd_foreach_cumsum(mt)
        assert outs.shape == (5, 1)
        assert outs.asnumpy().ravel().tolist() == [0, 1, 3, 6, 10]
        outs, (i, s) = _nd_while(mt)
    assert outs.shape == (10, 1) and float(i.asscalar()) == 5
    assert float(s.asscalar()) == 10


def _nd_foreach_grad(mx):
    data = mx.nd.array([1.0, 2.0, 3.0])
    w = mx.nd.array([0.5])
    data.attach_grad()
    w.attach_grad()

    def body(item, state):
        new = state + item * item * w
        return new, new
    with mx.autograd.record():
        outs, final = mx.nd.contrib.foreach(body, data, mx.nd.zeros((1,)))
        loss = final.sum() + (outs * 2).sum()
    loss.backward()
    return data.grad, w.grad


def _nd_while_grad(mx):
    x = mx.nd.array([2.0])
    x.attach_grad()

    def func(i, s):
        return s * 3, [i + 1, s * x]
    with mx.autograd.record():
        outs, (i, s) = mx.nd.contrib.while_loop(
            lambda i, s: i < 3, func, [mx.nd.array([0.0]),
                                       mx.nd.array([1.0])],
            max_iterations=5)
        loss = s.sum() + outs.sum()
    loss.backward()
    return x.grad


def _nd_cond_grad(mx):
    a, b = mx.nd.array([1.5, -2.0]), mx.nd.array([0.5, 4.0])
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        y = mx.nd.contrib.cond(mx.nd.array([1.0]), lambda: a * a * b,
                               lambda: b)
        z = mx.nd.contrib.cond(mx.nd.array([0.0]), lambda: a,
                               lambda: b * 3)
        (y.sum() + z.sum()).backward()
    return a.grad, b.grad


@pytest.mark.parametrize("run", [_nd_foreach_grad, _nd_while_grad,
                                 _nd_cond_grad],
                         ids=lambda f: f.__name__[4:])
def test_nd_control_flow_gradients_match_jax(run):
    """Gradients reach the inputs and the NDArrays the bodies close over
    (x^3's 3x^2 = 12 at x = 2 in the while loop)."""
    j, t = _both(run)
    _assert_all_close(j, t)


def _capture(mx):
    w = mx.nd.array([1.0, 2.0])
    v = mx.nd.array([3.0, 4.0])
    w.attach_grad()
    v.attach_grad()
    free = mx.nd.array([5.0, 6.0])      # no gradient record: not captured
    with mx.autograd.pause():
        with mx.autograd.capture() as cap:
            h = w * 2 + free
            h = h * w + v
            (h * h).sum()
    return [int(np.round(x.asnumpy()[0])) for x in cap.order]


def test_autograd_capture_matches_jax():
    """``capture`` lists the free variables the ops read, in first-use
    order, not the values the captured ops made."""
    j, t = _both(_capture)
    assert t == j == [1, 3]


# ---------------------------------------------------------------------------
# mx.sym.contrib
# ---------------------------------------------------------------------------

def _run(mx, out_sym, args, grads=False, out_grads=None, aux=None):
    arg_nds = {k: mx.nd.array(v) for k, v in args.items()}
    grad_nds = {k: mx.nd.zeros(v.shape) for k, v in args.items()} \
        if grads else None
    aux_nds = {k: mx.nd.array(v) for k, v in (aux or {}).items()} or None
    ex = out_sym.bind(mx.cpu(), args=arg_nds, args_grad=grad_nds,
                      aux_states=aux_nds)
    outs = [o.asnumpy() for o in ex.forward(is_train=bool(grads))]
    if not grads:
        return outs
    ex.backward(out_grads=[mx.nd.array(g) for g in out_grads]
                if out_grads is not None else None)
    return outs, {k: g.asnumpy() for k, g in sorted(ex.grad_dict.items())}


def _sym_cumsum(mx, d):
    def body(x, s):
        new_s = mx.sym.elemwise_add(x, s)
        return new_s, new_s
    outs, final = mx.sym.contrib.foreach(body, mx.sym.Variable("data"),
                                         mx.sym.Variable("init"))
    return _run(mx, mx.sym.Group([outs, final]),
                {"data": d, "init": np.zeros(3, np.float32)})


def _sym_free_weight(mx, d, wv):
    w = mx.sym.Variable("w")

    def body(x, s):
        new_s = mx.sym.elemwise_add(mx.sym.broadcast_mul(x, w), s)
        return new_s, new_s
    outs, final = mx.sym.contrib.foreach(body, mx.sym.Variable("data"),
                                         mx.sym.Variable("init"))
    g = mx.sym.Group([outs, final])
    return g.list_arguments(), _run(
        mx, g, {"data": d, "init": np.zeros(3, np.float32), "w": wv},
        grads=True, out_grads=[np.ones((4, 3), np.float32),
                               np.full(3, 2.0, np.float32)])


def _sym_while(mx):
    def cond_fn(i, acc):
        return mx.sym._internal._lesser_scalar(i, scalar=4.0)

    def func(i, acc):
        new_i = mx.sym._internal._plus_scalar(i, scalar=1.0)
        return new_i, [new_i, mx.sym.elemwise_add(acc, new_i)]
    outs, finals = mx.sym.contrib.while_loop(
        cond_fn, func, [mx.sym.Variable("i"), mx.sym.Variable("acc")],
        max_iterations=8)
    return _run(mx, mx.sym.Group([outs, *finals]),
                {"i": np.zeros((1,), np.float32),
                 "acc": np.zeros((1,), np.float32)})


def _while_power(mx):
    """while i < 3: s <- s x, each step's output s x."""
    xs = mx.sym.Variable("x")

    def func(i, s):
        return mx.sym.elemwise_mul(s, xs), [
            mx.sym._internal._plus_scalar(i, scalar=1.0),
            mx.sym.elemwise_mul(s, xs)]
    outs, finals = mx.sym.contrib.while_loop(
        lambda i, s: mx.sym._internal._lesser_scalar(i, scalar=3.0), func,
        [mx.sym.Variable("i"), mx.sym.Variable("s")], max_iterations=5)
    return mx.sym.Group([outs, finals[1]])


def _while_args(x):
    return {"i": np.zeros((1,), np.float32), "s": np.ones((2,), np.float32),
            "x": x}


def _sym_cond(mx, p):
    out = mx.sym.contrib.cond(mx.sym.Variable("p"),
                              lambda a: mx.sym.square(a),
                              lambda a: mx.sym.negative(a),
                              inputs=[mx.sym.Variable("x")])
    xv = np.array([2.0, -3.0], np.float32)
    return _run(mx, out, {"p": np.array([p], np.float32), "x": xv},
                grads=True, out_grads=[np.array([1.0, 2.0], np.float32)])


def _sym_grad(mx, d):
    def body(x, s):
        new_s = mx.sym.elemwise_add(mx.sym.square(x), s)
        return new_s, new_s
    _, final = mx.sym.contrib.foreach(body, mx.sym.Variable("data"),
                                      mx.sym.Variable("init"))
    return _run(mx, final, {"data": d, "init": np.zeros(3, np.float32)},
                grads=True, out_grads=[np.ones(3, np.float32)])


@pytest.mark.parametrize("case", [
    "cumsum", "free_weight", "while", "cond_true", "cond_false",
    "foreach_grad"])
def test_sym_control_flow_matches_jax(case):
    """Outputs and gradients of the Executor over control-flow nodes."""
    rs = np.random.RandomState(len(case))
    d = rs.randn(4, 3).astype(np.float32)
    runs = {"cumsum": (_sym_cumsum, d),
            "free_weight": (_sym_free_weight, d,
                            rs.randn(3).astype(np.float32)),
            "while": (_sym_while,),
            "cond_true": (_sym_cond, 1.0), "cond_false": (_sym_cond, 0.0),
            "foreach_grad": (_sym_grad, d)}
    run, *args = runs[case]
    j, t = _both(run, *args)
    if case == "free_weight":
        assert t[0] == j[0] and "w" in t[0]
        j, t = j[1], t[1]
    if isinstance(j, tuple):
        assert sorted(t[1]) == sorted(j[1])
        j, t = [j[0], [j[1][k] for k in sorted(j[1])]], \
            [t[0], [t[1][k] for k in sorted(t[1])]]
    _assert_all_close(j, t)
    if case == "foreach_grad":
        np.testing.assert_allclose(t[1][0], 2 * d, rtol=1e-6)
    if case == "while":
        np.testing.assert_array_equal(t[0][:4, 0], [1, 2, 3, 4])
        np.testing.assert_array_equal(t[0][4:, 0], [0, 0, 0, 0])


def test_sym_while_loop_gradient():
    """The port differentiates a symbolic while loop (each step's output
    s x and the final s = x^3 after three steps: 1 + 2x + 6x^2); its
    forward is the JAX executor's, whose lax.while_loop cannot be
    reverse-differentiated."""
    x = np.array([2.0, -1.5], np.float32)
    _reset()
    with CPU:
        outs, grads = _run(mt, _while_power(mt), _while_args(x), grads=True,
                           out_grads=[np.ones((5, 2), np.float32),
                                      np.ones((2,), np.float32)])
    np.testing.assert_allclose(outs[0][:3], [x, x ** 2, x ** 3], rtol=1e-6)
    np.testing.assert_array_equal(outs[0][3:], np.zeros((2, 2)))
    np.testing.assert_allclose(grads["x"], 1 + 2 * x + 6 * x ** 2,
                               rtol=1e-6)
    _reset()
    with jmx.cpu():
        want = _run(jmx, _while_power(jmx), _while_args(x))
        with pytest.raises(Exception, match="Reverse-mode"):
            _run(jmx, _while_power(jmx), _while_args(x), grads=True)
    _assert_all_close(want, outs)


def _bn_body(mx, use_global, momentum=0.5):
    gamma, beta = mx.sym.Variable("gamma"), mx.sym.Variable("beta")

    def body(x, s):
        h = mx.sym.BatchNorm(x, gamma, beta, use_global_stats=use_global,
                             fix_gamma=False, axis=1, momentum=momentum,
                             name="bn")[0]
        return mx.sym.elemwise_add(h, s), s
    outs, _ = mx.sym.contrib.foreach(body, mx.sym.Variable("data"),
                                     mx.sym.Variable("init"))
    return mx.sym.Group([outs])


def _sym_bn_aux(mx, d, use_global):
    T, B, C = d.shape
    g = _bn_body(mx, use_global)
    ex = g.bind(mx.cpu(), args={"data": mx.nd.array(d),
                                "init": mx.nd.zeros((B, C)),
                                "gamma": mx.nd.ones((C,)),
                                "beta": mx.nd.zeros((C,))},
                args_grad={k: mx.nd.zeros(s) for k, s in
                           (("data", d.shape), ("init", (B, C)),
                            ("gamma", (C,)), ("beta", (C,)))},
                aux_states={"bn_moving_mean": mx.nd.zeros((C,)),
                            "bn_moving_var": mx.nd.ones((C,))})
    out = ex.forward(is_train=not use_global)[0].asnumpy()
    if not use_global:
        ex.backward(out_grads=mx.nd.array(np.random.RandomState(7).randn(
            T, B, C).astype(np.float32)))
    return (g.list_auxiliary_states(), out,
            ex.aux_dict["bn_moving_mean"].asnumpy(),
            ex.aux_dict["bn_moving_var"].asnumpy(),
            {k: v.asnumpy() for k, v in sorted(ex.grad_dict.items())})


@pytest.mark.parametrize("use_global", [True, False])
def test_sym_foreach_with_batchnorm_in_the_body(use_global):
    """A BatchNorm inside a foreach body: its moving statistics are aux
    states of the enclosing graph; with global statistics the body is an
    identity up to eps, and in training the statistics are carried
    through the T steps (momentum 0.5) and written by the forward."""
    rs = np.random.RandomState(5)
    d = (rs.randn(3, 8, 2) * 2 + 5).astype(np.float32)
    (ja, jo, jm, jv, jg), (ta, to, tm, tv, tg) = _both(_sym_bn_aux, d,
                                                       use_global)
    assert ta == ja and any("moving_mean" in a for a in ta)
    _close(to, jo, 2e-5, "out")
    if use_global:
        np.testing.assert_allclose(to, d / np.sqrt(1 + 1e-3), rtol=1e-4)
        return
    want_mm, want_mv = np.zeros(2), np.ones(2)
    for t in range(d.shape[0]):
        want_mm = want_mm * 0.5 + d[t].mean(0) * 0.5
        want_mv = want_mv * 0.5 + d[t].var(0) * 0.5
    np.testing.assert_allclose(tm, want_mm, rtol=1e-4)
    np.testing.assert_allclose(tv, want_mv, rtol=1e-4)
    _close(tm, jm)
    _close(tv, jv)
    for k in jg:
        _close(tg[k], jg[k], 2e-5, k)


def test_sym_control_flow_json_loads_across_packages(tmp_path):
    """A foreach graph and a while_loop graph written by either package
    load in the other (bodies embedded as JSON) and run the same."""
    def graphs(mx):
        data, init = mx.sym.Variable("data"), mx.sym.Variable("init")

        def body(x, s):
            new_s = mx.sym.elemwise_add(x, s)
            return new_s, new_s
        outs, final = mx.sym.contrib.foreach(body, data, init)
        wl, (i, acc) = mx.sym.contrib.while_loop(
            lambda i, a: mx.sym._internal._lesser_scalar(i, scalar=3.0),
            lambda i, a: (a, [mx.sym._internal._plus_scalar(i, scalar=1.0),
                              mx.sym.elemwise_add(a, i)]),
            [mx.sym.Variable("i"), mx.sym.Variable("acc")],
            max_iterations=4)
        return mx.sym.Group([outs, final]), mx.sym.Group([wl, acc])

    _reset()
    j = graphs(jmx)
    _reset()
    t = graphs(mt)
    assert [g.tojson() for g in t] == [g.tojson() for g in j]
    rs = np.random.RandomState(6)
    args = ({"data": rs.randn(4, 3).astype(np.float32),
             "init": np.zeros(3, np.float32)},
            {"i": np.zeros(1, np.float32), "acc": np.ones(1, np.float32)})
    for k, (jg, tg) in enumerate(zip(j, t)):
        jg.save(str(tmp_path / f"j{k}.json"))
        tg.save(str(tmp_path / f"t{k}.json"))
        with jmx.cpu():
            want = _run(jmx, jmx.sym.load(str(tmp_path / f"t{k}.json")),
                        args[k])
        with CPU:
            got = _run(mt, mt.sym.load(str(tmp_path / f"j{k}.json")),
                       args[k])
        _assert_all_close(want, got)
    np.testing.assert_allclose(got[0], [[1], [1], [2], [0]])


def test_sym_control_flow_shape_inference():
    """The port infers control-flow nodes' outputs from their bodies
    (stacked over the data's axis, buffered to max_iterations) and fills
    a body's weight from its own hints."""
    _reset()
    with CPU:
        w = mt.sym.Variable("w")
        outs, final = mt.sym.contrib.foreach(
            lambda x, s: (mt.sym.FullyConnected(x, w, num_hidden=5,
                                                no_bias=True), s),
            mt.sym.Variable("data"), mt.sym.Variable("init"))
        args, out, _ = mt.sym.Group([outs, final]).infer_shape(
            data=(7, 2, 3), init=(2, 5))
        assert out == [(7, 2, 5), (2, 5)]
        assert dict(zip(mt.sym.Group([outs, final]).list_arguments(),
                        args))["w"] == (5, 3)
        wl, fin = mt.sym.contrib.while_loop(
            lambda i: mt.sym._internal._lesser_scalar(i, scalar=3.0),
            lambda i: (mt.sym.concat(i, i, dim=0),
                       mt.sym._internal._plus_scalar(i, scalar=1.0)),
            mt.sym.Variable("i"), max_iterations=6)
        _, out, _ = mt.sym.Group([wl, fin]).infer_shape(i=(2,))
        assert out == [(6, 4), (2,)]


def test_sym_square_sum_and_sparse_ops_in_graph():
    def run(mx):
        x, idx = mx.sym.Variable("x"), mx.sym.Variable("idx")
        g = mx.sym.Group([mx.sym.op._square_sum(x, axis=(1,)),
                          mx.sym.op.cast_storage(x, stype="row_sparse"),
                          mx.sym.op.sparse_retain(x, idx)])
        xv = np.random.RandomState(3).randn(4, 3).astype(np.float32)
        return _run(mx, g, {"x": xv, "idx": np.array([0, 2], np.float32)})
    j, t = _both(run)
    _assert_all_close(j, t)


def test_cf_op_imperative_invoke_raises():
    with CPU:
        with pytest.raises(mt.MXNetError, match="control-flow"):
            mt.nd.imperative_invoke("_foreach", (mt.nd.ones((2, 2)),), {})
    with pytest.raises(jmx.base.MXNetError, match="control-flow"):
        jmx.nd.imperative_invoke("_foreach", (jmx.nd.ones((2, 2)),), {})
