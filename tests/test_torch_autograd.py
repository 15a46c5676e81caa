"""The port's ``autograd`` (over torch autograd) against the JAX package's
tape on the CPU: grad_req write/add/null, pause, recording only inside
``record()``, head gradients, retain_graph, ``grad`` (with create_graph),
``autograd.Function``, and the imperative MLP of ``chip_smoke.py``'s
``imperative_reference`` phase (batch 64, 256 -> 256 -> 10, f32): loss
and every gradient. Same numpy inputs into both; f32 tolerances 1e-5
relative (the MLP's gradients 1e-4: longer sums in another order)."""
import numpy as np
import pytest

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.base import MXNetError as JaxMXNetError

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError

RS = np.random.RandomState(0)
X = RS.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
Y = RS.uniform(0.5, 1.5, (3, 4)).astype(np.float32)

PKGS = {"jax": (jnd, jag), "port": (tnd, tag)}


@pytest.fixture(autouse=True)
def _host():
    with mt.cpu():
        yield


def _both(fn):
    """fn(nd, autograd) run in each package; numpy results."""
    out = {}
    for k, (nd, ag) in PKGS.items():
        res = fn(nd, ag)
        out[k] = [np.asarray(r.asnumpy() if hasattr(r, "asnumpy") else r)
                  for r in (res if isinstance(res, (list, tuple))
                            else [res])]
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    return out["port"]


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_over_two_backward_passes(req):
    def run(nd, ag):
        x = nd.array(X)
        x.attach_grad(grad_req=req)
        for k in (1.0, 2.0):
            with ag.record():
                y = (x * x * k).sum()
            y.backward()
        return x.grad
    (g,) = _both(run)
    want = {"write": 4 * X, "add": 6 * X, "null": np.zeros_like(X)}[req]
    np.testing.assert_allclose(g, want, rtol=1e-6)


def test_pause_and_recording_state():
    def run(nd, ag):
        x = nd.array(X)
        x.attach_grad()
        assert not ag.is_recording() and not ag.is_training()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            a = x * 3.0
            with ag.pause():
                assert not ag.is_recording()
                b = nd.exp(x)          # a constant for the gradient
            with ag.predict_mode():
                assert not ag.is_training()
            y = (a * b).sum()
        with ag.train_mode():
            assert ag.is_training()
        y.backward()
        return x.grad
    (g,) = _both(run)
    np.testing.assert_allclose(g, 3 * np.exp(X), rtol=1e-5)


def test_mode_scopes_match_jax():
    """(is_recording, is_training) through record(train_mode=...),
    pause(train_mode=...), train_mode(), predict_mode() and set_training,
    nested, as the JAX package reports them: BatchNorm's only source of
    its mode."""
    def trace(ag):
        seen = [(ag.is_recording(), ag.is_training())]
        with ag.record(train_mode=False):
            seen.append((ag.is_recording(), ag.is_training()))
            with ag.train_mode():
                seen.append((ag.is_recording(), ag.is_training()))
                with ag.pause(train_mode=True):
                    seen.append((ag.is_recording(), ag.is_training()))
                seen.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                seen.append((ag.is_recording(), ag.is_training()))
        seen.append(ag.set_training(True))
        seen.append(ag.set_training(False))
        seen.append((ag.is_recording(), ag.is_training()))
        return seen
    assert trace(tag) == trace(jag)


def test_ops_outside_record_are_not_recorded():
    for nd, ag, err in ((jnd, jag, JaxMXNetError), (tnd, tag, MXNetError)):
        x = nd.array(X)
        x.attach_grad()
        y = (x * 2.0).sum()
        with pytest.raises(err, match="recorded graph"):
            y.backward()
    x = tnd.array(X)
    x.attach_grad()
    assert not (x * 2.0).tensor.requires_grad


def test_head_gradients_and_multiple_heads():
    h = RS.randn(3, 4).astype(np.float32)

    def run(nd, ag):
        x = nd.array(X)
        x.attach_grad()
        with ag.record():
            a = nd.sin(x)
            b = x * x
        ag.backward([a, b], [nd.array(h), None])
        g1 = x.grad.copy()
        with ag.record():
            c = nd.tanh(x)
        c.backward(nd.array(h))
        return g1, x.grad
    g1, g2 = _both(run)
    np.testing.assert_allclose(g1, h * np.cos(X) + 2 * X, rtol=1e-5)
    np.testing.assert_allclose(g2, h * (1 - np.tanh(X) ** 2), rtol=1e-5)


def test_retain_graph():
    for nd, ag, err in ((jnd, jag, JaxMXNetError), (tnd, tag, MXNetError)):
        x = nd.array(X)
        x.attach_grad(grad_req="add")
        with ag.record():
            y = nd.exp(x).sum()
        y.backward(retain_graph=True)
        y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), 2 * np.exp(X),
                                   rtol=1e-5)
        with pytest.raises(err, match="freed"):
            y.backward()


def test_grad_returns_new_arrays():
    def run(nd, ag):
        x, w = nd.array(X), nd.array(Y)
        x.attach_grad()
        w.attach_grad()
        with ag.record():
            y = (x * w + nd.log(w)).sum()
        gx, gw = ag.grad(y, [x, w])
        return gx, gw
    gx, gw = _both(run)
    np.testing.assert_allclose(gx, Y, rtol=1e-6)
    np.testing.assert_allclose(gw, X + 1 / Y, rtol=1e-5)
    x = tnd.array(X)
    x.attach_grad()
    with tag.record():
        y = (x * x).sum()
    tag.grad(y, x)
    np.testing.assert_array_equal(x.grad.asnumpy(), 0)  # buffer untouched


def test_grad_create_graph_second_order():
    """First order against the JAX package; second order (which the JAX
    package's tape refuses) against the analytic d2/dx2 of x^3 + sin x."""
    def first(nd, ag):
        x = nd.array(X)
        x.attach_grad()
        with ag.record():
            y = (x * x * x + nd.sin(x)).sum()
        return ag.grad(y, [x])[0]
    _both(first)
    x = tnd.array(X)
    x.attach_grad()
    with tag.record():
        y = (x * x * x + tnd.sin(x)).sum()
        (dx,) = tag.grad(y, [x], create_graph=True)
        z = dx.sum()
    np.testing.assert_allclose(dx.asnumpy(), 3 * X * X + np.cos(X),
                               rtol=1e-5)
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 6 * X - np.sin(X),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(JaxMXNetError, match="create_graph"):
        xj = jnd.array(X)
        xj.attach_grad()
        with jag.record():
            yj = (xj * xj).sum()
        jag.grad(yj, [xj], create_graph=True)


def _sigmoid_function(ag):
    class Sigmoid(ag.Function):
        """The reference's autograd.Function example."""

        def forward(self, x):
            y = 1 / (1 + (-x).exp())
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)
    return Sigmoid


def test_autograd_function():
    h = RS.randn(3, 4).astype(np.float32)

    def run(nd, ag):
        x = nd.array(X)
        x.attach_grad()
        with ag.record():
            y = _sigmoid_function(ag)()(x * 2.0)
            z = y * nd.array(h)
        z.backward()
        return y, x.grad
    y, g = _both(run)
    s = 1 / (1 + np.exp(-2 * X))
    np.testing.assert_allclose(y, s, rtol=1e-6)
    np.testing.assert_allclose(g, 2 * h * s * (1 - s), rtol=1e-5)
    out = _sigmoid_function(tag)()(tnd.array(X))   # outside record: forward
    np.testing.assert_allclose(out.asnumpy(), 1 / (1 + np.exp(-X)),
                               rtol=1e-6)


def test_write_into_a_saved_array_fails_loudly():
    """An in-place write after recording bumps torch's version counter:
    the backward that needs the old values raises instead of using the new
    ones."""
    x = tnd.array(X)
    x.attach_grad()
    with tag.record():
        y = (x * x).sum()
    x += 1.0
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        y.backward()


def test_attach_grad_rejects_integer_arrays():
    with pytest.raises(MXNetError, match="floating"):
        tnd.array(np.arange(3)).attach_grad()
    with pytest.raises(MXNetError, match="grad_req"):
        tnd.array(X).attach_grad(grad_req="overwrite")


# ---------------------------------------------------------------------------
# the imperative MLP of chip_smoke.py's imperative_reference phase
# ---------------------------------------------------------------------------

BATCH, D_IN, D_HID, D_OUT = 64, 256, 256, 10


def mlp_arrays(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "x": rs.randn(BATCH, D_IN).astype(np.float32),
        "label": rs.randint(0, D_OUT, BATCH).astype(np.float32),
        "W1": (rs.randn(D_HID, D_IN) / np.sqrt(D_IN)).astype(np.float32),
        "b1": (rs.randn(D_HID) * 0.1).astype(np.float32),
        "W2": (rs.randn(D_OUT, D_HID) / np.sqrt(D_HID)).astype(np.float32),
        "b2": (rs.randn(D_OUT) * 0.1).astype(np.float32),
    }


def mlp_loss(nd, x, label, p):
    """Mean cross-entropy of a two-layer ReLU MLP, written with mx.nd only
    (the log-softmax from max, exp, sum, log and pick)."""
    h = nd.relu(nd.broadcast_add(nd.dot(x, p["W1"], transpose_b=True),
                                 p["b1"]))
    z = nd.broadcast_add(nd.dot(h, p["W2"], transpose_b=True), p["b2"])
    s = nd.broadcast_sub(z, nd.max(z, axis=1, keepdims=True))
    logp = nd.broadcast_sub(s, nd.log(nd.sum(nd.exp(s), axis=1,
                                             keepdims=True)))
    return -nd.mean(nd.pick(logp, label, axis=1))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_imperative_mlp_matches_numpy_step(pkg):
    """Both packages' loss and gradients against a float64 numpy
    reference of the same step."""
    nd, ag = PKGS[pkg]
    a = mlp_arrays()
    params = {k: nd.array(a[k]) for k in ("W1", "b1", "W2", "b2")}
    for v in params.values():
        v.attach_grad()
    with ag.record():
        loss = mlp_loss(nd, nd.array(a["x"]), nd.array(a["label"]), params)
    loss.backward()
    x, lab = a["x"].astype(np.float64), a["label"].astype(int)
    w1, b1, w2, b2 = (a[k].astype(np.float64) for k in ("W1", "b1", "W2",
                                                        "b2"))
    pre = x @ w1.T + b1
    h = np.maximum(pre, 0)
    z = h @ w2.T + b2
    e = np.exp(z - z.max(1, keepdims=True))
    p = e / e.sum(1, keepdims=True)
    want_loss = -np.log(p[np.arange(BATCH), lab]).mean()
    dz = p.copy()
    dz[np.arange(BATCH), lab] -= 1
    dz /= BATCH
    dh = (dz @ w2) * (pre > 0)
    want = {"W2": dz.T @ h, "b2": dz.sum(0), "W1": dh.T @ x,
            "b1": dh.sum(0)}
    np.testing.assert_allclose(float(loss.asscalar()), want_loss, rtol=1e-5)
    for k, w in want.items():
        np.testing.assert_allclose(params[k].grad.asnumpy(), w, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_imperative_mlp_port_matches_jax():
    a = mlp_arrays(1)

    def run(nd, ag):
        params = {k: nd.array(a[k]) for k in ("W1", "b1", "W2", "b2")}
        for v in params.values():
            v.attach_grad()
        with ag.record():
            loss = mlp_loss(nd, nd.array(a["x"]), nd.array(a["label"]),
                            params)
        loss.backward()
        return [loss] + [params[k].grad for k in ("W1", "b1", "W2", "b2")]

    out = {k: [r.asnumpy() for r in run(*v)] for k, v in PKGS.items()}
    for i, (g, w) in enumerate(zip(out["port"], out["jax"])):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"output {i}")
