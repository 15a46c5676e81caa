"""Lazy row-sparse optimizer updates in the port (``ops/sparse_ops.py``'s
``_sparse_sgd_update`` / ``_sparse_sgd_mom_update`` /
``_sparse_adam_update``, SGD's and Adam's ``lazy_update``) and the
matrix-factorisation recipe's training slice, against the JAX package on
the same numpy inputs, on the CPU.

Rows outside the gradient keep their bits in weight and state. The ops
within 1e-6; weights and state after 3 lazy steps within 2e-5 (the
repo's f32 rule); ``lazy_update=False`` densifies first, as in the JAX
package. The MF slice (``examples/recommenders/matrix_fact_sparse.py``'s
net at 200 users x 100 items, from the JAX net's weights) ends within
2e-5 after 3 Trainer steps of lazy Adam.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ndarray import sparse as tsp
from mxnet_tpu_torch.ops import registry as treg

CPU = mt.cpu()
OP_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with CPU:
        yield


def _rsp(pkg_sp, shape, rows, seed):
    data = np.random.RandomState(seed).randn(len(rows),
                                             *shape[1:]).astype(np.float32)
    return pkg_sp.row_sparse_array((data, rows), shape=shape)


@pytest.mark.parametrize("name,n_state,kw", [
    ("_sparse_sgd_update", 0, dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                                   clip_gradient=0.4)),
    ("_sparse_sgd_mom_update", 1, dict(lr=0.1, momentum=0.9, wd=0.01)),
    ("_sparse_adam_update", 2, dict(lr=0.01, beta1=0.9, beta2=0.999,
                                    epsilon=1e-8, wd=0.02,
                                    clip_gradient=1.0)),
])
def test_sparse_update_ops_match_jax(name, n_state, kw):
    rs = np.random.RandomState(0)
    w = rs.randn(20, 4).astype(np.float32)
    states = [np.abs(rs.randn(20, 4)).astype(np.float32)
              for _ in range(n_state)]
    rows = np.array([2, 7, 11, 19])
    gdata = rs.randn(4, 4).astype(np.float32)
    import jax.numpy as jnp
    want = jreg.get_op(name).fn(jnp.asarray(w), jnp.asarray(gdata),
                                jnp.asarray(rows.astype(np.int32)),
                                *(jnp.asarray(x) for x in states), **kw)
    got = treg.get_op(name).fn(torch.from_numpy(w), torch.from_numpy(gdata),
                               torch.from_numpy(rows),
                               *(torch.from_numpy(s) for s in states), **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    untouched = [i for i in range(20) if i not in rows]
    for g, j, src in zip(got, want, [w] + states):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **OP_TOL)
        np.testing.assert_array_equal(g.numpy()[untouched], src[untouched])


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.01, wd=0.01)),
    ("adam", dict(learning_rate=0.01, lazy_update=False)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, lazy_update=False)),
])
def test_lazy_updates_three_steps_match_jax(name, kw):
    W = np.random.RandomState(1).randn(25, 4).astype(np.float32)
    jw, tw = jmx.nd.array(W), mt.nd.array(W)
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for step, rows in enumerate(([3, 11, 19], [11, 4], [0, 3, 24])):
        before = tw.asnumpy().copy()
        jo.update(0, jw, _rsp(jsp, (25, 4), rows, step), js)
        to.update(0, tw, _rsp(tsp, (25, 4), rows, step), ts)
        if kw.get("lazy_update", True):
            untouched = [i for i in range(25) if i not in rows]
            np.testing.assert_array_equal(tw.asnumpy()[untouched],
                                          before[untouched])
    np.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), **STEP_TOL)
    for a, b in zip(*(s if isinstance(s, tuple) else (s,) if s is not None
                      else () for s in (ts, js))):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **STEP_TOL)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, wd=0.01, clip_gradient=0.5)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.01, wd=0.02, clip_gradient=1.0)),
])
def test_lazy_step_is_the_dense_step_on_the_rows(name, kw):
    """One lazy row step in the port: ``Optimizer.update``'s lazy branch,
    the registry's ``_sparse_*_update`` op and the embedding plane's
    ``sparse_rows_update`` give, on the gradient's rows, the bits of the
    dense update of a table that holds only those rows."""
    from mxnet_tpu_torch.optimizer import grouped
    from mxnet_tpu_torch.optimizer.optimizer import adam_lr
    rs = np.random.RandomState(4)
    W = rs.randn(25, 4).astype(np.float32)
    rows = np.array([3, 11, 19])
    gdata = rs.randn(3, 4).astype(np.float32)

    def run(weight, grad):
        o = topt.create(name, **kw)
        st = o.create_state(0, weight)
        o.update(0, weight, grad, st)
        st = () if st is None else st if isinstance(st, tuple) else (st,)
        return [weight.tensor] + [x.tensor for x in st]

    dense = run(mt.nd.array(W[rows]), mt.nd.array(gdata))
    lazy = run(mt.nd.array(W), tsp.row_sparse_array((gdata, rows),
                                                   shape=(25, 4)))
    for d, z in zip(dense, lazy):
        assert torch.equal(z[torch.from_numpy(rows)], d)
    o = topt.create(name, **kw)
    lr = kw["learning_rate"]
    if name == "adam":
        lr = adam_lr(lr, o.beta1, o.beta2, 1)
        op = treg.get_op("_sparse_adam_update").fn(
            torch.from_numpy(W), torch.from_numpy(gdata),
            torch.from_numpy(rows), torch.zeros(25, 4), torch.zeros(25, 4),
            lr=lr, wd=kw["wd"], clip_gradient=kw["clip_gradient"])
    elif "momentum" in kw:
        op = treg.get_op("_sparse_sgd_mom_update").fn(
            torch.from_numpy(W), torch.from_numpy(gdata),
            torch.from_numpy(rows), torch.zeros(25, 4), lr=lr,
            momentum=kw["momentum"], wd=kw["wd"])
    else:
        op = (treg.get_op("_sparse_sgd_update").fn(
            torch.from_numpy(W), torch.from_numpy(gdata),
            torch.from_numpy(rows), lr=lr, wd=kw["wd"],
            clip_gradient=kw["clip_gradient"]),)
    states = [torch.zeros(25, 4) for _ in dense[1:]]
    plane_w, plane_s = grouped.sparse_rows_update(
        o, torch.from_numpy(W.copy()), states, torch.from_numpy(gdata),
        rows, np.ones(3, bool), lr, kw["wd"])
    for got in (op, (plane_w,) + tuple(plane_s)):
        for d, z in zip(dense, got):
            assert torch.equal(z[torch.from_numpy(rows)], d)


def test_other_optimizers_densify_row_sparse_gradients():
    """An optimizer without a lazy update steps the densified gradient
    (the reference's storage fallback), with the fallback warning."""
    W = np.random.RandomState(2).randn(6, 3).astype(np.float32)
    g = _rsp(tsp, (6, 3), [1, 4], 3)
    a, b = mt.nd.array(W), mt.nd.array(W)
    oa, ob = topt.create("adagrad", learning_rate=0.1), \
        topt.create("adagrad", learning_rate=0.1)
    sa, sb = oa.create_state(0, a), ob.create_state(0, b)
    with pytest.warns(UserWarning, match="falling back to dense"):
        oa.update(0, a, g, sa)
    ob.update(0, b, g.todense(), sb)
    assert torch.equal(a.tensor, b.tensor)


def test_lazy_adam_logistic_regression_learns_like_jax():
    """Sparse logistic regression (csr batches, a row_sparse weight
    gradient, lazy Adam), the JAX test's data: both packages reach the
    same accuracy and close weights. The weights start small and random:
    at a logit of exactly 0 the two packages' ``relu`` gradients differ
    (JAX splits a tie of ``maximum``), which no sparse kernel is about."""
    rs = np.random.RandomState(0)
    n, d, nnz, bs = 256, 200, 12, 64
    w_true = rs.randn(d).astype(np.float32)
    cols = np.stack([rs.choice(d, nnz, replace=False) for _ in range(n)])
    vals = rs.randn(n, nnz).astype(np.float32)
    y = ((w_true[cols] * vals).sum(1) > 0).astype(np.float32)
    w0 = rs.randn(d, 1).astype(np.float32) * 0.01
    res = []
    for pkg, ag, sp in ((jmx, jag, jsp), (mt, tag, tsp)):
        w = pkg.nd.array(w0)
        adam = pkg.optimizer.create("adam", learning_rate=0.05)
        state = adam.create_state(0, w)
        correct = 0
        for epoch in range(3):
            for b0 in range(0, n, bs):
                sl = slice(b0, b0 + bs)
                X = sp.csr_matrix((vals[sl].reshape(-1),
                                   cols[sl].reshape(-1),
                                   np.arange(bs + 1) * nnz), shape=(bs, d))
                w.attach_grad(stype="row_sparse")
                with ag.record():
                    logits = sp.dot(X, w).reshape((-1,))
                    yn = pkg.nd.array(y[sl])
                    loss = (pkg.nd.relu(logits) - logits * yn +
                            pkg.nd.Activation(-pkg.nd.abs(logits),
                                              act_type="softrelu")).mean()
                loss.backward()
                adam.update(0, w, w.grad, state)
                if epoch == 2:
                    correct += int(((logits.asnumpy() > 0) == y[sl]).sum())
        res.append((correct, w.asnumpy()))
    assert res[1][0] == res[0][0] and res[1][0] / n > 0.85
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the MF recipe's training slice
# ---------------------------------------------------------------------------

def _mf(nn, users, items, dim, **kw):
    class MFNet(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.user_emb = nn.Embedding(users, dim, sparse_grad=True, **kw)
            self.item_emb = nn.Embedding(items, dim, sparse_grad=True, **kw)
            self.user_b = nn.Embedding(users, 1, sparse_grad=True, **kw)
            self.item_b = nn.Embedding(items, 1, sparse_grad=True, **kw)

        def hybrid_forward(self, F, user, item):
            p = F.sum(self.user_emb(user) * self.item_emb(item), axis=-1)
            return p + self.user_b(user).reshape((-1,)) + \
                self.item_b(item).reshape((-1,))
    return MFNet()


def test_matrix_fact_sparse_slice_matches_jax():
    users, items, dim, batch = 200, 100, 8, 64
    jmx.random.seed(0)
    jnet = _mf(jgluon.nn, users, items, dim)
    jnet.initialize(jmx.init.Normal(0.1))
    tnet = _mf(tgluon.nn, users, items, dim, device="cpu")
    tnet.initialize()
    # the children number their own prefixes: match by structural names
    jparams = jnet._collect_params_with_prefix()
    tparams = tnet._collect_params_with_prefix()
    assert sorted(jparams) == sorted(tparams)
    for k, p in tparams.items():
        p.set_data(jparams[k].data().asnumpy())
    opts = {"learning_rate": 0.02, "lazy_update": True}
    trs = [jgluon.Trainer(jnet.collect_params(), "adam", dict(opts)),
           tgluon.Trainer(tnet.collect_params(), "adam", dict(opts))]
    rs = np.random.RandomState(0)
    for it in range(3):
        u = rs.randint(0, users, batch).astype(np.float32)
        i = rs.randint(0, items, batch).astype(np.float32)
        r = rs.randn(batch).astype(np.float32)
        losses = []
        for (pkg, ag, g, net), tr in zip(
                ((jmx, jag, jgluon, jnet), (mt, tag, tgluon, tnet)), trs):
            with ag.record():
                loss = g.loss.L2Loss()(net(pkg.nd.array(u),
                                           pkg.nd.array(i)),
                                       pkg.nd.array(r))
            loss.backward()
            tr.step(batch)
            losses.append(loss.asnumpy())
        np.testing.assert_allclose(losses[1], losses[0], **STEP_TOL)
        g = tnet.user_emb.weight.grad()
        assert g.stype == "row_sparse"
        assert _np_idx(g) == np.unique(u.astype(int)).tolist()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jparams[k].data().asnumpy(), **STEP_TOL)
    # Adam's moments too, parameter by parameter
    jidx = {p.name: i for i, p in enumerate(trs[0]._params)}
    tidx = {p.name: i for i, p in enumerate(trs[1]._params)}
    for k in tparams:
        js = trs[0]._updaters[0].states[jidx[jparams[k].name]]
        ts = trs[1]._updaters[0].states[tidx[tparams[k].name]]
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **STEP_TOL)


def _np_idx(g):
    return np.asarray(g.indices.asnumpy()).tolist()


@pytest.mark.parametrize("cls", ["L2Loss", "L1Loss"])
def test_loss_of_1d_predictions_is_per_sample_like_jax(cls):
    """The MF recipe's predictions are ``(batch,)``: the loss is one value
    a sample, as in the JAX package (a scalar mean would scale every
    gradient by 1 / batch once more)."""
    rs = np.random.RandomState(3)
    pred, label = rs.randn(6).astype(np.float32), rs.randn(6).astype(
        np.float32)
    want = getattr(jgluon.loss, cls)()(jmx.nd.array(pred),
                                       jmx.nd.array(label)).asnumpy()
    got = getattr(tgluon.loss, cls)()(mt.nd.array(pred),
                                      mt.nd.array(label)).asnumpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
