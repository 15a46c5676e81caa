"""Row-sparse gradients in the port (``autograd.py`` delivery,
``ops/sparse_ops.py``'s row-sparse Embedding and csr dot gradients,
Gluon's ``Embedding(sparse_grad=True)`` and ``contrib.nn.SparseEmbedding``)
against the JAX package on the same numpy inputs, on the CPU (cases of
``tests/test_sparse_dispatch.py``).

Exact: the stored row ids and storage types; f32 gradient values within
1e-6. No gradient of a row_sparse buffer is ever built at the table's
shape: the ``(100000, 16)`` table's gradient holds only the batch's rows.
The refusals (megastep, ZeRO) raise as the JAX package's do; a
hybridized block gives the dense gradient with the JAX package's warning.
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.ndarray import sparse as tsp

CPU = mt.cpu()
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with CPU:
        yield


def _np(x):
    return np.asarray(x.asnumpy())


def _csr(m, k, density, seed):
    rs = np.random.RandomState(seed)
    d = (rs.randn(m, k) * (rs.rand(m, k) < density)).astype(np.float32)
    return d, jsp.csr_matrix(d), tsp.csr_matrix(d)


def _same_rsp(t, j):
    assert t.stype == j.stype == "row_sparse"
    np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
    np.testing.assert_allclose(_np(t.data), _np(j.data), **TOL)


@pytest.mark.parametrize("vector", [False, True])
def test_dot_csr_backward_is_row_sparse_like_jax(vector):
    d, jc, tc = _csr(8, 30, 0.15, 5)
    W = np.random.RandomState(3).randn(30, *(() if vector else (4,))) \
        .astype(np.float32)
    grads = []
    for pkg, ag, c in ((jmx, jag, jc), (mt, tag, tc)):
        w = pkg.nd.array(W)
        w.attach_grad(stype="row_sparse")
        with ag.record():
            y = pkg.nd.dot(c, w)
            loss = (y * y).sum()
        loss.backward()
        grads.append(w.grad)
    _same_rsp(grads[1], grads[0])


def test_dot_csr_transpose_backward_matches_jax():
    d, jc, tc = _csr(6, 15, 0.25, 12)
    H = np.random.RandomState(7).randn(6, 3).astype(np.float32)
    got = []
    for pkg, ag, c in ((jmx, jag, jc), (mt, tag, tc)):
        h = pkg.nd.array(H)
        h.attach_grad()
        with ag.record():
            y = pkg.nd.dot(c, h, transpose_a=True)
            loss = (y.todense() * y.todense()).sum()
        loss.backward()
        got.append(h.grad.asnumpy())
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5, atol=1e-6)


def _embed_grad(pkg, ag, W, ids, stype, twice=False, dense_too=False):
    w = pkg.nd.array(W)
    w.attach_grad(stype=stype)
    with ag.record():
        e = pkg.nd.Embedding(pkg.nd.array(ids), w, input_dim=W.shape[0],
                             output_dim=W.shape[1], sparse_grad=True)
        loss = (e * e).sum()
        if twice:
            e2 = pkg.nd.Embedding(pkg.nd.array(ids[::-1].copy()), w,
                                  input_dim=W.shape[0],
                                  output_dim=W.shape[1], sparse_grad=True)
            loss = loss + 3.0 * e2.sum()
        if dense_too:
            loss = loss + (w * 2.0).sum()
    loss.backward()
    return w.grad


@pytest.mark.parametrize("twice,dense_too", [(False, False), (True, False),
                                             (False, True)])
def test_embedding_sparse_grad_matches_jax(twice, dense_too):
    W = np.random.RandomState(0).randn(40, 6).astype(np.float32)
    ids = np.array([[5, 9, 5], [17, 9, 0]], np.float32)
    j = _embed_grad(jmx, jag, W, ids, "row_sparse", twice, dense_too)
    t = _embed_grad(mt, tag, W, ids, "row_sparse", twice, dense_too)
    _same_rsp(t, j)
    if dense_too:          # a dense part densifies: every row stored
        assert _np(t.indices).tolist() == list(range(40))
    else:
        assert _np(t.indices).tolist() == [0, 5, 9, 17]
    # a dense buffer takes the densified gradient
    jd = _embed_grad(jmx, jag, W, ids, None, twice, dense_too)
    td = _embed_grad(mt, tag, W, ids, None, twice, dense_too)
    assert td.stype == "default"
    np.testing.assert_allclose(td.asnumpy(), jd.asnumpy(), **TOL)


def test_grad_req_add_accumulates_rows_like_jax():
    W = np.random.RandomState(4).randn(12, 3).astype(np.float32)
    out = []
    for pkg, ag in ((jmx, jag), (mt, tag)):
        w = pkg.nd.array(W)
        w.attach_grad(grad_req="add", stype="row_sparse")
        for ids in ([1.0, 4.0], [4.0, 7.0]):
            with ag.record():
                e = pkg.nd.Embedding(pkg.nd.array(np.array(ids)), w,
                                     input_dim=12, output_dim=3,
                                     sparse_grad=True)
                e.sum().backward()
        out.append(w.grad)
    _same_rsp(out[1], out[0])


def test_autograd_grad_returns_row_sparse_like_jax():
    W = np.random.RandomState(2).randn(10, 2).astype(np.float32)
    res = []
    for pkg, ag in ((jmx, jag), (mt, tag)):
        w = pkg.nd.array(W)
        w.attach_grad(stype="row_sparse")
        with ag.record():
            e = pkg.nd.Embedding(pkg.nd.array(np.array([3.0, 3.0, 8.0])), w,
                                 input_dim=10, output_dim=2,
                                 sparse_grad=True)
            loss = (e * e).sum()
        res.append(ag.grad(loss, [w])[0])
    _same_rsp(res[1], res[0])


def test_large_table_gradient_holds_only_the_batch_rows():
    """The MF recipe's (100000, 16) user table: the gradient stores the
    batch's unique rows and never a dense (vocab, dim) array."""
    rs = np.random.RandomState(0)
    table = tgluon.nn.Embedding(100000, 16, sparse_grad=True, device="cpu")
    table.initialize(mt.init.Normal(0.1))
    ids = rs.randint(0, 100000, 512)
    seen = []

    def spy(grad_buf):
        seen.append(tuple(grad_buf._data.shape))
    with tag.grad_ready_scope(spy):
        with tag.record():
            loss = (table(mt.nd.array(ids)) ** 2).sum()
        loss.backward()
    g = table.weight.grad()
    uniq = np.unique(ids)
    assert g.stype == "row_sparse"
    assert _np(g.indices).tolist() == uniq.tolist()
    assert seen == [(len(uniq), 16)]
    assert table.weight.tensor.grad is None
    np.testing.assert_allclose(
        _np(g.data), 2 * table.weight.data().asnumpy()[uniq] *
        np.bincount(ids, minlength=100000)[uniq][:, None], rtol=1e-6)


# ---------------------------------------------------------------------------
# Gluon
# ---------------------------------------------------------------------------

def _layers(sparse_cls=False):
    jmx.random.seed(1)
    if sparse_cls:
        jb = jgluon.contrib.nn.SparseEmbedding(30, 4)
        tb = tgluon.contrib.nn.SparseEmbedding(30, 4, device="cpu")
    else:
        jb = jgluon.nn.Embedding(30, 4, sparse_grad=True)
        tb = tgluon.nn.Embedding(30, 4, sparse_grad=True, device="cpu")
    jb.initialize()
    w = next(iter(jb.collect_params().values())).data().asnumpy()
    tb.initialize()
    next(iter(tb.collect_params().values())).set_data(w)
    return jb, tb


@pytest.mark.parametrize("sparse_cls", [False, True])
def test_gluon_sparse_embedding_and_trainer_match_jax(sparse_cls):
    jb, tb = _layers(sparse_cls)
    x = np.array([[1.0, 2.0], [2.0, 9.0]], np.float32)
    trainers = [jgluon.Trainer(jb.collect_params(), "sgd",
                               {"learning_rate": 0.5, "momentum": 0.9}),
                tgluon.Trainer(tb.collect_params(), "sgd",
                               {"learning_rate": 0.5, "momentum": 0.9})]
    before = tb.weight.data().asnumpy().copy()
    for step in range(3):
        for (pkg, ag, b), tr in zip(((jmx, jag, jb), (mt, tag, tb)),
                                    trainers):
            with ag.record():
                out = b(pkg.nd.array(x + step))
                (out * out).sum().backward()
            tr.step(1)
        _same_rsp(tb.weight.grad(), jb.weight.grad())
    np.testing.assert_allclose(tb.weight.data().asnumpy(),
                               jb.weight.data().asnumpy(), rtol=2e-5,
                               atol=2e-5)
    touched = {1, 2, 3, 4, 9, 10, 11}
    after = tb.weight.data().asnumpy()
    untouched = [i for i in range(30) if i not in touched]
    np.testing.assert_array_equal(after[untouched], before[untouched])
    if sparse_cls:
        assert trainers[1]._contains_sparse and \
            trainers[0]._contains_sparse


def _hybrid_step(pkg, ag, block, x):
    """One recorded forward and backward of a hybridized block; the
    warnings it gave."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with ag.record():
            out = block(pkg.nd.array(x))
            (out * out).sum().backward()
    return [str(w.message) for w in caught]


def test_hybridize_with_row_sparse_grad_is_refused():
    """A hybridized block refuses to keep row_sparse gradients compact, as
    the JAX package's does (``tests/test_sparse_dispatch.py``): its
    whole-graph backward gives the dense gradient, with a warning, and
    the row_sparse buffer takes it whole, every row kept."""
    jb, tb = _layers()
    x = np.array([4.0, 4.0, 7.0], np.float32)
    for pkg, ag, b in ((jmx, jag, jb), (mt, tag, tb)):
        b.hybridize()
        msgs = _hybrid_step(pkg, ag, b, x)
        assert any("row_sparse" in m and "dense" in m for m in msgs)
    _same_rsp(tb.weight.grad(), jb.weight.grad())
    assert _np(tb.weight.grad().indices).tolist() == list(range(30))


@pytest.mark.parametrize("sparse_cls", [False, True])
def test_hybridized_sparse_embedding_trains_like_jax(sparse_cls):
    """Three SGD-momentum steps of the hybridized layer in both packages:
    ``Embedding``'s dense gradient, delivered into the row_sparse buffer,
    steps every row (a row that was not looked up moves by its wd);
    ``SparseEmbedding`` is a plain Block, so ``hybridize`` leaves its
    gradient compact."""
    jb, tb = _layers(sparse_cls)
    x = np.array([[1.0, 2.0], [2.0, 9.0]], np.float32)
    kw = {"learning_rate": 0.5, "momentum": 0.9, "wd": 0.01}
    for (pkg, ag, b) in ((jmx, jag, jb), (mt, tag, tb)):
        b.hybridize()
        tr = pkg.gluon.Trainer(b.collect_params(), "sgd", dict(kw))
        for step in range(3):
            _hybrid_step(pkg, ag, b, x + step)
            tr.step(1)
    _same_rsp(tb.weight.grad(), jb.weight.grad())
    np.testing.assert_allclose(tb.weight.data().asnumpy(),
                               jb.weight.data().asnumpy(), rtol=2e-5,
                               atol=2e-5)


def test_zero_refuses_sparse_parameters_like_jax(monkeypatch):
    from mxnet_tpu.base import MXNetError as JMXNetError
    monkeypatch.setenv("MXTPU_ZERO", "1")
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    errs = []
    for pkg, g, err in ((jmx, jgluon, JMXNetError),
                        (mt, tgluon, mt.MXNetError)):
        kw = {} if pkg is jmx else {"device": "cpu"}
        emb = g.contrib.nn.SparseEmbedding(8, 2, **kw)
        emb.initialize()
        tr = g.Trainer(emb.collect_params(), "sgd",
                       kvstore=pkg.kv.create("local"))
        with pytest.raises(err) as e:
            tr._zero_plane()
        errs.append(str(e.value))
    assert "requires dense parameters" in errs[1]
    # the same message, less the parameters' names (numbered per process)
    assert errs[1].split("is sparse.")[1] == errs[0].split("is sparse.")[1]


def test_grouped_path_bypasses_row_sparse_params_like_jax(monkeypatch):
    """Aggregation on: the dense neighbours ride a bucket, the row-sparse
    parameter takes the per-parameter lazy update
    (``tests/test_optimizer_aggregation.py``'s sparse bypass)."""
    from mxnet_tpu_torch.optimizer import grouped as tgrouped
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    emb = tgluon.Parameter("emb", shape=(10, 3), grad_stype="row_sparse")
    dense = [tgluon.Parameter(f"d{i}", shape=(3,)) for i in range(2)]
    for p in [emb] + dense:
        p.initialize(ctx=CPU)
    tr = tgluon.Trainer([emb] + dense, "sgd", {"learning_rate": 0.1})
    g = emb.grad()
    g._update(torch.ones(2, 3), torch.tensor([2, 5]))
    for p in [emb] + dense:
        p._fresh_grad = True
    tr.step(1)
    assert tr.last_update_dispatches == 2      # one bucket + one lazy
    assert not tgrouped.eligible(tr._updaters[0], [(0, emb)])
    with pytest.raises(mt.MXNetError, match="MXTPU_SPARSE_PLANE"):
        tgrouped.prepare_update(tr._updaters[0], [(0, emb)])
