"""The port's sparse containers and storage kernels
(``mxnet_tpu_torch/ndarray/sparse.py``, ``ops/sparse_ops.py``, the
registry's storage dispatch) against the JAX package's on the same numpy
inputs, on the CPU (cases of ``tests/test_sparse_dispatch.py``,
``tests/test_ndarray.py`` and ``tests/test_kvstore.py``).

Exact: indices, indptr, nnz, storage types and everything that only
moves values (casts, retain, pack / unpack, save / load). f32 values that
are sums within 1e-6 (``TOL``). Files written by one package load in the
other.
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu.ndarray import utils as jutils

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ndarray import sparse as tsp
from mxnet_tpu_torch.ops import registry as treg

CPU = mt.cpu()
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with CPU:
        yield


def _dense(m, k, density, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, k) * (rs.rand(m, k) < density)).astype(np.float32)


def _both_csr(dense):
    return jsp.csr_matrix(dense), tsp.csr_matrix(dense)


def _np(x):
    return np.asarray(x.asnumpy())


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

def test_csr_and_row_sparse_containers_match_jax():
    d = _dense(6, 9, 0.3, 0)
    jc, tc = _both_csr(d)
    assert tc.stype == jc.stype == "csr" and tc.shape == jc.shape
    for part in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(_np(getattr(tc, part)),
                                      _np(getattr(jc, part)))
    assert tc.indices.dtype == np.int32 and tc.indptr.dtype == np.int32
    np.testing.assert_array_equal(_np(tc.todense()), d)
    r = np.zeros((7, 3), np.float32)
    r[[1, 4]] = np.random.RandomState(1).randn(2, 3)
    jr, tr = jsp.row_sparse_array(r), tsp.row_sparse_array(r)
    assert tr.stype == jr.stype == "row_sparse"
    np.testing.assert_array_equal(_np(tr.indices), _np(jr.indices))
    np.testing.assert_array_equal(_np(tr.data), _np(jr.data))
    np.testing.assert_array_equal(tr.asnumpy(), r)
    # from parts, and the empty constructors
    tr2 = tsp.row_sparse_array((r[[1, 4]], [1, 4]), shape=(7, 3))
    np.testing.assert_array_equal(tr2.asnumpy(), r)
    z = tsp.zeros("row_sparse", (5, 2))
    assert z.data.shape == (0, 2) and z.asnumpy().sum() == 0
    zc = tsp.zeros("csr", (3, 4))
    assert _np(zc.indptr).tolist() == [0, 0, 0, 0]
    assert isinstance(tsp.zeros("default", (2,)), mt.nd.NDArray)
    assert tsp.array(tr) is tr


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
def test_cast_storage_both_ways_matches_jax(stype):
    d = _dense(5, 8, 0.4, 2)
    j = jmx.nd.cast_storage(jmx.nd.array(d), stype=stype)
    t = mt.nd.cast_storage(mt.nd.array(d), stype=stype)
    assert t.stype == j.stype == stype
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    if stype != "default":
        np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
        back = t.tostype("default")
        assert back.stype == "default"
        np.testing.assert_array_equal(back.asnumpy(), d)
    # the dense graph-level op is the identity in both packages
    np.testing.assert_array_equal(
        treg.get_op("cast_storage").fn(torch.from_numpy(d)).numpy(), d)


def test_sparse_retain_matches_jax():
    d = np.zeros((10, 3), np.float32)
    d[[2, 5, 8]] = np.random.RandomState(3).randn(3, 3)
    keep = np.array([8, 2, 7])            # 7 is not stored: zero rows
    j = jsp.sparse_retain(jsp.row_sparse_array(d), jmx.nd.array(keep))
    t = mt.nd.sparse_retain(tsp.row_sparse_array(d), mt.nd.array(keep))
    np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
    np.testing.assert_array_equal(_np(t.data), _np(j.data))
    # through the registry name, and the dense op of the same name
    t2 = mt.nd._internal._sparse_retain(tsp.row_sparse_array(d),
                                        mt.nd.array(keep))
    np.testing.assert_array_equal(t2.asnumpy(), t.asnumpy())
    dense_t = treg.get_op("sparse_retain").fn(torch.from_numpy(d),
                                              torch.tensor([2, 8]))
    from mxnet_tpu.ops import registry as jreg
    dense_j = jreg.get_op("sparse_retain").fn(d, np.array([2, 8]))
    np.testing.assert_array_equal(dense_t.numpy(), np.asarray(dense_j))
    with pytest.raises(mt.MXNetError, match="operates on sparse"):
        mt.nd._internal._sparse_retain(mt.nd.array(d), mt.nd.array(keep))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_getnnz_matches_jax(axis):
    d = _dense(7, 5, 0.35, 4)
    jc, tc = _both_csr(d)
    want = jsp.getnnz(jc, axis=axis).asnumpy()
    got = mt.nd.contrib.getnnz(tc, axis=axis).asnumpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        mt.nd._internal._contrib_getnnz(tc, axis=axis).asnumpy(), want)


# ---------------------------------------------------------------------------
# the storage kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,density",
                         [(4, 7, 3, 0.3), (16, 33, 8, 0.1), (8, 12, 1, 0.5),
                          (5, 9, 4, 0.0), (1, 64, 16, 0.9),
                          (256, 1000, 1, 0.032)])
def test_dot_csr_dense_matches_jax(m, k, n, density):
    d = _dense(m, k, density, m + k)
    rhs = np.random.RandomState(1).randn(k, n).astype(np.float32)
    jc, tc = _both_csr(d)
    want = jmx.nd.dot(jc, jmx.nd.array(rhs)).asnumpy()
    got = mt.nd.dot(tc, mt.nd.array(rhs)).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)
    # 1-d rhs
    v = rhs[:, 0]
    np.testing.assert_allclose(
        mt.nd.sparse.dot(tc, mt.nd.array(v)).asnumpy(),
        jsp.dot(jc, jmx.nd.array(v)).asnumpy(), **TOL)


@pytest.mark.parametrize("m,k,n,density", [(6, 50, 4, 0.1), (12, 20, 1, 0.3),
                                           (256, 1000, 2, 0.032)])
def test_dot_csr_transpose_returns_row_sparse_like_jax(m, k, n, density):
    d = _dense(m, k, density, 3 + m)
    rhs = np.random.RandomState(2).randn(m, n).astype(np.float32)
    jc, tc = _both_csr(d)
    j = jmx.nd.dot(jc, jmx.nd.array(rhs), transpose_a=True)
    t = mt.nd.dot(tc, mt.nd.array(rhs), transpose_a=True)
    assert t.stype == j.stype == "row_sparse"
    np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
    np.testing.assert_allclose(_np(t.data), _np(j.data), **TOL)
    np.testing.assert_allclose(t.asnumpy(), d.T @ rhs, rtol=1e-5, atol=1e-5)


def test_dot_out_kwarg_keeps_row_sparse():
    d = _dense(5, 9, 0.4, 13)
    tc = tsp.csr_matrix(d)
    rhs = np.random.RandomState(5).randn(9, 2).astype(np.float32)
    buf = mt.nd.zeros((5, 2))
    assert mt.nd.op.dot(tc, mt.nd.array(rhs), out=buf) is buf
    np.testing.assert_allclose(buf.asnumpy(), d @ rhs, rtol=1e-5, atol=1e-5)
    rhs2 = np.random.RandomState(6).randn(5, 2).astype(np.float32)
    rbuf = tsp.zeros("row_sparse", (9, 2))
    mt.nd.op.dot(tc, mt.nd.array(rhs2), transpose_a=True, out=rbuf)
    assert rbuf.stype == "row_sparse"
    np.testing.assert_allclose(rbuf.asnumpy(), d.T @ rhs2, rtol=1e-5,
                               atol=1e-5)


def _rsp_pair(shape, rows, seed):
    data = np.random.RandomState(seed).randn(len(rows),
                                             *shape[1:]).astype(np.float32)
    return (jsp.row_sparse_array((data, rows), shape=shape),
            tsp.row_sparse_array((data, rows), shape=shape))


def test_elemwise_add_rsp_rsp_matches_jax():
    ja, ta = _rsp_pair((9, 3), [0, 4, 4], 6)       # a repeated row too
    jb, tb = _rsp_pair((9, 3), [4, 8], 7)
    j, t = jsp.add(ja, jb), tsp.add(ta, tb)
    assert t.stype == "row_sparse"
    np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
    np.testing.assert_allclose(_np(t.data), _np(j.data), **TOL)
    np.testing.assert_allclose((ta + tb).asnumpy(), t.asnumpy(), **TOL)


@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False),
                                           (1, False), (1, True),
                                           ((0, 1), False), (0, True)])
def test_sum_csr_matches_jax(axis, keepdims):
    d = _dense(7, 11, 0.3, 9)
    jc, tc = _both_csr(d)
    want = jmx.nd.op.sum(jc, axis=axis, keepdims=keepdims).asnumpy()
    got = mt.nd.op.sum(tc, axis=axis, keepdims=keepdims).asnumpy()
    assert np.shape(got) == np.shape(want)
    np.testing.assert_allclose(got, want, **TOL)


def test_mask_pack_round_trip_matches_jax():
    data = np.array([[0.0, 0.0], [1.5, -2.0]], np.float32)
    j = jsp.row_sparse_array((data, [3, 7]), shape=(10, 2))
    t = tsp.row_sparse_array((data, [3, 7]), shape=(10, 2))
    jp, tp = jsp.mask_pack(j), tsp.mask_pack(t)
    np.testing.assert_array_equal(tp.asnumpy(), jp.asnumpy())
    back = tsp.mask_unpack(tp, (10, 2))
    # the row whose values are exactly zero stays in the row set
    assert _np(back.indices).tolist() == [3, 7]
    np.testing.assert_array_equal(back.asnumpy(), t.asnumpy())


def test_segment_sum_is_fixed_order_and_matches_jax():
    rs = np.random.RandomState(8)
    ids = rs.randint(0, 20, 200)
    data = rs.randn(200, 5).astype(np.float32)
    j = jsp.segment_sum_rows(jmx.nd.array(data)._data, ids, (20, 5))
    for src in (ids, torch.from_numpy(ids)):
        t = tsp.segment_sum_rows(torch.from_numpy(data), src, (20, 5))
        np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
        np.testing.assert_allclose(_np(t.data), _np(j.data), **TOL)
    a = tsp.segment_sum_rows(torch.from_numpy(data), ids, (20, 5))
    b = tsp.segment_sum_rows(torch.from_numpy(data), ids, (20, 5))
    assert torch.equal(a._data, b._data)


def test_dense_fallback_warns_once_and_computes():
    treg._FALLBACK_WARNED.clear()
    d = _dense(5, 6, 0.4, 10)
    tc = tsp.csr_matrix(d)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = mt.nd.op.tanh(tc)
    assert any("falling back to dense" in str(w.message) for w in caught)
    np.testing.assert_allclose(out.asnumpy(), np.tanh(d), rtol=1e-6,
                               atol=1e-6)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mt.nd.op.tanh(tc)
    assert not any("falling back" in str(w.message) for w in caught)


# ---------------------------------------------------------------------------
# save / load: one format for both packages
# ---------------------------------------------------------------------------

def test_sparse_save_load_interchanges_with_jax(tmp_path):
    dcsr = np.array([[1.0, 0, 2], [0, 0, 3]], np.float32)
    drsp = np.array([[0, 0], [1, 2], [0, 0]], np.float32)
    f1 = str(tmp_path / "port.nd")
    mt.nd.save(f1, {"csr": tsp.csr_matrix(dcsr),
                    "rsp": tsp.row_sparse_array(drsp),
                    "dense": mt.nd.ones((2, 2))})
    loaded = jutils.load(f1)
    assert type(loaded["csr"]).__name__ == "CSRNDArray"
    assert type(loaded["rsp"]).__name__ == "RowSparseNDArray"
    np.testing.assert_array_equal(loaded["csr"].asnumpy(), dcsr)
    np.testing.assert_array_equal(loaded["rsp"].asnumpy(), drsp)
    f2 = str(tmp_path / "jax.nd")
    jutils.save(f2, [jsp.csr_matrix(dcsr), jsp.row_sparse_array(drsp)])
    back = mt.nd.load(f2, ctx=CPU)
    assert [b.stype for b in back] == ["csr", "row_sparse"]
    np.testing.assert_array_equal(back[0].asnumpy(), dcsr)
    np.testing.assert_array_equal(back[1].asnumpy(), drsp)
    np.testing.assert_array_equal(_np(back[0].indptr), [0, 2, 3])
    # bfloat16 values travel as their float32 widening, as in JAX
    f3 = str(tmp_path / "bf16.nd")
    mt.nd.save(f3, {"w": tsp.csr_matrix(dcsr).astype("bfloat16")})
    w = mt.nd.load(f3, ctx=CPU)["w"]
    assert w._data.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.asnumpy(), dcsr)
    with pytest.raises(mt.MXNetError, match="reserved storage marker"):
        mt.nd.save(str(tmp_path / "bad.nd"),
                   {"w__csr__:x": mt.nd.ones((2, 2))})


def test_convert_sparse_from_parts():
    from mxnet_tpu_torch import convert
    d = _dense(4, 6, 0.5, 11)
    jc = jsp.csr_matrix(d)
    tc = convert.sparse_from_parts(_np(jc.data), _np(jc.indices),
                                   _np(jc.indptr), shape=d.shape)
    np.testing.assert_array_equal(tc.asnumpy(), d)
    jr = jsp.row_sparse_array(d)
    tr = convert.sparse_from_parts(_np(jr.data), _np(jr.indices),
                                   shape=d.shape)
    assert tr.stype == "row_sparse"
    np.testing.assert_array_equal(tr.asnumpy(), d)
