"""The DGL graph ops of the port (``ndarray/graph_ops.py`` and the
``_contrib_edge_id`` / ``_contrib_dgl_*`` registry names) against the JAX
package's, exactly, on the CPU (the cases of ``tests/test_graph_ops.py``).

The samplers draw from ``mx.random.np_rng()``; the two packages seed it
from different streams, so the parity cases give both the same numpy
generator, and the port's own ``mx.random.seed`` is held to repeat (and
another seed to change) a sample.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import random as jrandom

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import random as trandom

CPU = mt.cpu()
PKGS = (jmx, mt)


@pytest.fixture(autouse=True)
def _on_cpu():
    with CPU:
        yield


def _full_graph(pkg):
    # the 5-vertex complete graph of dgl_graph.cc:775-780
    data = np.arange(1, 21, dtype=np.int64)
    indices = np.array([1, 2, 3, 4, 0, 2, 3, 4, 0, 1, 3, 4,
                        0, 1, 2, 4, 0, 1, 2, 3], np.int64)
    indptr = np.array([0, 4, 8, 12, 16, 20], np.int64)
    return pkg.nd.sparse.csr_matrix((data, indices, indptr), shape=(5, 5))


def _big_graph(pkg):
    n = 50
    dense = np.zeros((n, n), np.int64)
    rs = np.random.RandomState(1)
    eid = 1
    for r in range(n):
        for c in rs.choice(n, 4, replace=False):
            if c != r:
                dense[r, c] = eid
                eid += 1
    rows, cols = np.nonzero(dense)
    indptr = np.concatenate(([0], np.cumsum(np.bincount(rows, minlength=n))))
    return pkg.nd.sparse.csr_matrix((dense[rows, cols], cols, indptr),
                                    shape=(n, n))


def _same(a, b):
    """Exact equality of two results (tuples of NDArray / csr)."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert getattr(x, "stype", "default") == getattr(y, "stype",
                                                         "default")
        assert tuple(x.shape) == tuple(y.shape)
        np.testing.assert_array_equal(np.asarray(x.asnumpy()),
                                      np.asarray(y.asnumpy()))
        if getattr(x, "stype", "default") == "csr":
            for part in ("indices", "indptr", "data"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(x, part).asnumpy()),
                    np.asarray(getattr(y, part).asnumpy()))


@pytest.fixture
def same_rng(monkeypatch):
    """Both packages' samplers draw from numpy generators of one seed."""
    def use(seed):
        monkeypatch.setattr(jrandom, "np_rng",
                            lambda: np.random.default_rng(seed))
        monkeypatch.setattr(trandom, "np_rng",
                            lambda: np.random.default_rng(seed))
    return use


def test_edge_id_matches_jax():
    outs = [pkg.nd.contrib.edge_id(_full_graph(pkg),
                                   pkg.nd.array(np.array([0, 1, 0, 4])),
                                   pkg.nd.array(np.array([1, 0, 0, 3])))
            for pkg in PKGS]
    _same(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1].asnumpy(), [1, 5, -1, 20])
    got = mt.nd._internal._contrib_edge_id(
        _full_graph(mt), mt.nd.array(np.array([2])),
        mt.nd.array(np.array([4])))
    np.testing.assert_array_equal(got.asnumpy(), [12])


def test_dgl_adjacency_matches_jax():
    outs = [pkg.nd.contrib.dgl_adjacency(_full_graph(pkg)) for pkg in PKGS]
    _same(outs[1], outs[0])
    assert outs[1].dtype == np.float32


def test_dgl_subgraph_matches_jax():
    x = np.array([[1, 0, 0, 2], [3, 0, 4, 0], [0, 5, 0, 0],
                  [0, 6, 7, 0]], np.float32)
    outs = [pkg.nd.contrib.dgl_subgraph(
        pkg.nd.sparse.csr_matrix(x), pkg.nd.array(np.array([0, 1, 2])),
        pkg.nd.array(np.array([1, 3])), return_mapping=True)
        for pkg in PKGS]
    _same(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1][0].asnumpy(),
                                  [[1, 0, 0], [2, 0, 3], [0, 4, 0]])


@pytest.mark.parametrize("hops,k,cap,seeds", [
    (1, 2, 5, [0, 1, 2, 3, 4]), (1, 2, 4, [0]), (2, 3, 6, [1, 3])])
def test_uniform_sample_matches_jax(same_rng, hops, k, cap, seeds):
    outs = []
    for pkg in PKGS:
        same_rng(11)
        outs.append(pkg.nd.contrib.dgl_csr_neighbor_uniform_sample(
            _full_graph(pkg), pkg.nd.array(np.array(seeds, np.int64)),
            num_args=2, num_hops=hops, num_neighbor=k,
            max_num_vertices=cap))
    _same(outs[1], outs[0])


def test_non_uniform_sample_matches_jax(same_rng):
    for prob_v, k in (([0.0, 0.5, 0.5, 0.0, 0.0], 2),
                      ([0.0, 1.0, 0.0, 0.0, 0.0], 3),
                      ([0.1, 0.2, 0.3, 0.2, 0.2], 2)):
        outs = []
        for pkg in PKGS:
            same_rng(5)
            outs.append(pkg.nd.contrib.dgl_csr_neighbor_non_uniform_sample(
                _full_graph(pkg), pkg.nd.array(np.array(prob_v, np.float32)),
                pkg.nd.array(np.array([0, 2], np.int64)), num_args=3,
                num_hops=1, num_neighbor=k, max_num_vertices=5))
        _same(outs[1], outs[0])


def test_large_graph_sample_and_compact_match_jax(same_rng):
    outs = []
    for pkg in PKGS:
        same_rng(7)
        verts, sub, layer = pkg.nd.contrib.dgl_csr_neighbor_uniform_sample(
            _big_graph(pkg), pkg.nd.array(np.array([40], np.int64)),
            num_args=2, num_hops=2, num_neighbor=2, max_num_vertices=6)
        cnt = int(verts.asnumpy()[-1])
        compact = pkg.nd.contrib.dgl_graph_compact(
            sub, verts, graph_sizes=(cnt,), return_mapping=True)
        outs.append((verts, sub, layer) + tuple(compact))
    _same(outs[1], outs[0])


def test_registry_names_reach_the_graph_ops(same_rng):
    g = _full_graph(mt)
    same_rng(3)
    a = mt.nd._internal._contrib_dgl_csr_neighbor_uniform_sample(
        g, mt.nd.array(np.array([0, 1], np.int64)), num_hops=1,
        num_neighbor=2, max_num_vertices=5)
    same_rng(3)
    b = mt.nd.contrib.dgl_csr_neighbor_uniform_sample(
        g, mt.nd.array(np.array([0, 1], np.int64)), num_hops=1,
        num_neighbor=2, max_num_vertices=5)
    _same(a, b)
    with pytest.raises(mt.MXNetError, match="operates on sparse"):
        mt.nd._internal._contrib_dgl_adjacency(mt.nd.ones((2, 2)))


def test_port_seed_repeats_a_sample():
    def draw():
        return mt.nd.contrib.dgl_csr_neighbor_uniform_sample(
            _big_graph(mt), mt.nd.array(np.array([3, 17, 40], np.int64)),
            num_args=2, num_hops=2, num_neighbor=2, max_num_vertices=12)
    mt.random.seed(4)
    a = draw()
    mt.random.seed(4)
    b = draw()
    _same(a, b)
    mt.random.seed(5)
    c = draw()
    assert not all(np.array_equal(x.asnumpy(), y.asnumpy())
                   for x, y in zip(a, c))
