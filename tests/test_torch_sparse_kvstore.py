"""Row-sparse push and pull through the port's kvstore against the JAX
package's, on the CPU: one process (``local``) and two gloo ranks of the
dist store started by the port's launcher
(``tests/dist/torch_sparse_worker.py``, every spawned run under a
timeout).

A push of row_sparse values is merged (the union of the rows, repeats
summed) and applied lazily; across workers the rows ride the dense reduce
packed with a row mask, so a row whose summed gradient is exactly zero
still gets its lazy weight decay and momentum. Values within 1e-6 of the
JAX store's; the two ranks' tables bit for bit alike, and bit for bit the
port's one-process replay that pushes both ranks' gradients into a local
store.
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ndarray import sparse as tsp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "dist"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_sparse_worker as W  # noqa: E402
from torch_dist_common import launch, worker  # noqa: E402

CPU = mt.cpu()
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with CPU:
        yield


def _rsp(sp, rows, vals, shape):
    return sp.row_sparse_array((vals, rows), shape=shape)


def _replay(pkg, sp, kv_mod, n_ranks, updater=True):
    """Every rank's pushes of every step into one local store."""
    kv = kv_mod.create("local")
    kv.init("w", pkg.nd.array(np.linspace(-1, 1, W.ROWS * W.DIM).reshape(
        W.ROWS, W.DIM).astype(np.float32)))
    if updater:
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                                           wd=0.01, lazy_update=True))
    for step in range(W.STEPS):
        kv.push("w", [_rsp(sp, *W.grads(r, step), (W.ROWS, W.DIM))
                      for r in range(n_ranks)])
    out = pkg.nd.zeros((W.ROWS, W.DIM))
    kv.pull("w", out=out)
    return kv, out.asnumpy()


@pytest.mark.parametrize("updater", [True, False])
def test_local_row_sparse_push_matches_jax(updater):
    jkv_, jw = _replay(jmx, jsp, jkv, 2, updater)
    tkv_, tw = _replay(mt, tsp, mt.kvstore, 2, updater)
    np.testing.assert_allclose(tw, jw, **TOL)
    if updater:
        np.testing.assert_allclose(tkv_._updater.states["w"].asnumpy(),
                                   jkv_._updater.states["w"].asnumpy(), **TOL)
    else:   # replace semantics: rows outside the last push read zero
        rows = set()
        for r in range(2):
            rows |= set(W.grads(r, W.STEPS - 1)[0].tolist())
        untouched = [i for i in range(W.ROWS) if i not in rows]
        assert not tw[untouched].any()


def test_row_sparse_pull_matches_jax():
    table = np.random.RandomState(3).randn(12, 4).astype(np.float32)
    rid = np.array([9, 1, 1, 33 % 12])
    outs = []
    for pkg, sp, kv_mod in ((jmx, jsp, jkv), (mt, tsp, mt.kvstore)):
        kv = kv_mod.create("local")
        kv.init("emb", pkg.nd.array(table))
        dense = pkg.nd.zeros((4, 4))
        kv.row_sparse_pull("emb", out=dense,
                           row_ids=pkg.nd.array(rid, dtype="int64"))
        rsp = sp.zeros("row_sparse", (12, 4))
        kv.row_sparse_pull("emb", out=rsp,
                           row_ids=pkg.nd.array(np.array([2, 7]),
                                                dtype="int64"))
        outs.append((dense.asnumpy(), rsp.asnumpy(),
                     np.asarray(rsp.indices.asnumpy())))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sparse_dist")
    proc = launch(2, worker("torch_sparse_worker.py") + [str(out)],
                  timeout=240)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def test_dist_row_sparse_push_matches_jax_and_replay(two_ranks):
    r0, r1 = two_ranks
    for k in ("w", "mom", "pulled", "grad"):
        np.testing.assert_array_equal(r0[k], r1[k])
    jkv_, jw = _replay(jmx, jsp, jkv, 2)
    np.testing.assert_allclose(r0["w"], jw, **TOL)
    np.testing.assert_allclose(r0["mom"],
                               jkv_._updater.states["w"].asnumpy(), **TOL)
    tkv_, tw = _replay(mt, tsp, mt.kvstore, 2)
    np.testing.assert_array_equal(r0["w"], tw)
    np.testing.assert_array_equal(r0["mom"],
                                  tkv_._updater.states["w"].asnumpy())
    # the cancelled row 5 of step 1 got its momentum and decay
    assert r0["mom"][5].any()
    # row_sparse_pull of rows [5, 0]
    np.testing.assert_array_equal(r0["pulled_ids"], [0, 5][::-1])
    np.testing.assert_array_equal(r0["pulled"][[5, 0]], r0["w"][[5, 0]])
    # the wire carries rows x (dim + 1) f32 whatever the touched rows
    wire = r0["wire"]
    assert (wire[:, 0] == W.ROWS * (W.DIM + 1) * 4).all()
    assert (wire[:, 1] <= 6 * W.DIM * 4).all()


def test_dist_trainer_row_sparse_reduce_is_the_union(two_ranks):
    r0 = two_ranks[0]
    assert int(r0["collectives"]) == 1
    want = tsp.add(_rsp(tsp, *W.grads(0, 1), (W.ROWS, W.DIM)),
                   _rsp(tsp, *W.grads(1, 1), (W.ROWS, W.DIM)))
    np.testing.assert_array_equal(r0["grad_ids"], [2, 5, 6, 9, 12])
    np.testing.assert_allclose(r0["grad"], want.data.asnumpy(), **TOL)
    assert not r0["grad"][1].any()        # the cancelled row stays
