"""``parallel.sharded_embedding`` of the port against the JAX package's
(the cases of ``tests/test_sharded_embedding.py``), on the CPU: one
process on a ``{mp: 1}`` mesh held to the JAX table sharded over the
8-device host mesh, and two gloo ranks on ``{mp: 2}``
(``tests/dist/torch_sharded_worker.py``, under a timeout) held to the
one process bit for bit.

Lookups are exact (one owner a row); the scatter-add sums repeated ids
first, in a fixed order, so it is within 1e-6 of the JAX package's
sequential adds and bitwise the same at every world size; the lookup's
gradient is the masked scatter of the output gradient.
"""
import os
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import sharded_embedding as jse

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import make_mesh
from mxnet_tpu_torch.parallel import sharded_embedding as tse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "dist"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_sharded_worker as W  # noqa: E402
from torch_dist_common import launch, worker  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def one():
    with mt.cpu():
        return W.run(mt, make_mesh({"mp": 1}))


def test_one_process_matches_jax_on_the_host_mesh(one):
    import jax
    import jax.numpy as jnp
    table, ids, rows, cot = W.case()
    mesh = jpar.make_mesh({"mp": 8})
    sharded = jse.shard_table(jnp.asarray(table), mesh, "mp")
    lookup = np.asarray(jse.sharded_lookup(sharded, ids.astype(np.int32),
                                           mesh, "mp"))
    np.testing.assert_array_equal(one[0], lookup)
    np.testing.assert_array_equal(one[0], table[ids])
    added = np.asarray(jse.sharded_scatter_add(
        sharded, ids.astype(np.int32), jnp.asarray(rows), mesh, "mp"))
    np.testing.assert_allclose(one[1], added, **TOL)
    grad = jax.grad(lambda t: (jse.sharded_lookup(
        t, ids.astype(np.int32), mesh, "mp") * jnp.asarray(cot)).sum())(
        sharded)
    np.testing.assert_allclose(one[2], np.asarray(grad), **TOL)


def test_sharded_embedding_update_and_lookup(one):
    """``ShardedEmbedding``: its own seeded table (the JAX one draws from
    jax.random), the row-sparse SGD step equal to the dense one."""
    with mt.cpu():
        emb = tse.ShardedEmbedding(W.VOCAB, W.DIM, make_mesh({"mp": 1}),
                                   seed=3)
    table, ids, rows, _ = W.case()
    start = torch.randn((W.VOCAB, W.DIM),
                        generator=torch.Generator().manual_seed(3)) * 0.01
    want = start.numpy().copy()
    for i, r in zip(ids, rows):
        want[i] -= 0.5 * r
    np.testing.assert_allclose(one[3], want, **TOL)
    np.testing.assert_array_equal(one[4], one[3][ids])
    assert len(emb.shards) == 1 and emb.shards[0].shape == (W.VOCAB, W.DIM)


def test_training_through_the_lookup_matches_a_dense_table():
    """An embedding regression trained through the sharded lookup's
    row-sparse gradient equals the same model on a dense table (the JAX
    test's convergence parity)."""
    rs = np.random.RandomState(2)
    w0 = rs.randn(W.VOCAB, W.DIM).astype(np.float32) * 0.1
    proj = torch.from_numpy(rs.randn(W.DIM, 1).astype(np.float32))
    ids = torch.from_numpy(rs.randint(0, W.VOCAB, 16))
    y = torch.from_numpy(rs.randn(16, 1).astype(np.float32))
    mesh = make_mesh({"mp": 1})
    sharded = torch.from_numpy(w0.copy())
    dense = torch.from_numpy(w0.copy()).requires_grad_(True)
    losses = []
    for _ in range(10):
        leaf = sharded.clone().requires_grad_(True)
        ls = ((tse.sharded_lookup(leaf, ids, mesh) @ proj - y) ** 2).mean()
        ls.backward()
        ld = ((dense[ids] @ proj - y) ** 2).mean()
        ld.backward()
        with torch.no_grad():
            sharded = sharded - 0.5 * mt.autograd.densify(leaf.grad)
            dense -= 0.5 * dense.grad
            dense.grad = None
        losses.append((float(ls.detach()), float(ld.detach())))
    np.testing.assert_allclose(*zip(*losses), rtol=1e-5)
    np.testing.assert_allclose(sharded.numpy(), dense.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert losses[-1][0] < losses[0][0]


def test_two_ranks_equal_one_process_bit_for_bit(one, tmp_path):
    proc = launch(2, worker("torch_sharded_worker.py") + [str(tmp_path)],
                  timeout=240)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    r = [dict(np.load(tmp_path / f"rank{k}.npz")) for k in range(2)]
    for k in range(2):
        np.testing.assert_array_equal(r[k]["lookup"], one[0])
        np.testing.assert_array_equal(r[k]["full"], one[3])
        np.testing.assert_array_equal(r[k]["emb_out"], one[4])
    np.testing.assert_array_equal(
        np.concatenate([r[0]["block"], r[1]["block"]]), one[1])
    np.testing.assert_array_equal(
        np.concatenate([r[0]["grad"], r[1]["grad"]]), one[2])
