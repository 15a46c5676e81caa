"""Row-sparse pushes to the dist kvstore on N gloo ranks on the host (run
through ``python -m mxnet_tpu_torch.launch -n N``): each rank pushes its
own row_sparse gradients (drawn for every rank from one seed) into a
store with a lazy SGD-momentum updater, then the table, the momentum and
the row-sparse trainer reduce (``Trainer._allreduce_rowsparse``) are
written to OUT/rank<r>.npz for the test to hold against a one-process
replay."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

ROWS, DIM, STEPS = 16, 3, 3


def grads(rank_of, step):
    """(rows, values) rank ``rank_of`` pushes at ``step``; at step 1 the
    two ranks' values on row 5 cancel exactly."""
    rs = np.random.RandomState(100 * step + rank_of)
    rows = np.sort(rs.choice(ROWS, 4, replace=False))
    if step == 1:
        rows = np.array([2, 5, 9, 12]) if rank_of == 0 else \
            np.array([5, 6])
    vals = rs.randn(len(rows), DIM).astype(np.float32)
    if step == 1:
        vals[list(rows).index(5)] = 1.5 if rank_of == 0 else -1.5
    return rows, vals


def main():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.ndarray import sparse
    out_dir = sys.argv[1]
    with mt.cpu():
        assert kvstore_server.init_distributed()
        kv = mt.kv.create("dist_sync")
        rank, nw = kv.rank, kv.num_workers
        kv.init("w", mt.nd.array(np.linspace(-1, 1, ROWS * DIM).reshape(
            ROWS, DIM).astype(np.float32)))
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                                          wd=0.01, lazy_update=True))
        wire = []
        for step in range(STEPS):
            rows, vals = grads(rank, step)
            kv.push("w", sparse.row_sparse_array((vals, rows),
                                                 shape=(ROWS, DIM)))
            wire.append((kv.last_rsp_wire_bytes, kv.last_rsp_touched_bytes))
        w = mt.nd.zeros((ROWS, DIM))
        kv.pull("w", out=w)
        mom = kv._updater.states["w"]
        pulled = sparse.zeros("row_sparse", (ROWS, DIM))
        kv.row_sparse_pull("w", out=pulled,
                           row_ids=mt.nd.array([5, 0], dtype="int64"))
        # the trainer's row-sparse reduce over the same group
        p = mt.gluon.Parameter("emb", shape=(ROWS, DIM),
                               grad_stype="row_sparse")
        p.initialize(ctx=mt.cpu())
        tr = mt.gluon.Trainer([p], "sgd", {"learning_rate": 0.1},
                              kvstore=mt.kv.create("dist_sync"))
        rows, vals = grads(rank, 1)
        p.grad()._update(mt.nd.array(vals)._data,
                         mt.nd.array(rows, dtype="int64")._data)
        tr.allreduce_grads()
        g = p.grad()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), w=w.asnumpy(),
                 mom=mom.asnumpy(), pulled=pulled.asnumpy(),
                 pulled_ids=pulled.indices.asnumpy(),
                 grad_ids=g.indices.asnumpy(), grad=g.data.asnumpy(),
                 wire=np.asarray(wire),
                 collectives=tr.last_allreduce_collectives)
        kv.barrier()
    print(f"worker {rank}/{nw}: sparse checks passed", flush=True)


if __name__ == "__main__":
    main()
