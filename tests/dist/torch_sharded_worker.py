"""``parallel.sharded_embedding`` on N gloo ranks on the host (run through
``python -m mxnet_tpu_torch.launch -n N``) over a ``{mp: N}`` mesh: each
rank holds its block of one table drawn from a seed; lookups of ids with
repeats, a scatter-add and the lookup's row-sparse gradient. The results
go to OUT/rank<r>.npz for the test to hold against one process."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

VOCAB, DIM = 64, 8


def case():
    rs = np.random.RandomState(0)
    table = rs.randn(VOCAB, DIM).astype(np.float32)
    ids = np.array([3, 3, 60, 10, 33, 0, 63, 33], np.int64)
    rows = rs.randn(len(ids), DIM).astype(np.float32)
    cot = rs.randn(len(ids), DIM).astype(np.float32)
    return table, ids, rows, cot


def run(mt, mesh):
    """(lookup, table after scatter-add, this rank's block gradient)."""
    import torch
    from mxnet_tpu_torch.parallel import sharded_embedding as se
    table, ids, rows, cot = case()
    block = se.shard_table(torch.from_numpy(table), mesh, "mp")
    out = se.sharded_lookup(block, torch.from_numpy(ids), mesh, "mp")
    leaf = block.clone().requires_grad_(True)
    with torch.enable_grad():
        y = se.sharded_lookup(leaf, torch.from_numpy(ids), mesh, "mp")
        (y * torch.from_numpy(cot)).sum().backward()
    grad = mt.autograd.densify(leaf.grad)
    se.sharded_scatter_add(block, torch.from_numpy(ids),
                           torch.from_numpy(rows), mesh, "mp")
    emb = se.ShardedEmbedding(VOCAB, DIM, mesh, axis="mp", seed=3)
    emb.sgd_update_sparse(torch.from_numpy(ids), torch.from_numpy(rows),
                          0.5)
    return out.numpy(), block.numpy(), grad.numpy(), emb.full().numpy(), \
        emb(torch.from_numpy(ids)).numpy()


def main():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.parallel import make_mesh
    out_dir = sys.argv[1]
    with mt.cpu():
        assert kvstore_server.init_distributed()
        info = kvstore_server.group_info()
        mesh = make_mesh({"mp": info["world"]})
        lookup, block, grad, full, emb_out = run(mt, mesh)
    np.savez(os.path.join(out_dir, f"rank{info['rank']}.npz"),
             lookup=lookup, block=block, grad=grad, full=full,
             emb_out=emb_out)
    print(f"worker {info['rank']}: sharded checks passed", flush=True)


if __name__ == "__main__":
    main()
