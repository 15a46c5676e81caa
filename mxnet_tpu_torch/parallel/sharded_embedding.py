"""Embedding tables sharded by rows over a mesh of ranks (ref: the JAX
package's ``parallel/sharded_embedding.py``; the dist kvstore's
server-side row-sparse path, kvstore_dist_server.h:331
DataHandleRowSparse, in the reference).

The JAX package places ONE jax.Array row-sharded over a mesh axis and
runs lookups and updates inside shard_map programs. The port's mesh
(``parallel/mesh.py``) is a grid of the group's ranks, so here each rank
holds its contiguous block of ``rows / n`` rows (``shard_table``) and
the collectives run explicitly over the axis's subgroup:

- :func:`sharded_lookup` is the masked gather and one all-reduce: each
  rank gathers the requested rows it owns and zeros elsewhere; the sum
  over the axis assembles the batch on every rank. Only the ids and the
  ``(batch, dim)`` result move, never the table. Every row of the sum
  has one owner and zeros from the rest, so it is exact. Its gradient,
  for this rank's block, is the masked scatter of the output's gradient
  (a sparse COO tensor: the row-sparse gradient never leaves its shard).
- :func:`sharded_scatter_add` is ``table[ids] += rows`` shard-locally:
  repeated ids are summed first in a fixed order
  (``ndarray/sparse.segment_sum``), then each rank adds the rows it owns
  (the others add zeros, which changes no bit), so the result is the
  same bits as the one-process table's.
"""
from __future__ import annotations

import torch

from ..base import check, torch_dtype
from ..context import current_context, resolve_device
from . import collectives as _coll

__all__ = ["ShardedEmbedding", "shard_table", "sharded_lookup",
           "sharded_scatter_add"]


def _axis(mesh, axis: str):
    check(axis in mesh.axis_names, f"mesh has no axis {axis!r}")
    return mesh.axis_size(axis), mesh.axis_index(axis)


def shard_table(table: torch.Tensor, mesh, axis: str = "mp") -> torch.Tensor:
    """This rank's contiguous block of a full ``(rows, dim)`` table
    (rows ``[i * rows/n, (i + 1) * rows/n)`` at axis index i)."""
    n, i = _axis(mesh, axis)
    check(table.shape[0] % n == 0,
          f"table rows {table.shape[0]} must divide the {axis} axis ({n})")
    per = table.shape[0] // n
    return table[i * per:(i + 1) * per].contiguous()


def _local(ids: torch.Tensor, n_local: int, index: int):
    """(clamped local rows, mask of the ids this rank owns)."""
    local = ids.to(torch.int64) - index * n_local
    mine = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), mine


def _lookup_value(block, ids, mesh, axis):
    """(the assembled rows, clamped local rows, mask of this rank's)."""
    n, i = _axis(mesh, axis)
    safe, mine = _local(ids, block.shape[0], i)
    got = block.index_select(0, safe.reshape(-1)).reshape(
        tuple(ids.shape) + tuple(block.shape[1:]))
    contrib = torch.where(mine.unsqueeze(-1), got, torch.zeros_like(got))
    group = mesh.group(axis)
    if group is not None:
        contrib = _coll._raw_allreduce(contrib, group)
    return contrib, safe, mine


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, ids, mesh, axis):
        out, safe, mine = _lookup_value(block, ids, mesh, axis)
        ctx.save_for_backward(safe, mine)
        ctx.shape = block.shape
        return out

    @staticmethod
    def backward(ctx, dout):
        safe, mine = ctx.saved_tensors
        rows = torch.where(mine.unsqueeze(-1), dout,
                           torch.zeros_like(dout)).reshape(
            (-1,) + tuple(ctx.shape[1:]))
        grad = torch.sparse_coo_tensor(safe.reshape(1, -1), rows, ctx.shape,
                                       check_invariants=False)
        return grad, None, None, None


def sharded_lookup(table: torch.Tensor, ids, mesh, axis: str = "mp"):
    """Rows ``ids`` of the row-sharded table whose block this rank holds
    (``table``); every rank of the axis gets the whole result."""
    ids = torch.as_tensor(ids, device=table.device)
    if torch.is_grad_enabled() and table.requires_grad:
        return _Lookup.apply(table, ids, mesh, axis)
    with torch.no_grad():
        return _lookup_value(table, ids, mesh, axis)[0]


def sharded_scatter_add(table: torch.Tensor, ids, rows, mesh,
                        axis: str = "mp") -> torch.Tensor:
    """``table[ids] += rows`` on this rank's block, in place (and
    returned): repeats of an id summed first, each rank adding only the
    rows it owns."""
    from ..ndarray.sparse import segment_sum
    n, i = _axis(mesh, axis)
    ids = torch.as_tensor(ids, device=table.device).reshape(-1)
    rows = torch.as_tensor(rows, device=table.device).reshape(
        (ids.shape[0],) + tuple(table.shape[1:])).to(table.dtype)
    uniq, summed, _ = segment_sum(rows, ids)
    safe, mine = _local(uniq, table.shape[0], i)
    summed = torch.where(mine.reshape((-1,) + (1,) * (summed.dim() - 1)),
                         summed, torch.zeros_like(summed))
    with torch.no_grad():
        table.index_add_(0, safe, summed)
    return table


class ShardedEmbedding:
    """An embedding table living row-sharded across the ranks of a mesh
    axis: the port of the JAX package's table that never moves.

    >>> emb = ShardedEmbedding(100000, 64, mesh, axis="mp")
    >>> vecs = emb(ids)                       # (batch, 64) on every rank
    >>> emb.sgd_update_sparse(ids, grads, lr) # row-sparse SGD step

    The full table is drawn once from a seeded generator on the host
    (every rank the same bits) and each rank keeps its block on its
    device (``device``, default the current context)."""

    def __init__(self, input_dim: int, output_dim: int, mesh,
                 axis: str = "mp", dtype=None, init_scale: float = 0.01,
                 seed: int = 0, device=None):
        n, _ = _axis(mesh, axis)
        check(input_dim % n == 0,
              f"input_dim {input_dim} must be divisible by the {axis} "
              f"axis size {n} (pad the vocabulary)")
        self.mesh, self.axis = mesh, axis
        self.input_dim, self.output_dim = input_dim, output_dim
        dev = resolve_device(device if device is not None
                             else current_context())
        gen = torch.Generator().manual_seed(int(seed))
        full = torch.randn((input_dim, output_dim), generator=gen,
                           dtype=torch_dtype(dtype or "float32")) * \
            init_scale
        self.weight = shard_table(full, mesh, axis).to(dev)

    def __call__(self, ids):
        return sharded_lookup(self.weight, ids, self.mesh, self.axis)

    def lookup(self, ids):
        return self(ids)

    def sgd_update_sparse(self, ids, grad_rows, lr: float) -> None:
        """weight[ids] -= lr * grad_rows, shard-locally."""
        sharded_scatter_add(self.weight, ids, -lr * torch.as_tensor(
            grad_rows, device=self.weight.device), self.mesh, self.axis)

    @property
    def shards(self):
        """The blocks this process holds (one: its rank's)."""
        return [self.weight]

    def full(self) -> torch.Tensor:
        """The whole table, gathered from every rank of the axis."""
        if self.mesh.group(self.axis) is None:
            return self.weight.clone()
        return _coll.allgather(self.weight, self.mesh, self.axis, 0)
