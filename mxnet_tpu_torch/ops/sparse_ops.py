"""Storage-type kernels (ref: the JAX package's ``ops/sparse_ops.py``; the
reference's ``FComputeEx`` kernels: src/operator/tensor/dot-inl.h csr x
dense and csr^T x dense -> row_sparse, indexing_op.cc's row-sparse
Embedding gradient, optimizer_op.cc's row-sparse updates).

Each kernel works on the compact arrays and never builds the dense form
of a sparse operand, in ordinary PyTorch on the arrays' device:

- ``dot(csr, dense)``: gather the rhs rows the column ids name, scale
  them by the values, and sum each row's run with
  ``torch.segment_reduce`` (a csr's values are grouped by row already).
  Work and memory follow nnz, not rows x cols.
- ``dot(csr^T, dense)`` returns **row_sparse**: the products grouped by
  column (a stable sort on the host, where the coordinates live) and
  summed the same way, one row per touched column.
- Under ``autograd.record()`` both are ``torch.autograd.Function``s. The
  gradient of ``dot(csr, w)`` for ``w`` is a torch sparse COO tensor of
  ``w``'s shape holding one row per stored value (repeats allowed), which
  torch accumulates without densifying; the variable's delivery hook
  (``autograd.py``) sums the repeats once, into the row_sparse buffer.
  The row-sparse ``Embedding`` gradient (``embedding_rows``) travels the
  same way.
- The lazy optimizer updates (``step_rows``) gather the gradient's rows
  of the weight and state, step them by the dense update's own
  multi-tensor rule (``optimizer_ops``), and write them back with
  ``index_copy``: rows outside the gradient keep their bits. The
  registry's ``_sparse_*_update`` ops, ``Optimizer.update``'s lazy
  branch and the embedding plane's ``sparse_rows_update`` all go
  through it.

The JAX package pads nnz to power-of-two buckets so that XLA compiles a
bounded set of programs; PyTorch compiles nothing, so nothing is padded.
Every sum over repeated ids is a segment sum in a fixed order
(``ndarray/sparse.segment_sum``): two runs give the same bits.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import check
from . import optimizer_ops as _opt
from .registry import register, register_sparse

__all__ = ["csr_dot", "csr_t_dot", "embedding_rows", "step_rows"]


def _sp():
    from ..ndarray import sparse
    return sparse


def _segment_rows(contrib: torch.Tensor, lengths: torch.Tensor):
    """Sum consecutive runs of ``contrib``'s rows, ``lengths`` long."""
    width = int(_np.prod(contrib.shape[1:]))
    flat = contrib.reshape(contrib.shape[0], width)
    out = torch.segment_reduce(flat, "sum", lengths=lengths, axis=0,
                               unsafe=True)
    return out.reshape((lengths.shape[0],) + tuple(contrib.shape[1:]))


def _scaled(vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Each row of ``rows`` times its stored value (rows may be 1-d)."""
    return vals.reshape((-1,) + (1,) * (rows.dim() - 1)).to(rows.dtype) * \
        rows


def _csr_dot_value(csr, rhs: torch.Tensor) -> torch.Tensor:
    """csr (M, K) x dense (K[, N]) -> dense (M[, N])."""
    contrib = _scaled(csr._data, rhs.index_select(0, csr._indices))
    return _segment_rows(contrib, csr._row_lengths_dev())


class _ColumnGroups:
    """The grouping of a csr's stored values by column, from the host
    coordinates: ``order`` sorts them by column (stably), ``lengths`` and
    ``uniq`` are the runs. Cached on the csr."""

    def __init__(self, csr):
        cols = csr._indices_np.astype(_np.int64)
        order = _np.argsort(cols, kind="stable")
        uniq, counts = _np.unique(cols[order], return_counts=True)
        inv = _np.empty_like(order)
        inv[order] = _np.arange(len(order))
        dev = csr._data.device
        self.uniq = uniq
        self.uniq_t = torch.from_numpy(uniq).to(dev)
        self.order = torch.from_numpy(order).to(dev)
        self.lengths = torch.from_numpy(counts).to(dev)
        # per stored value, the position of its column among uniq
        self.slot = torch.from_numpy(
            _np.repeat(_np.arange(len(uniq)), counts)[inv]).to(dev)


def _column_groups(csr) -> _ColumnGroups:
    g = getattr(csr, "_col_groups", None)
    if g is None:
        g = csr._col_groups = _ColumnGroups(csr)
    return g


def _csr_t_dot_value(csr, rhs: torch.Tensor):
    """csr^T (K, M) x dense (M, N) -> (rows of the touched columns, their
    ids): the row_sparse result."""
    g = _column_groups(csr)
    contrib = _scaled(csr._data, rhs.index_select(0, csr._row_ids_dev()))
    return _segment_rows(contrib.index_select(0, g.order), g.lengths), g


class _CsrDot(torch.autograd.Function):
    """y = csr @ w; dL/dw is row-sparse in the csr's column space: one row
    ``value * dy[row]`` per stored value at its column (ref: dot-inl.h's
    backward storage type, csr^T x grad -> row_sparse)."""

    @staticmethod
    def forward(ctx, rhs, csr):
        ctx.csr = csr
        ctx.rhs_shape = rhs.shape
        return _csr_dot_value(csr, rhs)

    @staticmethod
    def backward(ctx, dy):
        csr = ctx.csr
        rows = _scaled(csr._data, dy.index_select(0, csr._row_ids_dev()))
        grad = torch.sparse_coo_tensor(
            csr._indices.unsqueeze(0), rows, ctx.rhs_shape,
            check_invariants=False)
        return grad, None


class _CsrTDot(torch.autograd.Function):
    """rows = (csr^T @ w) at the touched columns; dL/dw = csr @ d(rows)
    scattered back to those columns: a dense (M, N) gradient, as in the
    reference."""

    @staticmethod
    def forward(ctx, rhs, csr):
        out, g = _csr_t_dot_value(csr, rhs)
        ctx.csr, ctx.groups = csr, g
        return out

    @staticmethod
    def backward(ctx, drows):
        csr, g = ctx.csr, ctx.groups
        contrib = _scaled(csr._data, drows.index_select(0, g.slot))
        return _segment_rows(contrib, csr._row_lengths_dev()), None


def csr_dot(csr, rhs: torch.Tensor) -> torch.Tensor:
    """csr x dense on tensors (differentiable in ``rhs``)."""
    if torch.is_grad_enabled() and rhs.requires_grad:
        return _CsrDot.apply(rhs, csr)
    return _csr_dot_value(csr, rhs)


def csr_t_dot(csr, rhs: torch.Tensor):
    """csr^T x dense on tensors: ``(rows, unique column ids as numpy)``."""
    if torch.is_grad_enabled() and rhs.requires_grad:
        return _CsrTDot.apply(rhs, csr), _column_groups(csr).uniq
    out, g = _csr_t_dot_value(csr, rhs)
    return out, g.uniq


@register_sparse("dot", ("csr", "default"))
def _dot_csr_dense(lhs, rhs, transpose_a=False, transpose_b=False, **_):
    """dot with a csr lhs (ref: dot-inl.h DotCsrDnsDns / DotCsrDnsRspImpl):
    dense out, or row_sparse with ``transpose_a``."""
    from .. import autograd
    from ..ndarray import ndarray as _nd
    sp = _sp()
    check(not transpose_b, "dot(csr, dense): transpose_b is not supported "
                           "(matches reference dot-inl.h)")
    t = rhs._data
    rec = autograd.is_recording()
    with torch.enable_grad() if rec else torch.no_grad():
        if transpose_a:
            rows, uniq = csr_t_dot(lhs, t)
            return sp.RowSparseNDArray(
                rows, torch.from_numpy(uniq),
                (lhs.shape[1],) + tuple(t.shape[1:]), indices_np=uniq)
        return _nd.NDArray(csr_dot(lhs, t))


@register_sparse("elemwise_add", ("row_sparse", "row_sparse"))
def _add_rsp_rsp(lhs, rhs, **_):
    """row_sparse + row_sparse -> row_sparse, the union of the rows (ref:
    elemwise_binary_op_basic.cc)."""
    sp = _sp()
    data = torch.cat([lhs._data, rhs._data.to(device=lhs._data.device,
                                              dtype=lhs._data.dtype)])
    if lhs._indices_np is not None and rhs._indices_np is not None:
        ids = _np.concatenate([lhs._indices_np, rhs._indices_np])
    else:
        ids = torch.cat([lhs._indices, rhs._indices.to(lhs._indices.device)])
    return sp.segment_sum_rows(data, ids, lhs.shape)


@register_sparse("cast_storage", ("*",))
def _cast_storage_any(data, stype="default", **_):
    return _sp().cast_storage(data, stype)


@register_sparse("sum", ("csr",))
def _sum_csr(data, axis=None, keepdims=False, **_):
    """A sum over a csr without its dense form (ref: the sum / square_sum
    csr kernels)."""
    from ..ndarray import ndarray as _nd
    vals = data._data
    if isinstance(axis, tuple):
        norm = {a % 2 for a in axis}
        axis = None if norm == {0, 1} else norm.pop()
    if axis is None:
        # the row sums, then their sum, each in one fixed order (a tree
        # sum's order differs between the host and the card)
        rows = _segment_rows(vals.unsqueeze(1), data._row_lengths_dev())
        out = _segment_rows(rows, torch.tensor(
            [rows.shape[0]], device=rows.device))[0, 0]
        return _nd.NDArray(out.reshape(1, 1) if keepdims else out)
    if axis in (0, -2):
        g = _column_groups(data)
        out = vals.new_zeros((data.shape[1],))
        if vals.numel():
            out = out.index_copy(0, g.uniq_t, _segment_rows(
                vals.index_select(0, g.order).unsqueeze(1),
                g.lengths)[:, 0])
        keep = (1, data.shape[1])
    else:
        check(axis in (1, -1), "sum(csr): axis must be None, 0 or 1")
        out = _segment_rows(vals.unsqueeze(1), data._row_lengths_dev())[:, 0]
        keep = (data.shape[0], 1)
    return _nd.NDArray(out.reshape(keep) if keepdims else out)


# ---------------------------------------------------------------------------
# the row-sparse Embedding gradient
# ---------------------------------------------------------------------------

class _EmbeddingRows(torch.autograd.Function):
    """out = weight[ids]; dL/dweight is a sparse COO tensor holding
    ``dout`` as one row per id, repeats allowed (ref: indexing_op.cc
    SparseEmbeddingOpBackwardRspImpl), never the dense (vocab, dim) sum."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.wshape = weight.shape
        return weight.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + tuple(weight.shape[1:]))

    @staticmethod
    def backward(ctx, dout):
        ids, = ctx.saved_tensors
        rows = dout.reshape((-1,) + tuple(ctx.wshape[1:]))
        grad = torch.sparse_coo_tensor(ids.reshape(1, -1), rows, ctx.wshape,
                                       check_invariants=False)
        return grad, None


def embedding_rows(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows of ``weight`` at ``ids`` with a row-sparse gradient. Ids wrap
    from the end when negative and are clamped into range, as the dense
    Embedding's values are. Inside a program of fixed shapes (a
    hybridized block's run, ``cached_op.inline_scope``) the gradient is
    the dense one, as the JAX package's whole-graph backward gives it:
    an indexing whose backward is an accumulating ``index_put_``."""
    from ..cached_op import inlining
    n = weight.shape[0]
    idx = ids.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    if torch.is_grad_enabled() and weight.requires_grad:
        if inlining():
            return weight[idx]
        return _EmbeddingRows.apply(weight, idx)
    return weight.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(weight.shape[1:]))


# ---------------------------------------------------------------------------
# lazy (row-sliced) optimizer updates (ref: optimizer_op.cc row_sparse sgd
# / sgd_mom / adam): only the rows present in the gradient change
# ---------------------------------------------------------------------------

def step_rows(rule, tables, rows, grows, lr, wd, rescale_grad, **statics):
    """One lazy step of the rows ``rows`` (unique, int64, on the tables'
    device): gather them from ``tables`` (the weight, then its state
    tensors), step them by the multi-tensor ``rule`` of
    ``optimizer_ops`` (the dense update's own maths) with the gradient
    rows ``grows``, and return ``(old, new)``, each a list of row sets in
    the tables' order. Nothing is written: the caller puts ``new`` back
    with ``index_copy``."""
    old = [t.index_select(0, rows) for t in tables]
    nw, ns = rule([old[0]], [grows.to(old[0].dtype)],
                  [[o] for o in old[1:]], [lr], [wd], float(rescale_grad),
                  **statics)
    return old, [nw[0]] + [slot[0] for slot in ns]


def _sparse_update(rule, tables, gdata, gidx, lr, wd, rescale_grad,
                   **statics):
    """The registry ops' form of :func:`step_rows`: new full tables."""
    rows = gidx.to(torch.int64).reshape(-1)
    _, new = step_rows(rule, tables, rows, gdata, lr, wd, rescale_grad,
                       **statics)
    out = tuple(t.index_copy(0, rows, n.to(t.dtype))
                for t, n in zip(tables, new))
    return out if len(out) > 1 else out[0]


@register("_sparse_sgd_update")
def _sparse_sgd_update(weight, gdata, gidx, lr=0.01, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    return _sparse_update(_opt.sgd, (weight,), gdata, gidx, lr, wd,
                          rescale_grad, clip=clip_gradient)


@register("_sparse_sgd_mom_update", num_outputs=2)
def _sparse_sgd_mom_update(weight, gdata, gidx, mom, lr=0.01, momentum=0.0,
                           wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    return _sparse_update(_opt.sgd_mom, (weight, mom), gdata, gidx, lr, wd,
                          rescale_grad, momentum=momentum,
                          clip=clip_gradient)


@register("_sparse_adam_update", num_outputs=3)
def _sparse_adam_update(weight, gdata, gidx, mean, var, lr=0.01, beta1=0.9,
                        beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0):
    return _sparse_update(_opt.adam, (weight, mean, var), gdata, gidx, lr,
                          wd, rescale_grad, beta1=beta1, beta2=beta2,
                          epsilon=epsilon, clip=clip_gradient)
