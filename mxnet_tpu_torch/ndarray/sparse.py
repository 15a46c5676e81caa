"""Sparse NDArray storage: row_sparse and csr (ref: the JAX package's
``ndarray/sparse.py``; include/mxnet/ndarray.h kRowSparseStorage /
kCSRStorage and python/mxnet/ndarray/sparse.py in the reference).

The containers hold their compact arrays as tensors on the array's device:
a :class:`RowSparseNDArray` its ``(n, ...)`` row values and the ``(n,)``
row ids, a :class:`CSRNDArray` its ``(nnz,)`` values, column ids and row
pointers. The host copies of the coordinates are cached where they are
known (a csr's are given on the host; a row set deduplicated on the host
keeps its ids), so the kernels that need them concretely read no device
memory back. Ops follow the reference's storage discipline: an op with a
kernel for its input storage types (``ops/sparse_ops.py``, chosen by
``ops/registry.stype_dispatch``) keeps the rows compact; any other op
densifies its inputs, with a warning (``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``).

Every merge of rows with repeated ids goes through :func:`segment_sum`: a
stable sort by id, then ``torch.segment_reduce``, which adds each run of
equal ids in its original order. On the card an ``index_add_`` adds with
atomics in no fixed order; this sum is the same bits on every run.

``host_syncs`` counts the reads of device memory the sparse path makes
(a data-dependent row count is one): ``chip_smoke.py`` prints the count
of one sparse step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError, check, numpy_dtype, torch_dtype
from ..context import Context, current_context, resolve_device
from . import ndarray as _nd

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "zeros", "array", "dot", "add",
           "cast_storage", "sparse_retain", "retain", "getnnz",
           "segment_sum", "segment_sum_rows", "mask_pack", "mask_unpack",
           "host_syncs"]

#: device-to-host reads made by the sparse path (``"n"``), by site
host_syncs = {"n": 0}


def note_sync(what: str) -> None:
    host_syncs["n"] += 1
    host_syncs[what] = host_syncs.get(what, 0) + 1


def reset_host_syncs() -> None:
    host_syncs.clear()
    host_syncs["n"] = 0


def _host(t: torch.Tensor, what: str) -> _np.ndarray:
    """``t`` as a numpy array, counted as a sync when it lives on a card."""
    if t.is_cuda:
        note_sync(what)
    return t.detach().cpu().numpy()


def _tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor from an NDArray, tensor or numpy-like, on ``device``."""
    if isinstance(x, _nd.NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype)
    arr = _np.asarray(x)
    if dtype is None:
        # numpy's 64-bit defaults narrow as nd.array narrows them
        arr = arr.astype(_NARROW.get(arr.dtype, arr.dtype))
    t = torch.from_numpy(_np.array(arr, copy=True, order="C"))
    return t.to(device=device if device is not None else
                resolve_device(current_context()), dtype=dtype)


_NARROW = {_np.dtype("float64"): _np.dtype("float32"),
           _np.dtype("int64"): _np.dtype("int32")}


# ---------------------------------------------------------------------------
# the one row merge: deterministic segment sums
# ---------------------------------------------------------------------------

def segment_sum(data: torch.Tensor, ids) -> Tuple[torch.Tensor, torch.Tensor,
                                                  _np.ndarray]:
    """Sum the rows of ``data`` that share an id: ``(unique ids as an
    int64 tensor, their summed rows, unique ids on the host)``, ids in
    ascending order. ``ids`` is a numpy array (sorted on the host, no
    sync) or a tensor on ``data``'s device (sorted there; reading the
    number of unique ids back is one sync). Each id's rows are added in
    their order in ``data``, starting from zero, the same order on every
    run and every device."""
    dev = data.device
    n = int(data.shape[0])
    if n == 0:
        empty = torch.zeros((0,), dtype=torch.int64, device=dev)
        return empty, data.new_zeros((0,) + tuple(data.shape[1:])), \
            _np.zeros((0,), _np.int64)
    if isinstance(ids, torch.Tensor):
        sorted_ids, order = torch.sort(ids.to(dev, torch.int64), stable=True)
        uniq, counts = torch.unique_consecutive(sorted_ids,
                                                return_counts=True)
        if dev.type == "cuda":
            note_sync("unique_rows")
        uniq_np = None
    else:
        ids_np = _np.asarray(ids, _np.int64).reshape(-1)
        order_np = _np.argsort(ids_np, kind="stable")
        uniq_np, counts_np = _np.unique(ids_np[order_np], return_counts=True)
        order = torch.from_numpy(order_np).to(dev)
        uniq = torch.from_numpy(uniq_np).to(dev)
        counts = torch.from_numpy(counts_np).to(dev)
    flat = data.index_select(0, order).reshape(
        n, int(_np.prod(data.shape[1:])))
    out = torch.segment_reduce(flat, "sum", lengths=counts, axis=0,
                               unsafe=True)
    return uniq, out.reshape((int(uniq.shape[0]),) + tuple(data.shape[1:])), \
        uniq_np


class BaseSparseNDArray:
    """Shared surface of the two sparse containers."""

    _fresh_grad = False

    def __init__(self, shape):
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._shape

    @property
    def context(self) -> Context:
        return Context(self._data.device)

    ctx = context

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return int(_np.prod(self._shape))

    @property
    def ndim(self) -> int:
        return len(self._shape)

    def asnumpy(self) -> _np.ndarray:
        return self.todense().asnumpy()

    def wait_to_read(self) -> None:
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def as_in_context(self, context):
        if Context(context) == self.context:
            return self
        return self.copyto(context)

    as_in_ctx = as_in_context

    def __repr__(self):
        return (f"\n<{type(self).__name__} "
                f"{'x'.join(map(str, self._shape))} @{self.context}>")


class RowSparseNDArray(BaseSparseNDArray):
    """Rows ``indices`` of a ``shape`` array hold ``data``; every other row
    is zero (ref: python/mxnet/ndarray/sparse.py RowSparseNDArray)."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, ctx=None, indices_np=None):
        super().__init__(shape)
        dev = resolve_device(ctx) if ctx is not None else None
        self._data = _tensor(data, dev)
        self._indices = _tensor(indices, self._data.device, torch.int64)
        self._indices_np = None if indices_np is None else \
            _np.asarray(indices_np, _np.int64)

    def _update(self, data: torch.Tensor, indices: torch.Tensor,
                indices_np=None) -> None:
        self._data = data
        self._indices = indices.to(data.device, torch.int64)
        self._indices_np = None if indices_np is None else \
            _np.asarray(indices_np, _np.int64)

    def indices_host(self) -> _np.ndarray:
        """The row ids on the host (cached; a read-back the first time)."""
        if self._indices_np is None:
            self._indices_np = _host(self._indices, "rsp_indices").astype(
                _np.int64)
        return self._indices_np

    @property
    def data(self) -> _nd.NDArray:
        return _nd.NDArray(self._data)

    @property
    def indices(self) -> _nd.NDArray:
        return _nd.NDArray(self._indices.to(torch.int32))

    def astype(self, dtype, copy: bool = True) -> "RowSparseNDArray":
        return RowSparseNDArray(self._data.to(torch_dtype(dtype)),
                                self._indices, self._shape,
                                indices_np=self._indices_np)

    def todense(self) -> _nd.NDArray:
        """The dense array. Under ``autograd.record()`` it stays on the
        graph (the row values flow into it by an index copy)."""
        rec = autograd.is_recording() and self._data.requires_grad
        with torch.enable_grad() if rec else torch.no_grad():
            out = torch.zeros(self._shape, dtype=self._data.dtype,
                              device=self._data.device)
            out = out.index_copy(0, self._indices, self._data)
        return _nd.NDArray(out)

    def tostype(self, stype):
        if stype == "default":
            return self.todense()
        if stype == "row_sparse":
            return self
        raise MXNetError(f"cannot convert row_sparse to {stype}")

    def copyto(self, other):
        if isinstance(other, RowSparseNDArray):
            other._update(self._data.detach().to(other._data.device,
                                                 copy=True),
                          self._indices, self._indices_np)
            return other
        if isinstance(other, _nd.NDArray):
            return self.todense().copyto(other)
        dev = resolve_device(other)
        return RowSparseNDArray(self._data.detach().to(dev, copy=True),
                                self._indices.to(dev), self._shape,
                                indices_np=self._indices_np)

    def copy(self):
        return self.copyto(self.context)

    def retain(self, row_ids) -> "RowSparseNDArray":
        """Keep only the listed rows (ref: sparse_retain): the requested
        rows are found among the stored ones by a search on the host, so
        memory stays ``len(row_ids) x dim``. A requested row that is not
        stored comes back as zeros."""
        rid = row_ids._data if isinstance(row_ids, _nd.NDArray) else row_ids
        rid_np = _host(rid, "retain_ids") if isinstance(rid, torch.Tensor) \
            else _np.asarray(rid)
        rid_np = rid_np.astype(_np.int64).reshape(-1)
        stored = self.indices_host()
        dev = self._data.device
        tail = tuple(self._shape[1:])
        if not len(stored):
            rows = torch.zeros((len(rid_np),) + tail, dtype=self._data.dtype,
                               device=dev)
        else:
            order = _np.argsort(stored, kind="stable")
            pos = _np.clip(_np.searchsorted(stored[order], rid_np), 0,
                           len(stored) - 1)
            present = stored[order][pos] == rid_np
            gather = torch.from_numpy(order[pos]).to(dev)
            rows = self._data.index_select(0, gather)
            mask = torch.from_numpy(present).to(dev).reshape(
                (-1,) + (1,) * len(tail))
            rows = torch.where(mask, rows, torch.zeros_like(rows))
        return RowSparseNDArray(rows, torch.from_numpy(rid_np).to(dev),
                                self._shape, indices_np=rid_np)

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            return add(self, other)
        return self.todense() + other


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows (ref: python/mxnet/ndarray/sparse.py
    CSRNDArray). The coordinates are kept on the host as well
    (``_indices_np`` / ``_indptr_np``): the kernels need them concretely
    (row ids, the set of touched columns), and reading them back from the
    card every batch would stall the training step."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        super().__init__(shape)
        dev = resolve_device(ctx) if ctx is not None else None
        self._data = _tensor(data, dev)
        conv = (lambda a: _host(a._data if isinstance(a, _nd.NDArray) else a,
                                "csr_coords")
                if isinstance(a, (torch.Tensor, _nd.NDArray)) else a)
        self._indices_np = _np.asarray(conv(indices), _np.int32).reshape(-1)
        self._indptr_np = _np.asarray(conv(indptr), _np.int32).reshape(-1)
        d = self._data.device
        self._indices = torch.from_numpy(
            self._indices_np.astype(_np.int64)).to(d)
        self._indptr = torch.from_numpy(
            self._indptr_np.astype(_np.int64)).to(d)
        self._row_ids_np = None
        self._row_ids_t = None
        self._lengths_t = None

    def _row_ids(self) -> _np.ndarray:
        """The row id of every stored value (nnz,), on the host, cached."""
        if self._row_ids_np is None:
            self._row_ids_np = _np.repeat(
                _np.arange(len(self._indptr_np) - 1, dtype=_np.int64),
                _np.diff(self._indptr_np))
        return self._row_ids_np

    def _row_ids_dev(self) -> torch.Tensor:
        if self._row_ids_t is None:
            self._row_ids_t = torch.from_numpy(self._row_ids()).to(
                self._data.device)
        return self._row_ids_t

    def _row_lengths_dev(self) -> torch.Tensor:
        """Stored values a row (rows,), on the device, cached."""
        if self._lengths_t is None:
            self._lengths_t = torch.from_numpy(
                _np.diff(self._indptr_np).astype(_np.int64)).to(
                self._data.device)
        return self._lengths_t

    @property
    def data(self) -> _nd.NDArray:
        return _nd.NDArray(self._data)

    @property
    def indices(self) -> _nd.NDArray:
        return _nd.NDArray(self._indices.to(torch.int32))

    @property
    def indptr(self) -> _nd.NDArray:
        return _nd.NDArray(self._indptr.to(torch.int32))

    def astype(self, dtype, copy: bool = True) -> "CSRNDArray":
        return CSRNDArray(self._data.to(torch_dtype(dtype)), self._indices_np,
                          self._indptr_np, self._shape)

    def todense(self) -> _nd.NDArray:
        rows, cols = self._shape
        out = torch.zeros((rows, cols), dtype=self._data.dtype,
                          device=self._data.device)
        if self._data.shape[0]:
            out[self._row_ids_dev(), self._indices] = self._data
        return _nd.NDArray(out)

    def tostype(self, stype):
        if stype == "default":
            return self.todense()
        if stype == "csr":
            return self
        raise MXNetError(f"cannot convert csr to {stype}")

    def copyto(self, other):
        if isinstance(other, _nd.NDArray):
            return self.todense().copyto(other)
        return CSRNDArray(self._data.detach().to(resolve_device(other),
                                                 copy=True),
                          self._indices_np, self._indptr_np, self._shape)

    def copy(self):
        return self.copyto(self.context)

    def __getitem__(self, idx):
        return self.todense()[idx]


# ---------------------------------------------------------------------------
# conversions and constructors
# ---------------------------------------------------------------------------

def _dense_to_row_sparse(np_d: _np.ndarray, ctx=None) -> RowSparseNDArray:
    nz = _np.where(_np.any(np_d != 0, axis=tuple(range(1, np_d.ndim))))[0]
    return RowSparseNDArray(np_d[nz], nz.astype(_np.int64), np_d.shape,
                            ctx=ctx, indices_np=nz)


def _dense_to_csr(dense: _np.ndarray, ctx=None) -> CSRNDArray:
    """(ref: cast_storage-inl.h CastStorageDnsCsrImpl)"""
    check(dense.ndim == 2, "csr requires 2-D input")
    rows, cols = _np.nonzero(dense)
    indptr = _np.concatenate(
        ([0], _np.cumsum(_np.bincount(rows, minlength=dense.shape[0]))))
    return CSRNDArray(dense[rows, cols], cols.astype(_np.int32),
                      indptr.astype(_np.int32), dense.shape, ctx=ctx)


def _ctx_of(x):
    return x.context if isinstance(x, (_nd.NDArray, BaseSparseNDArray)) \
        else None


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """(ref: mx.nd.sparse.row_sparse_array) from ``(data, indices)`` and
    ``shape``, or from a dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        check(shape is not None, "shape required")
        d = _nd.array(data, ctx=ctx if ctx is not None else _ctx_of(data),
                      dtype=dtype)._data
        idx = indices if isinstance(indices, (torch.Tensor, _nd.NDArray)) \
            else _np.asarray(indices, _np.int64)
        return RowSparseNDArray(d, idx, shape,
                                indices_np=None if isinstance(
                                    idx, (torch.Tensor, _nd.NDArray))
                                else idx)
    src = _np.asarray(arg1.asnumpy() if isinstance(arg1, _nd.NDArray)
                      else arg1)
    src = src.astype(_np.dtype(dtype) if dtype is not None
                     else _NARROW.get(src.dtype, src.dtype))
    return _dense_to_row_sparse(src, ctx if ctx is not None
                                else _ctx_of(arg1))


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """(ref: mx.nd.sparse.csr_matrix) from ``(data, indices, indptr)`` and
    ``shape``, or from a dense 2-D array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        check(shape is not None, "shape required")
        d = _nd.array(data, ctx=ctx if ctx is not None else _ctx_of(data),
                      dtype=dtype)._data
        return CSRNDArray(d, indices, indptr, shape)
    src = arg1.asnumpy() if isinstance(arg1, _nd.NDArray) else arg1
    return _dense_to_csr(_np.asarray(src, dtype=dtype or _np.float32),
                         ctx if ctx is not None else _ctx_of(arg1))


def zeros(stype, shape, ctx=None, dtype=None):
    dt = torch_dtype(dtype if dtype is not None else "float32")
    dev = resolve_device(ctx if ctx is not None else current_context())
    shape = tuple(shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int64, device=dev), shape,
            indices_np=_np.zeros((0,), _np.int64))
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          _np.zeros((0,), _np.int32),
                          _np.zeros((shape[0] + 1,), _np.int32), shape)
    return _nd.zeros(shape, ctx=ctx, dtype=dt)


def array(source, ctx=None, dtype=None):
    if isinstance(source, BaseSparseNDArray):
        return source
    return _nd.array(source, ctx=ctx, dtype=dtype)


def cast_storage(data, stype="default"):
    """Between dense, row_sparse and csr (ref: cast_storage.cc); sparse to
    the other sparse goes through dense."""
    if isinstance(data, BaseSparseNDArray):
        if stype == "default":
            return data.todense()
        if stype == data.stype:
            return data
        data = data.todense()
    if stype == "default":
        return data
    ctx = getattr(data, "context", None)
    arr = _np.asarray(data.asnumpy() if hasattr(data, "asnumpy") else data)
    if stype == "row_sparse":
        return _dense_to_row_sparse(arr, ctx)
    if stype == "csr":
        return _dense_to_csr(arr, ctx)
    raise MXNetError(f"unknown stype {stype!r}")


def sparse_retain(data, indices):
    """(ref: sparse_retain.cc) the listed rows of a row_sparse array."""
    check(isinstance(data, RowSparseNDArray),
          "sparse_retain requires a row_sparse input")
    return data.retain(indices)


retain = sparse_retain


def segment_sum_rows(data, indices, shape, ctx=None) -> RowSparseNDArray:
    """``(data, row ids with repeats)`` as a compact RowSparseNDArray:
    unique rows, repeats summed (ref: CommCPU::ReduceRowSparse). The one
    row merge of gradient delivery, the kvstore reduce and rsp + rsp."""
    if isinstance(data, _nd.NDArray):
        data = data._data
    uniq, summed, uniq_np = segment_sum(data, indices)
    return RowSparseNDArray(summed, uniq, shape, indices_np=uniq_np)


def mask_pack(rsp: RowSparseNDArray) -> _nd.NDArray:
    """``[flat rows | row mask]`` as one dense ``(rows, width + 1)`` array
    for a dense cross-process sum. The mask column survives the sum, so a
    row whose summed gradient is exactly zero stays in the row set (the
    reference applies lazy wd / momentum to every pushed row)."""
    rows = rsp._shape[0]
    flat = rsp._data.reshape(rsp._data.shape[0], -1)
    out = torch.zeros((rows, flat.shape[1] + 1), dtype=flat.dtype,
                      device=flat.device)
    if flat.shape[0]:
        out[rsp._indices, :-1] = flat
        out[rsp._indices, -1] = 1.0
    return _nd.NDArray(out)


def mask_unpack(packed: _nd.NDArray, shape, ctx=None) -> RowSparseNDArray:
    """The inverse of :func:`mask_pack` after the sum: the rows whose mask
    is positive (the union of every worker's rows). Reading the mask back
    is one sync."""
    arr = packed._data
    mask = arr[:, -1] > 0
    rows = _np.where(_host(mask, "mask_unpack"))[0].astype(_np.int64)
    idx = torch.from_numpy(rows).to(arr.device)
    data = arr.index_select(0, idx)[:, :-1].reshape(
        (len(rows),) + tuple(shape[1:]))
    return RowSparseNDArray(data, idx, shape, indices_np=rows)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Storage-aware dot (ref: mx.nd.sparse.dot): csr x dense is the
    gather / multiply / segment-sum kernel, csr^T x dense returns
    row_sparse, dense x dense is ``nd.dot``."""
    from .. import ndarray as _ndpkg
    return _ndpkg.dot(lhs, rhs, transpose_a=transpose_a,
                      transpose_b=transpose_b)


def add(lhs, rhs):
    """row_sparse + row_sparse -> row_sparse (the union of the rows)."""
    from .. import ndarray as _ndpkg
    return _ndpkg.elemwise_add(lhs, rhs)


def getnnz(data, axis=None):
    """Stored values of a csr matrix (ref: contrib/nnz.cc): all of them,
    per row (``axis=1``) or per column (``axis=0``, which the reference
    lacks)."""
    check(isinstance(data, CSRNDArray), "getnnz requires a csr input")
    ctx = data.context
    if axis is None:
        return _nd.array(_np.asarray(int(data._data.shape[0]), _np.int64),
                         ctx=ctx)
    if axis == 1:
        ptr = data._indptr_np.astype(_np.int64)
        return _nd.array(ptr[1:] - ptr[:-1], ctx=ctx)
    check(axis == 0, "getnnz: axis must be None, 0 or 1")
    counts = _np.bincount(data._indices_np.astype(_np.int64),
                          minlength=data.shape[1])
    return _nd.array(counts.astype(_np.int64), ctx=ctx)
