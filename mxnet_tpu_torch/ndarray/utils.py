"""NDArray save/load and DLPack (ref: the JAX package's
``ndarray/utils.py``; mx.nd.save / mx.nd.load in the reference).

The file format is the JAX package's, so an array saved by one package
loads in the other: a numpy ``.npz`` whose keys are ``idx:name`` (list
order and dict names both kept); a bfloat16 array is stored as its exact
float32 widening under the key ``idx:__bf16__:name`` and cast back on
load. A sparse array is stored as its parts under the keys
``idx:name__csr__:~data`` / ``~indices`` / ``~indptr`` / ``~shape`` (``__rsp__``
for row_sparse; ``~data~bf16`` for bfloat16 values), with int32 indices,
as the JAX package writes them.
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as _np
import torch

from ..base import MXNetError
from . import ndarray as _nd

_BF16_PREFIX = "__bf16__:"
_CSR_MARK = "__csr__:"
_RSP_MARK = "__rsp__:"
_SPARSE_MARKS = (_CSR_MARK, _RSP_MARK)


def _sparse_payload(prefix: str, v, payload: dict) -> None:
    from . import sparse as _sp
    bf16 = v._data.dtype == torch.bfloat16
    csr = isinstance(v, _sp.CSRNDArray)
    mark = _CSR_MARK if csr else _RSP_MARK
    payload[f"{prefix}{mark}~data" + ("~bf16" if bf16 else "")] = \
        v.data.asnumpy()
    if csr:
        payload[f"{prefix}{mark}~indices"] = v._indices_np.astype(_np.int32)
        payload[f"{prefix}{mark}~indptr"] = v._indptr_np.astype(_np.int32)
    else:
        payload[f"{prefix}{mark}~indices"] = \
            v.indices_host().astype(_np.int32)
    payload[f"{prefix}{mark}~shape"] = _np.asarray(v.shape, _np.int64)


def _entry(i, k, v, payload):
    from . import sparse as _sp
    if any(m in k for m in _SPARSE_MARKS):
        raise MXNetError(
            f"array name {k!r} contains a reserved storage marker")
    if isinstance(v, _sp.BaseSparseNDArray):
        _sparse_payload(f"{i}:{k}", v, payload)
        return
    if not isinstance(v, _nd.NDArray):
        raise MXNetError("save expects NDArray values")
    bf16 = v._data.dtype == torch.bfloat16
    payload[f"{i}:{_BF16_PREFIX if bf16 else ''}{k}"] = v.asnumpy()


def save(fname: str, data) -> None:
    """Save an NDArray, a list of them or a dict of name -> NDArray."""
    if isinstance(data, _nd.NDArray):
        data = [data]
    payload = {}
    if isinstance(data, dict):
        for i, (k, v) in enumerate(data.items()):
            _entry(i, k, v, payload)
    elif isinstance(data, (list, tuple)):
        for i, v in enumerate(data):
            _entry(i, "", v, payload)
    else:
        raise MXNetError("save expects NDArray, list or dict")
    with open(fname, "wb") as f:
        _np.savez(f, **payload)


def load(fname: str, ctx=None) -> Union[List, Dict]:
    """Load what :func:`save` wrote (either package's), onto ``ctx`` (the
    current context by default)."""
    from . import sparse as _sp
    entries = []
    sparse_parts: Dict[tuple, Dict[str, _np.ndarray]] = {}
    with _np.load(fname, allow_pickle=False) as z:
        for key in z.files:
            idx_s, _, name = key.partition(":")
            mark = next((m for m in _SPARSE_MARKS if m in name), None)
            if mark is not None:
                base, _, part = name.partition(mark)
                sparse_parts.setdefault(
                    (int(idx_s), base, mark), {})[part.lstrip("~")] = z[key]
                continue
            arr = z[key]
            if name.startswith(_BF16_PREFIX):
                name = name[len(_BF16_PREFIX):]
                nd = _nd.array(arr, ctx=ctx, dtype=torch.bfloat16)
            else:
                nd = _nd.array(arr, ctx=ctx, dtype=arr.dtype)
            entries.append((int(idx_s), name, nd))
    for (idx, base, mark), parts in sparse_parts.items():
        shape = tuple(int(x) for x in parts["shape"])
        bf16 = "data" not in parts
        data = parts["data~bf16"] if bf16 else parts["data"]
        vals = _nd.array(data, ctx=ctx, dtype=torch.bfloat16 if bf16
                         else data.dtype)
        if mark == _CSR_MARK:
            nd = _sp.CSRNDArray(vals, parts["indices"], parts["indptr"],
                                shape)
        else:
            ids = parts["indices"].astype(_np.int64)
            nd = _sp.RowSparseNDArray(vals, ids, shape, indices_np=ids)
        entries.append((idx, base, nd))
    entries.sort(key=lambda e: e[0])
    if any(name for _, name, _ in entries):
        return {name: nd for _, name, nd in entries}
    return [nd for _, _, nd in entries]


def from_dlpack(ext_tensor) -> _nd.NDArray:
    """An NDArray over any DLPack-exporting tensor, sharing its memory
    (ref: MXNDArrayFromDLPackEx)."""
    return _nd.NDArray(torch.from_dlpack(ext_tensor))


def to_dlpack_for_read(arr):
    """DLPack capsule of ``arr`` (ref: MXNDArrayToDLPackForRead)."""
    return arr.to_dlpack_for_read()


def to_dlpack_for_write(arr):
    """DLPack capsule of ``arr``; writes through it change the array (ref:
    MXNDArrayToDLPackForWrite)."""
    return arr.to_dlpack_for_write()
