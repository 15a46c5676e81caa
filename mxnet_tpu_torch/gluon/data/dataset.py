"""Gluon datasets (ref: python/mxnet/gluon/data/dataset.py; the JAX
package's ``gluon/data/dataset.py``)."""
from __future__ import annotations

import os
import threading

from ...base import check

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy: bool = True) -> "Dataset":
        """``fn(*item)`` on every item, when it is read (``lazy``) or
        now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy: bool = True) -> "Dataset":
        """``fn`` on the first element of every item (the data, not the
        label)."""
        return self.transform(_TransformFirstClosure(fn), lazy)

    def filter(self, fn) -> "Dataset":
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count) -> "Dataset":
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Arrays of one length, read together: an item is a tuple of their
    elements (the element itself for one array)."""

    def __init__(self, *args):
        check(len(args) > 0, "need at least one array")
        self._length = len(args[0])
        self._data = []
        for a in args:
            check(len(a) == self._length, "arrays must have equal length")
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """The records of a ``.rec`` file by position, through its ``.idx``
    sidecar. Safe under the DataLoader's workers: a forked process
    reopens the file (an inherited descriptor shares its offset with the
    parent and the other workers), and threads read under a lock."""

    def __init__(self, filename: str):
        self._filename = filename
        self._idx_file = os.path.splitext(filename)[0] + ".idx"
        self._lock = threading.Lock()
        self._open()

    def _open(self):
        from ...recordio import MXIndexedRecordIO
        self._pid = os.getpid()
        self._record = MXIndexedRecordIO(self._idx_file, self._filename, "r")

    def __getitem__(self, idx):
        if self._pid != os.getpid():    # a forked worker: its own handle
            self._lock = threading.Lock()
            self._open()
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
