"""Data iterators (ref: python/mxnet/io.py DataIter:178, NDArrayIter,
PrefetchingIter:345, ResizeIter; the JAX package's ``io/io.py``).

Host pipelines build numpy batches. ``NDArrayIter`` hands them out as
NDArrays on the current context (the card unless ``with mx.cpu():``);
``DeviceStagingIter`` (``staging.py``) takes the numpy batches themselves
(``NDArrayIter._next_host``) and copies them to the card ahead of use.
Batches keep static shapes (pad / discard). The seeded order is the JAX
package's: ``np.random.RandomState(seed + epoch).permutation``, so both
packages serve the same batches in the same order.

``MNISTIter`` reads the idx files as the JAX iterator does; the record
iterators are ``image_record.py``'s.
"""
from __future__ import annotations

import collections
import gzip
import os
import struct
import threading
import queue as _queue
from typing import Optional

import numpy as _np

from ..base import MXNetError, check
from ..context import current_context
from ..ndarray import ndarray as _nd

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ResizeIter", "PrefetchingIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape", "dtype",
                                                   "layout"])):
    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """(ref: python/mxnet/io.py DataBatch)"""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [d.shape for d in self.data] if self.data else []
        return f"DataBatch: data shapes {shapes} pad {self.pad}"


class DataIter:
    """(ref: python/mxnet/io.py DataIter:178)"""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    """Normalize input data to list of (name, numpy array)
    (ref: python/mxnet/io.py _init_data)."""
    if data is None:
        check(allow_empty, "data cannot be None")
        return []
    if isinstance(data, (_np.ndarray, _nd.NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty:
            check(len(data) > 0, "empty data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError("data must be array, list or dict of arrays")
    out = []
    for k, v in data.items():
        if isinstance(v, _nd.NDArray):
            v = v.asnumpy()
        out.append((k, _np.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """In-memory iterator (ref: python/mxnet/io.py NDArrayIter).

    ``num_parts``/``part_index`` shard the stream across a worker group
    (the reference's ImageRecordIter partition knobs): with ``P`` parts,
    rank ``r``'s local batch ``t`` is GLOBAL batch ``t*P + r`` of the one
    seeded (seed, epoch) order, so the union of all ranks' streams is
    exactly the unsharded stream — the invariant elastic resume
    (``parallel/elastic.py``) re-splits across a new rank count. Sharded
    epochs keep every rank's batch count equal by discarding the ragged
    tail that cannot fill a whole ``P``-batch group."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None,
                 num_parts=1, part_index=0):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        check(num_parts >= 1, "num_parts must be >= 1")
        check(0 <= part_index < num_parts,
              f"part_index {part_index} outside [0, {num_parts})")
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        # seed makes the shuffle order a pure function of (seed, epoch):
        # a killed-and-resumed run (fit.FitLoop) replays the exact batch
        # sequence instead of reshuffling from the global RNG's new state
        self._seed = seed
        self._epoch = 0
        self._order = _np.arange(self.num_data)
        if shuffle:
            if seed is not None:
                self._order = _np.random.RandomState(seed).permutation(
                    self.num_data)
            else:
                _np.random.shuffle(self._order)
        if self.num_parts > 1:
            # whole global groups only: every rank sees the same local
            # count (a collective step loop must never desync on data)
            self.num_batches = self.num_data // (batch_size * self.num_parts)
        elif last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         v.dtype) for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        self._epoch += 1
        if self.shuffle:
            if self._seed is not None:
                self._order = _np.random.RandomState(
                    self._seed + self._epoch).permutation(self.num_data)
            else:
                _np.random.shuffle(self._order)

    def set_epoch(self, epoch):
        """Deterministically position the iterator at the start of
        ``epoch``: with a seed the order depends only on (seed, epoch), so
        a resumed run (fit.FitLoop fast-forward) replays the original
        batch sequence no matter how many resets already happened."""
        check(not self.shuffle or self._seed is not None,
              "set_epoch with shuffle=True needs NDArrayIter(seed=...) — "
              "an unseeded shuffle cannot be replayed after a restart")
        self._epoch = int(epoch)
        self.cursor = -self.batch_size
        if self.shuffle:
            self._order = _np.random.RandomState(
                self._seed + self._epoch).permutation(self.num_data)

    def set_position(self, epoch, global_samples):
        """Deterministically position THIS shard at the global sample
        offset ``global_samples`` of ``epoch``'s seeded order — the
        elastic-resume fast-forward: a run killed at world N re-splits
        its recorded global position across M new ranks, each landing on
        its own slice with no overlap and no gap. The offset must fall
        on a global batch-group boundary (``num_parts * batch_size``)."""
        stride = self.num_parts * self.batch_size
        check(int(global_samples) % stride == 0,
              f"set_position: global sample offset {global_samples} is "
              f"not a multiple of num_parts*batch_size = {stride} — a "
              "mid-group position cannot be split without duplicating "
              "or dropping samples")
        self.set_epoch(epoch)
        self.cursor += (int(global_samples) // stride) * self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.num_parts > 1:
            # local batch t is valid only while its WHOLE global group
            # [t*P, (t+1)*P) of batches fits — the ragged tail is
            # discarded uniformly so every rank steps the same count
            t = self.cursor // self.batch_size
            return (t + 1) * self.num_parts * self.batch_size \
                <= self.num_data
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        return [_nd.array(part, dtype=part.dtype)
                for part in self._slice_host(arrays)]

    def _slice_host(self, arrays):
        start = self.cursor
        if self.num_parts > 1:
            # global batch index of this shard's local batch t
            t = self.cursor // self.batch_size
            start = (t * self.num_parts + self.part_index) * self.batch_size
        out = []
        for k, v in arrays:
            idx = self._order[start:start + self.batch_size]
            part = v[idx]
            if part.shape[0] < self.batch_size:  # pad with wraparound
                extra = self.batch_size - part.shape[0]
                pad_idx = self._order[:extra]
                part = _np.concatenate([part, v[pad_idx]], axis=0)
            out.append(part)
        return out

    def _next_host(self) -> DataBatch:
        """The next batch as numpy arrays (what ``DeviceStagingIter``
        copies to the card); the same position rules as :meth:`next`."""
        if self.iter_next():
            return DataBatch(self._slice_host(self.data),
                             self._slice_host(self.label),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        if self.num_parts > 1:
            return 0  # sharded epochs discard the ragged tail, never pad
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class CSVIter(DataIter):
    """CSV reader (ref: src/io/iter_csv.cc:218)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32", **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",",
                           dtype=_np.dtype(dtype), ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",",
                                dtype=_np.float32, ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = _np.zeros((data.shape[0], 1), dtype=_np.float32)
        self._inner = NDArrayIter(data, label, batch_size,
                                  last_batch_handle="pad")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class MNISTIter(DataIter):
    """MNIST idx-format reader (ref: src/io/iter_mnist.cc:260): the idx
    files, plain or ``.gz``, scaled to [0, 1]; ``flat`` gives (N, 784)
    instead of (N, 1, 28, 28); ``shuffle`` permutes once with
    ``np.random.RandomState(seed)``, as the JAX iterator; the last partial
    batch is discarded."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0, **kwargs):
        super().__init__(batch_size)
        with _open_idx(image) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            check(magic == 2051, "bad idx image magic")
            imgs = _np.frombuffer(f.read(), dtype=_np.uint8)
            imgs = imgs.reshape(n, rows, cols).astype(_np.float32) / 255.0
        with _open_idx(label) as f:
            magic, _ = struct.unpack(">II", f.read(8))
            check(magic == 2049, "bad idx label magic")
            labels = _np.frombuffer(f.read(), dtype=_np.uint8) \
                .astype(_np.float32)
        imgs = imgs.reshape((n, rows * cols) if flat else (n, 1, rows, cols))
        if shuffle:
            order = _np.random.RandomState(seed).permutation(n)
            imgs, labels = imgs[order], labels[order]
        self._inner = NDArrayIter(imgs, labels, batch_size,
                                  last_batch_handle="discard",
                                  label_name="softmax_label")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


def _open_idx(path):
    """``path``, else ``path.gz``."""
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise MXNetError(f"MNIST file not found: {path}")


class ResizeIter(DataIter):
    """Truncate/extend an iterator to a fixed number of batches
    (ref: python/mxnet/io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration


#: how long reset() waits for the old worker before relying on the iter
#: lock to fence it off (patchable in tests)
_PREFETCH_JOIN_TIMEOUT_S = 5


class PrefetchingIter(DataIter):
    """Double-buffering thread over one or more iterators
    (ref: python/mxnet/io.py PrefetchingIter:345; the C++ analog is
    src/io/iter_prefetcher.h). The worker thread runs in the context of
    the thread that built the iterator."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth: int = 2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._depth = int(prefetch_depth)
        self._queue: _queue.Queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._error: Optional[Exception] = None  # sticky until reset()
        self._done = False                       # sticky until reset()
        # serializes underlying-iterator access across worker generations:
        # a worker that outlives reset()'s join timeout must not consume
        # from (or race it.reset() on) the shared base iterators
        self._iter_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # the worker builds batches in the creating thread's context
        # (contexts are per thread; the default is the card)
        self._ctx = current_context()
        self._start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(self.rename_data[i].get(d.name, d.name),
                              d.shape, d.dtype)
                     for d in it.provide_data]
                    for i, it in enumerate(self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(self.rename_label[i].get(d.name, d.name),
                              d.shape, d.dtype)
                     for d in it.provide_label]
                    for i, it in enumerate(self.iters)], [])

    def _start(self):
        # the worker closes over THIS generation's queue/stop, not
        # self.<attr>: a worker that outlives reset()'s join timeout
        # (blocked in a slow it.next()) must publish its stale batch into
        # the abandoned queue, never the new epoch's
        queue = self._queue
        stop = self._stop

        def put(item) -> bool:
            """Bounded put that stays responsive to reset(): a full queue
            abandoned by the consumer must not wedge the worker (and
            therefore reset's join) forever."""
            while not stop.is_set():
                try:
                    queue.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def worker():
            with self._ctx:
                run()

        def run():
            try:
                while not stop.is_set():
                    batches = []
                    try:
                        with self._iter_lock:
                            if stop.is_set():
                                # reset() won the lock first and already
                                # rewound the base iterators — this
                                # generation must not consume from them
                                return
                            for it in self.iters:
                                batches.append(it.next())
                    except StopIteration:
                        put(None)
                        return
                    data = sum([b.data for b in batches], [])
                    label = sum([(b.label or []) for b in batches], [])
                    merged = DataBatch(data, label, pad=batches[0].pad,
                                       index=batches[0].index)
                    if not put(merged):
                        return
            except Exception as e:  # surface errors at next()
                put(e)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=_PREFETCH_JOIN_TIMEOUT_S)
        # even if the old worker outlived the join (blocked in a slow
        # it.next()), the iter lock waits out its one in-flight call, so
        # the rewind below cannot interleave with it and the new epoch
        # cannot lose a batch to the zombie
        with self._iter_lock:
            for it in self.iters:
                it.reset()
        self._stop = threading.Event()
        self._error = None
        self._done = False
        self._queue = _queue.Queue(maxsize=self._depth)
        self._start()

    def next(self):
        if self._error is not None:
            # the worker is dead; every subsequent next() must keep
            # surfacing the failure, not block on a queue nobody fills
            raise self._error
        if self._done:
            # exhaustion is sticky too: the worker exited after its one
            # None sentinel, so another get() would block forever
            raise StopIteration
        item = self._queue.get()
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._error = item
            raise item
        return item

    def iter_next(self):
        try:
            self._peek = self.next()
            return True
        except StopIteration:
            return False
