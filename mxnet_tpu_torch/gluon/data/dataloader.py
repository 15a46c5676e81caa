"""DataLoader (ref: python/mxnet/gluon/data/dataloader.py:595; the JAX
package's ``gluon/data/dataloader.py``).

Three modes, chosen as the JAX loader chooses them:

- ``num_workers == 0``: serial, in the caller's thread;
- ``thread_pool=True``, or a custom ``batchify_fn`` that cannot be
  pickled (with a warning): threads, each running under the caller's
  context;
- otherwise forked worker processes. A custom ``batchify_fn`` crosses
  the fork as a pickle, so the child builds fresh objects rather than
  aliasing the parent's closure.

Where the work runs. Batches come out as NDArrays on the caller's current
context (the card unless it says ``with mx.cpu():``). In the serial and
thread modes the dataset and the batchify run on that context, as in the
JAX package. A forked worker must never touch CUDA: the parent has
usually initialised it, and a child that makes a CUDA tensor dies ("Cannot
re-initialize CUDA in forked subprocess"). So each worker sets its
context to ``mx.cpu()`` and ``torch.set_num_threads(1)`` when it starts,
batchifies to numpy, and the parent moves the batch to the card. Forked
workers inherit the parent's Python, numpy and torch generator states
(as the JAX package's workers inherit its key stream): two workers draw
the same random numbers for their n-th sample. Nothing here reseeds them.

Transport: POSIX shared memory (``multiprocessing.shared_memory``), one
segment per array, written by the worker and unlinked by the parent once
read. Not ``torch.multiprocessing`` tensors: the parent copies every
batch once anyway (into a pinned buffer or onto the card), so shared
storage would save no copy, and explicit segments let the parent free
every batch it did not take when the consumer stops early (no segment
outlives an early ``break``).

``pin_memory=True``: each batch from the workers goes through
``io.staging.PinnedStager``, a pool of page-locked host buffers and a
non-blocking copy on a side stream, the consumer's stream waiting on the
copy's event (``DeviceStagingIter``'s design). It needs a card unless the
context is ``mx.cpu()``, where it is a plain copy; without a card and
with a card context it raises. The serial and thread modes make their
batches on the context directly.
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing as _mp
import pickle
import queue as _queue
import time
import traceback
import warnings

import numpy as np
import torch

from ...base import MXNetError, check
from ...context import Context, cpu, current_context, resolve_device
from ...ndarray import ndarray as _nd
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]

# seconds between checks for dead workers while waiting for a batch
_POLL_S = 1.0


def _host_dtype(arr):
    """The JAX package's array dtype rule: float64 -> float32, int64 ->
    int32."""
    return {np.dtype("float64"): np.float32,
            np.dtype("int64"): np.int32}.get(arr.dtype, arr.dtype)


def default_batchify_fn(data):
    """Stack samples into a batch on the current context."""
    if isinstance(data[0], _nd.NDArray):
        return _nd.stack(*data, axis=0)
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(x)) for x in zip(*data))
    arr = np.asarray(data)
    return _nd.array(arr, dtype=_host_dtype(arr))


def _np_batchify(data):
    """The worker's batchify: numpy only."""
    if isinstance(data[0], tuple):
        return tuple(_np_batchify(list(x)) for x in zip(*data))
    arr = np.stack([np.asarray(d) for d in data]) if \
        getattr(data[0], "ndim", 0) else np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


def _tree_to_shm(tree):
    """A tree of arrays -> shared-memory segment descriptors."""
    from multiprocessing import resource_tracker, shared_memory
    if isinstance(tree, tuple):
        return tuple(_tree_to_shm(t) for t in tree)
    if isinstance(tree, _nd.NDArray):      # a custom batchify's NDArray
        tree = tree.asnumpy()
    arr = np.ascontiguousarray(tree)
    shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    if arr.nbytes:
        np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
    desc = ("__shm__", shm.name, arr.shape, arr.dtype.str)
    # the parent owns the segment from here (it unlinks it): keep this
    # process's resource tracker from unlinking it again at exit
    resource_tracker.unregister(shm._name, "shared_memory")
    shm.close()
    return desc


def _is_leaf(desc) -> bool:
    return isinstance(desc, tuple) and bool(desc) and desc[0] == "__shm__"


def _unlink_tree(desc):
    """Free the segments of a batch nobody will read."""
    from multiprocessing import shared_memory
    if not _is_leaf(desc):
        for d in desc:
            _unlink_tree(d)
        return
    try:
        shm = shared_memory.SharedMemory(name=desc[1])
    except FileNotFoundError:
        return
    shm.close()
    shm.unlink()


def _tree_from_shm(desc, ctx, stager, bufs):
    """Read (and unlink) the segments of a batch: NDArrays on ``ctx``,
    through ``stager``'s pinned buffers when it is given."""
    from multiprocessing import shared_memory
    if not _is_leaf(desc):
        return tuple(_tree_from_shm(d, ctx, stager, bufs) for d in desc)
    _, name, shape, dtype = desc
    shm = shared_memory.SharedMemory(name=name)
    try:
        n = int(np.prod(shape)) if shape else 1
        view = np.frombuffer(shm.buf, dtype=np.dtype(dtype),
                             count=n).reshape(shape)
        host = view.astype(_host_dtype(view))     # a copy: shm goes away
        del view
    finally:
        shm.close()
        shm.unlink()
    if stager is not None:
        return stager.put(host, bufs)
    t = torch.from_numpy(host)
    dev = resolve_device(ctx)
    return _nd.NDArray(t if dev.type == "cpu" else t.to(dev))


def _flat(tree):
    if isinstance(tree, tuple):
        return [a for t in tree for a in _flat(t)]
    return [tree]


def _worker_loop(dataset, batchify_payload, task_q, result_q):
    # never touch the card in a forked child (see the module docstring)
    Context._default_ctx.value = cpu()
    torch.set_num_threads(1)
    if isinstance(batchify_payload, bytes):
        batchify_fn = pickle.loads(batchify_payload)
    else:
        batchify_fn = batchify_payload
    while True:
        job = task_q.get()
        if job is None:
            return
        bidx, indices = job
        try:
            batch = batchify_fn([dataset[i] for i in indices])
            result_q.put((bidx, _tree_to_shm(batch), None))
        except Exception:
            result_q.put((bidx, None, traceback.format_exc()))


class DataLoader:
    """Batches of a dataset (ref: gluon.data.DataLoader); see the module
    docstring for the modes and where each runs. ``timeout``: seconds the
    parent waits for a worker process's next batch before it raises (the
    reference's default, 120; the JAX loader waits without end), so a
    worker that hangs fails the iteration instead of stalling it."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=None, timeout=120):
        self._dataset = dataset
        self._timeout = timeout
        if batch_sampler is None:
            check(batch_size is not None,
                  "batch_size required when batch_sampler is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle conflicts with explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None or
              last_batch is not None):
            raise MXNetError("batch_sampler conflicts with batch_size/"
                             "shuffle/sampler/last_batch")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._pin_memory = pin_memory
        self._thread_pool = thread_pool
        self._mode = None
        self._batchify_pickle = None
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)

    def __len__(self):
        return len(self._batch_sampler)

    def _load(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def _worker_mode(self) -> str:
        """'serial', 'thread' or 'process', decided once."""
        if self._mode is not None:
            return self._mode
        if self._num_workers == 0:
            self._mode = "serial"
        elif self._thread_pool is not None:
            self._mode = "thread" if self._thread_pool else "process"
        elif self._batchify_fn is not default_batchify_fn:
            self._mode = "process"
            try:
                self._batchify_pickle = pickle.dumps(self._batchify_fn)
            except Exception:
                warnings.warn(
                    "DataLoader: custom batchify_fn is not picklable; "
                    "falling back to GIL-bound thread workers. Define the "
                    "callable at module top level (not a lambda/closure) "
                    "to enable process workers.", stacklevel=3)
                self._mode = "thread"
        else:
            self._mode = "process"
        return self._mode

    def __iter__(self):
        ctx = current_context()
        stager = None
        if self._pin_memory:
            from ...io.staging import PinnedStager
            stager = PinnedStager(resolve_device(ctx))
        mode = self._worker_mode()
        if mode == "serial":
            return (self._load(indices) for indices in self._batch_sampler)
        if mode == "thread":
            return self._iter_threads(ctx)
        return self._iter_processes(ctx, stager)

    def _iter_threads(self, ctx):
        def load(indices):
            with Context(ctx):
                return self._load(indices)

        with concurrent.futures.ThreadPoolExecutor(self._num_workers) as ex:
            pending = []
            it = iter(self._batch_sampler)
            try:
                for _ in range(self._prefetch or self._num_workers):
                    pending.append(ex.submit(load, next(it)))
            except StopIteration:
                pass
            while pending:
                fut = pending.pop(0)
                try:
                    pending.append(ex.submit(load, next(it)))
                except StopIteration:
                    pass
                yield fut.result()

    def _batchify_for_workers(self):
        if self._batchify_fn is default_batchify_fn:
            return _np_batchify
        if self._batchify_pickle is None:
            # thread_pool=False skipped the pickling attempt: ship a pickle
            # where one can be made, else ride the fork
            try:
                self._batchify_pickle = pickle.dumps(self._batchify_fn)
            except Exception:
                pass
        return self._batchify_pickle or self._batchify_fn

    def _iter_processes(self, ctx, stager):
        mpctx = _mp.get_context("fork")
        task_q = mpctx.SimpleQueue()
        result_q = mpctx.Queue()
        batchify = self._batchify_for_workers()
        workers = [mpctx.Process(target=_worker_loop,
                                 args=(self._dataset, batchify, task_q,
                                       result_q), daemon=True)
                   for _ in range(self._num_workers)]
        for w in workers:
            w.start()
        buffered = {}
        try:
            it = iter(self._batch_sampler)
            sent = received = 0

            def send_next():
                nonlocal sent
                try:
                    task_q.put((sent, next(it)))
                except StopIteration:
                    return False
                sent += 1
                return True

            for _ in range(self._prefetch or self._num_workers):
                if not send_next():
                    break
            while received < sent:
                waited = 0.0
                while received not in buffered:
                    try:
                        bidx, payload, err = result_q.get(timeout=_POLL_S)
                    except _queue.Empty:
                        dead = [w for w in workers if not w.is_alive()]
                        if dead:
                            raise MXNetError(
                                f"DataLoader worker pid(s) "
                                f"{[w.pid for w in dead]} died "
                                f"(exitcode {[w.exitcode for w in dead]}) "
                                "without producing a batch — likely "
                                "OOM-killed or crashed in native code")
                        waited += _POLL_S
                        if self._timeout and waited >= self._timeout:
                            raise MXNetError(
                                f"DataLoader: no batch from the workers in "
                                f"{self._timeout} s (timeout=)")
                        continue
                    if err is not None:
                        raise MXNetError(f"DataLoader worker failed:\n{err}")
                    buffered[bidx] = payload
                payload = buffered.pop(received)
                received += 1
                send_next()
                yield self._receive(payload, ctx, stager)
        finally:
            self._shut_down(workers, task_q, result_q, buffered)

    @staticmethod
    def _shut_down(workers, task_q, result_q, buffered):
        """Stop the workers and free every batch the consumer did not take
        (an early break or an error; the workers gave their segments up).
        The result queue is drained while the workers finish, so none
        blocks on a full pipe; one still alive after 5 s is terminated."""
        for payload in buffered.values():
            _unlink_tree(payload)
        for _ in workers:
            task_q.put(None)

        def drain(wait):
            try:
                while True:
                    _, payload, _ = result_q.get(timeout=wait)
                    if payload is not None:
                        _unlink_tree(payload)
            except _queue.Empty:
                pass

        deadline = time.monotonic() + 5.0
        while any(w.is_alive() for w in workers) and \
                time.monotonic() < deadline:
            drain(0.05)
        for w in workers:
            if w.is_alive():
                w.terminate()
            w.join()
        drain(0.0)

    @staticmethod
    def _receive(payload, ctx, stager):
        bufs: list = []
        out = _tree_from_shm(payload, ctx, stager, bufs)
        if stager is not None:
            event = stager.record()
            stager.hand_out(_flat(out), event)
            stager.release(event, bufs)
        return out
