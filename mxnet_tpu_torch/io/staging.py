"""Host-to-device staging (ref: src/storage/pinned_memory_storage.h and
iter_prefetcher.h; the JAX package's ``io/staging.py``).

``DeviceStagingIter`` wraps a DataIter and copies batch k+1 (and, with a
deeper ``depth``, the ones after it) to the card while the trainer
computes on batch k. The JAX package relies on ``jax.device_put``'s
asynchronous DMA; here each step of it is explicit:

1. the host batch (numpy arrays from ``NDArrayIter._next_host``, or the
   base iterator's host NDArrays) is copied into a page-locked host
   buffer, one per array, taken from a pool and reused;
2. the device tensor is allocated and filled from it by a non-blocking
   copy on a side stream, and an event is recorded there after the copy;
3. when the batch is handed out, the consumer's current stream waits on
   that event (the batch's data is never read before it landed), and
   each tensor is ``record_stream``-ed on the consumer's stream, so the
   caching allocator does not give its memory to the next staged batch
   while the step still reads it;
4. a pinned buffer goes back to the pool with its copy's event and is
   reused only once that event has completed.

Batches come out as NDArrays on the iterator's device: the card unless
the caller names ``mx.cpu()`` (``device=`` or ``with mx.cpu():``), where
staging is a plain host copy. ``depth`` / ``set_depth``, the ``h2d``
step-breakdown segment and the memory ledger's ``staging`` entries are
the JAX package's.

Unlike the JAX package's, the iterator passes ``set_epoch`` and
``set_position`` (and ``num_parts`` / ``part_index``) through to a base
iterator that has them, dropping what it had staged. ``fit.FitLoop``
then positions a staged ``NDArrayIter`` as it positions a bare one, so a
run resumed from a checkpoint inside any epoch replays the fault-free
batches. The JAX package's wrapper has neither: ``FitLoop`` falls back to
``reset()``, whose epoch count depends on how often the iterator was
reset before, and a relaunched run resumed inside its second or a later
epoch draws another shuffle than the run it resumes.
"""
from __future__ import annotations

import itertools
import weakref

import numpy as _np
import torch

from ..base import check
from ..context import Context, resolve_device
from ..ndarray.ndarray import NDArray
from ..telemetry import memory as _memory
from ..telemetry.step_breakdown import segment as _segment
from .io import DataBatch, DataIter

__all__ = ["DeviceStagingIter", "PinnedStager"]

_STAGE_KEYS = itertools.count(1)


def _drop_keys(led, keys):
    # ``led`` is the ledger captured at construction: this runs from
    # weakref.finalize, and MemoryLedger.drop is finalizer-safe
    try:
        for key in keys:
            led.drop("staging", key)
    except Exception:
        pass  # interpreter shutdown


def _host_tensor(a) -> torch.Tensor:
    """A host tensor over a numpy array, NDArray or tensor (no copy where
    it can be avoided)."""
    if isinstance(a, NDArray):
        a = a._data
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.from_numpy(_np.ascontiguousarray(a))


class PinnedStager:
    """Host arrays onto ``device`` through pooled page-locked buffers and a
    side stream (steps 1-4 of the module docstring); a plain copy when
    ``device`` is the host. ``gluon.data.DataLoader(pin_memory=True)``
    stages its batches through one too."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._stream = None            # the copy stream, made at first use
        self._pool = {}                # (shape, dtype) -> [(pinned, event)]

    def _pinned(self, src: torch.Tensor) -> torch.Tensor:
        """A page-locked host buffer of ``src``'s shape and dtype whose
        last copy has completed, holding ``src``'s values."""
        key = (tuple(src.shape), src.dtype)
        free = self._pool.get(key)
        if free:
            buf, event = free.pop(0)
            event.synchronize()        # its last H2D copy has landed
        else:
            buf = torch.empty(key[0], dtype=key[1], pin_memory=True)
        buf.copy_(src)
        return buf

    def release(self, event, bufs) -> None:
        """Return ``bufs`` to the pool, reusable once ``event`` is done."""
        for buf in bufs:
            self._pool.setdefault((tuple(buf.shape), buf.dtype), []).append(
                (buf, event))

    def put(self, a, bufs) -> NDArray:
        """Start the copy of ``a`` to the device; the pinned buffers it
        took are appended to ``bufs``."""
        src = _host_tensor(a)
        if src.device == self.device:
            # already where it belongs (a base iterator on the card):
            # nothing to copy
            return NDArray(src)
        if not self.cuda:
            return NDArray(src.to(self.device, copy=True))
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if src.is_cuda:                # on another card
            with torch.cuda.stream(self._stream):
                return NDArray(src.to(self.device, non_blocking=True))
        buf = self._pinned(src)
        bufs.append(buf)
        with torch.cuda.stream(self._stream):
            dev = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
            dev.copy_(buf, non_blocking=True)
        return NDArray(dev)

    def record(self):
        """An event after every copy started so far (None on the host)."""
        if not self.cuda:
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        event = torch.cuda.Event()
        event.record(self._stream)
        return event

    def hand_out(self, arrays, event) -> None:
        """Make the consumer's stream wait for the copies, and keep their
        memory from reuse until that stream is done with it."""
        if event is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for a in arrays:
            if a._data.is_cuda:
                a._data.record_stream(stream)


class DeviceStagingIter(DataIter):
    """Stage batches onto the device ahead of consumption.

    >>> it = DeviceStagingIter(NDArrayIter(X, Y, batch_size=32))
    >>> for batch in it:           # batch.data already on the card
    ...     ...
    """

    def __init__(self, base_iter: DataIter, device=None, depth: int = 1):
        super().__init__(base_iter.batch_size)
        check(depth >= 1, "staging depth must be >= 1")
        self._base = base_iter
        self._depth = depth
        self._device = resolve_device(device)
        self._ctx = Context(self._device)
        self._stager = PinnedStager(self._device)
        self._staged: list = []        # (DataBatch, event, [pinned])
        self._staged_keys: list = []   # parallel memory-ledger keys
        self._exhausted = False
        # an iterator abandoned mid-epoch must not leak its staged bytes
        self._ledger = _memory.ledger()
        weakref.finalize(self, _drop_keys, self._ledger, self._staged_keys)
        # seekable only where the base is
        for name in ("set_epoch", "set_position"):
            if callable(getattr(base_iter, name, None)):
                setattr(self, name, getattr(self, "_" + name))
        self.num_parts = int(getattr(base_iter, "num_parts", 1) or 1)
        self.part_index = int(getattr(base_iter, "part_index", 0) or 0)

    @property
    def depth(self) -> int:
        """Staging depth: batches kept in flight ahead of consumption."""
        return self._depth

    def set_depth(self, depth: int) -> None:
        """Retarget the staging depth mid-run. Deepening takes effect on
        the next ``next()``; shallowing drains naturally — already-staged
        batches are served, never dropped."""
        check(depth >= 1, "staging depth must be >= 1")
        self._depth = int(depth)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def provide_data(self):
        return self._base.provide_data

    @property
    def provide_label(self):
        return self._base.provide_label

    def reset(self):
        self._base.reset()
        self._drop_staged()

    def _drop_staged(self):
        for _, event, bufs in self._staged:
            self._stager.release(event, bufs)
        self._staged.clear()
        self._drop_staged_keys()
        self._exhausted = False

    def _set_epoch(self, epoch) -> None:
        """Position the base at the start of ``epoch`` (its ``set_epoch``);
        staged batches are dropped."""
        self._base.set_epoch(epoch)
        self._drop_staged()

    def _set_position(self, epoch, global_samples) -> None:
        """Position the base at a global sample offset of ``epoch`` (its
        ``set_position``); staged batches are dropped."""
        self._base.set_position(epoch, global_samples)
        self._drop_staged()

    def _drop_staged_keys(self):
        for key in self._staged_keys:
            self._ledger.drop("staging", key)
        self._staged_keys.clear()

    # -- staging ----------------------------------------------------------
    def _next_host_batch(self) -> DataBatch:
        host_next = getattr(self._base, "_next_host", None)
        return host_next() if host_next is not None else self._base.next()

    def _stage_one(self) -> bool:
        """Start the H2D copy of the next host batch."""
        try:
            batch = self._next_host_batch()
        except StopIteration:
            return False
        with _segment("h2d"):
            bufs: list = []
            put = self._stager.put
            staged = DataBatch(
                [put(d, bufs) for d in (batch.data or [])],
                [put(l, bufs) for l in (batch.label or [])],
                pad=batch.pad, index=getattr(batch, "index", None),
                bucket_key=getattr(batch, "bucket_key", None))
            event = self._stager.record()
            self._staged.append((staged, event, bufs))
            # ledger the staged-ahead bytes (category 'staging'): live from
            # the copy's start until the consumer pops the batch
            key = ("stage", next(_STAGE_KEYS))
            self._staged_keys.append(key)
            self._ledger.set(
                "staging", key,
                sum(_memory.nd_bytes(a) for a in
                    (staged.data or []) + (staged.label or [])),
                owner=f"staging:{type(self._base).__name__}")
        return True

    def _hand_out(self, staged, event) -> DataBatch:
        self._stager.hand_out((staged.data or []) + (staged.label or []),
                              event)
        return staged

    def next(self) -> DataBatch:
        while not self._exhausted and len(self._staged) <= self._depth:
            if not self._stage_one():
                self._exhausted = True
        if not self._staged:
            raise StopIteration
        staged, event, bufs = self._staged.pop(0)
        if self._staged_keys:
            self._ledger.drop("staging", self._staged_keys.pop(0))
        out = self._hand_out(staged, event)
        self._stager.release(event, bufs)
        # refill the pipeline: start the next transfer before returning
        if not self._exhausted and len(self._staged) <= self._depth \
                and not self._stage_one():
            self._exhausted = True
        return out
