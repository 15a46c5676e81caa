"""Dynamic batching policy: shape buckets, batch padding, admission types
(ref: the JAX package's ``serving/batcher.py``).

The serving value proposition of the reference's model server (MMS) is
dynamic batching: concurrent single-example requests are coalesced into one
model dispatch so per-dispatch fixed costs (host work, kernel launches)
amortize. On the card there is a second reason: the block's ``CachedOp``
captures one CUDA graph per input signature, so free-form request shapes
mean a capture per shape. The batcher therefore maps every request into a
small CLOSED set of signatures:

- **shape buckets**: a request's item shape (no batch dim) must match one
  of the configured ``bucket_shapes`` exactly (or, unconfigured, each
  distinct observed shape becomes its own bucket — convenient, but the
  signature set is then open). Requests that fit no bucket are rejected
  with :class:`NoBucket` at admission, not at dispatch.
- **batch buckets**: the real row count is padded up to the next power of
  two (capped by ``max_batch_size``) with zero rows. Total signatures =
  |shape buckets| x |batch buckets|, independent of traffic.

Padding rows are sliced back off before results are delivered, so a
row-independent model (anything in inference mode — BatchNorm uses moving
stats) returns the same rows as the hybridized model called at the same
padded batch size.

This module is the *policy* layer — pure, synchronous, unit-testable. The
threads that drive it live in :mod:`mxnet_tpu_torch.serving.server`.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError

__all__ = ["ServingError", "QueueFull", "DeadlineExceeded", "NoBucket",
           "ServerClosed", "PredictionFuture", "Request", "Batch",
           "BucketTable", "batch_buckets", "pad_rows"]


class ServingError(MXNetError):
    """Base class for typed serving rejections."""


class QueueFull(ServingError):
    """Admission queue is at ``queue_depth``: load is shed at the door
    (backpressure) instead of buffering until OOM. Clients should retry
    with backoff or route elsewhere."""


class DeadlineExceeded(ServingError):
    """The request's deadline expired while it waited; it was dropped
    WITHOUT being dispatched — no model compute was spent on it."""


class NoBucket(ServingError):
    """The request's item shape matches none of the configured shape
    buckets (a closed signature set is the whole point — see module doc)."""


class ServerClosed(ServingError):
    """The server is draining (SIGTERM/stop); no new work is admitted."""


class PredictionFuture:
    """Write-once result slot handed back by ``ModelServer.submit``.

    After the batch is dispatched, ``version`` carries the tag of the
    model version that served it (None for registry-less servers) and
    ``dispatch_seq`` the server-wide dispatch sequence number — the pair
    is how hot-swap tests prove version flips are atomic (tags are
    monotone in ``dispatch_seq`` order)."""

    __slots__ = ("_event", "_result", "_error", "version", "dispatch_seq")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self.version: Optional[str] = None
        self.dispatch_seq: Optional[int] = None

    def set_result(self, value) -> None:
        self._result = value
        self._event.set()

    def set_exception(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("prediction not ready")
        if self._error is not None:
            raise self._error
        return self._result


class Request:
    """One admitted example plus its timing/deadline bookkeeping."""

    __slots__ = ("payload", "key", "deadline", "t_submit", "t_formed",
                 "future")

    def __init__(self, payload: np.ndarray, key: Tuple,
                 deadline: Optional[float]):
        self.payload = payload
        self.key = key                      # (item_shape, dtype_str)
        self.deadline = deadline            # absolute monotonic, or None
        self.t_submit = time.perf_counter()
        self.t_formed: Optional[float] = None
        self.future = PredictionFuture()

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.perf_counter()) >= self.deadline


class Batch:
    """A flushed bucket: requests that will ride one model dispatch."""

    __slots__ = ("key", "requests", "t_formed")

    def __init__(self, key: Tuple, requests: List[Request]):
        self.key = key
        self.requests = requests
        self.t_formed = time.perf_counter()
        for r in requests:
            r.t_formed = self.t_formed


def batch_buckets(max_batch_size: int) -> Tuple[int, ...]:
    """The closed set of padded batch sizes: powers of two up to (and
    always including) ``max_batch_size``."""
    sizes = []
    b = 1
    while b < max_batch_size:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch_size)
    return tuple(sizes)


def pad_rows(rows: List[np.ndarray], bucket: int) -> np.ndarray:
    """Stack item arrays into a (bucket, *item) batch, zero-padding the
    tail rows. The caller slices off everything past ``len(rows)``."""
    stacked = np.stack(rows)
    if len(rows) < bucket:
        pad = np.zeros((bucket - len(rows),) + stacked.shape[1:],
                       stacked.dtype)
        stacked = np.concatenate([stacked, pad])
    return stacked


class BucketTable:
    """Pending requests grouped by (item shape, dtype), with the flush
    policy: a bucket flushes when it reaches ``max_batch_size`` rows or
    when its oldest request has waited ``max_queue_latency_ms``.

    Not thread-safe by itself — the server's batcher thread is the only
    writer, under the server's admission lock.
    """

    def __init__(self, max_batch_size: int, max_queue_latency_ms: float,
                 bucket_shapes: Optional[Sequence[Tuple[int, ...]]] = None):
        if max_batch_size < 1:
            raise MXNetError("max_batch_size must be >= 1")
        self.max_batch_size = int(max_batch_size)
        self.max_latency_s = float(max_queue_latency_ms) / 1000.0
        self.bucket_shapes = (None if bucket_shapes is None else
                              {tuple(s) for s in bucket_shapes})
        self.batch_sizes = batch_buckets(self.max_batch_size)
        self._pending: Dict[Tuple, List[Request]] = {}
        self._first_at: Dict[Tuple, float] = {}

    def key_for(self, shape: Tuple[int, ...], dtype: str) -> Tuple:
        """Admission-time bucket resolution; raises :class:`NoBucket` for
        shapes outside the configured set."""
        shape = tuple(int(s) for s in shape)
        if self.bucket_shapes is not None and shape not in self.bucket_shapes:
            raise NoBucket(
                f"request item shape {shape} matches no configured bucket "
                f"(buckets: {sorted(self.bucket_shapes)})")
        return (shape, str(dtype))

    def pad_to(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    @property
    def pending_count(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def add(self, req: Request) -> Optional[Batch]:
        """File a request; returns a full Batch when the bucket hit
        ``max_batch_size``."""
        lst = self._pending.setdefault(req.key, [])
        if not lst:
            self._first_at[req.key] = time.perf_counter()
        lst.append(req)
        if len(lst) >= self.max_batch_size:
            return self._flush(req.key)
        return None

    def _flush(self, key: Tuple) -> Batch:
        reqs = self._pending.pop(key)
        self._first_at.pop(key, None)
        return Batch(key, reqs)

    def due(self, now: Optional[float] = None) -> List[Batch]:
        """Flush every bucket whose oldest request aged past the latency
        budget."""
        now = time.perf_counter() if now is None else now
        out = []
        for key, t0 in list(self._first_at.items()):
            if now - t0 >= self.max_latency_s:
                out.append(self._flush(key))
        return out

    def flush_all(self) -> List[Batch]:
        """Drain: flush every pending bucket regardless of age."""
        return [self._flush(k) for k in list(self._pending)]

    def next_deadline(self) -> Optional[float]:
        """Monotonic time of the earliest pending flush, or None."""
        if not self._first_at:
            return None
        return min(self._first_at.values()) + self.max_latency_s
