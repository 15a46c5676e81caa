"""Captured-signature cache for serving: warm CUDA graphs per bucket (ref:
the JAX package's ``serving/cache.py``).

Layered on :class:`~mxnet_tpu_torch.cached_op.CachedOp`, the block's
capture-and-replay executor, with the serving pieces on top:

- an **LRU bound** sized to the bucket set (the batcher guarantees a
  closed signature set, so the bound is a guard rail, not a working
  policy; see ``CachedOp(cache_size=...)``),
- **explicit warmup**: :meth:`SignatureCache.warmup` drives a zero batch
  through every (item shape, batch bucket) combination up front, so each
  signature's graph is captured before the first real request (the
  capture's milliseconds are kept per signature: :meth:`capture_ms`),
- **hit/miss/evict counters** surfaced to the metrics plane via
  :meth:`cache_info` (a CachedOp miss is one new signature: on the card
  one warm-up run and one capture).

A plain callable (no gluon Parameters) is accepted too and invoked
directly with an NDArray; counters then track signatures seen rather
than captures. Batches are made on the model's device: a block's
parameters' device, or for a callable the context current when the cache
was built.
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..cached_op import CachedOp, CacheInfo
from ..context import current_context
from ..telemetry import memory as _memory

__all__ = ["SignatureCache"]

_MEM_OWNERS = itertools.count(1)


class SignatureCache:
    """Graph cache keyed on (item shape, batch bucket, dtype)."""

    def __init__(self, model, cache_size: Optional[int] = None):
        self._lock = threading.Lock()
        # memory-ledger owner tag: every ledgered byte of this cache's
        # captured programs carries it, so per-model bytes are queryable
        # (ServerMetrics polls it) and die with the cache
        self.mem_owner = f"sigcache{next(_MEM_OWNERS)}"
        self._is_block = hasattr(model, "collect_params")
        self._model = model
        self._ctx_device = current_context().torch_device
        if self._is_block:
            self._op: Optional[CachedOp] = CachedOp(model,
                                                    cache_size=cache_size)
            self._fn: Callable = self._op.__call__
        else:
            if not callable(model):
                raise MXNetError(
                    f"SignatureCache needs a gluon Block or a callable, "
                    f"got {type(model).__name__}")
            self._op = None
            self._fn = model
            self._seen: "OrderedDict[Tuple, None]" = OrderedDict()
            self._plain_hits = 0
            self._plain_misses = 0

    @property
    def device(self) -> torch.device:
        """Where batches are made: the block's parameters' device (their
        first tensor's), else the context current at construction."""
        if self._is_block:
            for t in self._model.parameters():
                return t.device
        return self._ctx_device

    def batch(self, rows: np.ndarray):
        """A host batch as an NDArray on the model's device."""
        from ..ndarray.ndarray import NDArray
        return NDArray(torch.from_numpy(np.ascontiguousarray(rows)).to(
            self.device))

    # -----------------------------------------------------------------
    def __call__(self, batch_nd):
        """Run one padded batch (NDArray in, NDArray/tuple out)."""
        if self._op is None:
            key = (tuple(batch_nd.shape), str(batch_nd.dtype))
            with self._lock:
                if key in self._seen:
                    self._plain_hits += 1
                else:
                    self._seen[key] = None
                    self._plain_misses += 1
        return self._fn(batch_nd)

    def warmup(self, item_shapes: Sequence[Tuple[int, ...]],
               batch_sizes: Sequence[int],
               dtype: str = "float32") -> int:
        """Capture every (item shape, batch bucket) signature by running a
        zero batch through the model. Returns the number of signatures
        built (those that were not already resident)."""
        before = self.cache_info().misses
        for shape in item_shapes:
            for b in batch_sizes:
                x = self.batch(np.zeros((int(b),) + tuple(shape),
                                        np.dtype(dtype)))
                out = self(x)
                # finish the capture and the replay now, not on the first
                # real request
                outs = out if isinstance(out, (list, tuple)) else (out,)
                for o in outs:
                    o.asnumpy()
        return self.cache_info().misses - before

    def cache_info(self) -> CacheInfo:
        if self._op is not None:
            return self._op.cache_info()
        with self._lock:
            return CacheInfo(self._plain_hits, self._plain_misses, 0,
                             len(self._seen), None)

    def capture_ms(self) -> Dict[str, float]:
        """Host milliseconds of each signature's capture (card; {} for a
        callable or on the CPU)."""
        return self._op.capture_ms() if self._op is not None else {}

    def program_memory(self, refresh: bool = False) -> dict:
        """Memory of every warm signature (``CachedOp.memory_analysis``),
        registered in the live-byte ledger under ``serving_cache`` with
        this cache's owner tag — the per-model bytes ``ServerMetrics``
        exposes. Plain-callable models own no programs and report {}."""
        if self._op is None:
            return {}
        stats = self._op.memory_analysis(refresh=refresh)
        _memory.register_cache_programs(self.mem_owner, self._op, stats)
        return stats

    def memory_bytes(self) -> int:
        """Ledgered bytes of this cache's recorded programs (0 until
        :meth:`program_memory` has run)."""
        return _memory.ledger().live_bytes(
            "serving_cache", owner_prefix=self.mem_owner + ":")
