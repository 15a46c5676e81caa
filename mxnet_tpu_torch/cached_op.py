"""Signature caches and the block's capture lock (ref: the JAX package's
``cached_op.py``; src/imperative/cached_op.{h,cc} in the reference).

Only the parts the megastep uses are ported: :class:`SignatureLRU`, the
thread-safe signature-keyed LRU of captured programs with its
:class:`CacheInfo` counters, and :func:`trace_rw_for`, the block's shared
many-readers / one-writer lock that a capture takes exclusively (a
capture runs the block's forward on shared Parameters). ``CachedOp`` and
hybridize, which serving needs, are ROADMAP A12; the port's
``hybridize()`` compiles nothing. Every cache reports its counters to the
metrics registry as polled gauges (``mxtpu_cachedop_cache_*``), as in the
JAX package.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, namedtuple
from typing import Any

from .base import env

__all__ = ["CacheInfo", "SignatureLRU", "trace_rw_for"]

CacheInfo = namedtuple("CacheInfo",
                       ["hits", "misses", "evictions", "currsize", "maxsize"])


# Every live SignatureLRU (CachedOp signature caches, grouped-optimizer
# program caches, serving signature caches) reports into the shared
# telemetry registry as polled gauges — zero hot-path cost: the counters
# are summed at export time, not on every lookup. Counters of DEAD caches
# are folded into a retired accumulator by a weakref.finalize, so the
# exported totals are MONOTONE: a cyclic-GC pass collecting an old
# hybridized net between two reads must never make hits/misses go down
# (the exact mechanism behind the test_env_flags+test_telemetry
# pair-order flake this replaces — the gauge used to sum live caches
# only, so a cache dying mid-test subtracted its whole history).
_all_caches: "weakref.WeakSet" = None  # type: ignore[assignment]
_retired_counts = {"hits": 0, "misses": 0, "evictions": 0}
# RLock, not Lock: the retire callback runs from weakref.finalize, which
# cyclic GC may fire synchronously on THIS thread while it already holds
# the lock (list() below allocates, allocation can trigger collection of
# a dead cycle holding a SignatureLRU) — a plain Lock would self-deadlock
_track_lock = threading.RLock()


def _retire_cache_counts(stats: dict) -> None:
    with _track_lock:
        for field in _retired_counts:
            _retired_counts[field] += stats[field]


def _tracked_cache_total(field: str) -> int:
    """Monotone process-wide total for hits/misses/evictions; live-only
    occupancy for currsize (a dead cache holds no entries)."""
    with _track_lock:
        live = list(_all_caches) if _all_caches is not None else []
        base = _retired_counts.get(field, 0)
    return base + sum(getattr(c.cache_info(), field) for c in live)


def _track_cache(cache: "SignatureLRU") -> None:
    global _all_caches
    import weakref
    with _track_lock:
        if _all_caches is None:
            _all_caches = weakref.WeakSet()
            try:
                from .telemetry import default_registry
                reg = default_registry()
                for field in ("hits", "misses", "evictions", "currsize"):
                    reg.callback_gauge(
                        f"mxtpu_cachedop_cache_{field}",
                        (lambda f=field: _tracked_cache_total(f)),
                        f"Signature-cache {field} over all compiled-"
                        "program caches (monotone: retired caches keep "
                        "their counts, except currsize which is live "
                        "occupancy).")
            except Exception:
                pass
        _all_caches.add(cache)
    weakref.finalize(cache, _retire_cache_counts, cache._stats)


class SignatureLRU:
    """Thread-safe signature-keyed LRU of captured programs, bounded by
    ``MXTPU_CACHEDOP_CACHE_SIZE`` (0 = unbounded)."""

    def __init__(self):
        self._cache: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0}
        _track_cache(self)

    @staticmethod
    def _bound() -> int:
        return int(env.get("MXTPU_CACHEDOP_CACHE_SIZE"))

    def get_or_insert(self, key, factory):
        """Lock-held get-or-create for CHEAP factories (an entry object,
        never a capture): exactly one caller creates the value for a key,
        so concurrent cold lookups cannot race two half-initialised
        entries into existence."""
        with self._lock:
            val = self._cache.get(key)
            if val is not None:
                self._stats["hits"] += 1
                self._cache.move_to_end(key)
                return val
            self._stats["misses"] += 1
            val = factory()
            self._cache[key] = val
            self._evict_locked()
            return val

    def _evict_locked(self) -> None:
        bound = self._bound()
        if bound > 0:
            while len(self._cache) > bound:
                self._cache.popitem(last=False)
                self._stats["evictions"] += 1

    def cache_info(self) -> CacheInfo:
        bound = self._bound()
        return CacheInfo(self._stats["hits"], self._stats["misses"],
                         self._stats["evictions"], len(self._cache),
                         bound if bound > 0 else None)

    def snapshot_items(self):
        """(key, value) pairs at this instant."""
        with self._lock:
            return list(self._cache.items())


class _RWLock:
    """Many concurrent replays, exclusive captures, with writer
    preference: back-to-back replays must not starve a cold signature's
    one-time capture."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writing = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writing or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if not self._readers:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writing or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writing = True

    def release_write(self):
        with self._cond:
            self._writing = False
            self._cond.notify_all()


def trace_rw_for(block) -> _RWLock:
    """The block's shared capture lock, created and stashed on the block
    at first use, so every capture over the same Parameters (the
    megastep's, and A12's ``CachedOp``) excludes the others. A block that
    refuses the attribute gets a private lock."""
    rw = getattr(block, "_mxtpu_trace_rw", None)
    if rw is None:
        rw = _RWLock()
        try:
            block._mxtpu_trace_rw = rw
        except AttributeError:
            pass
    return rw
