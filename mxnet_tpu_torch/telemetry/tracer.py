"""Structured span tracer (ref: src/profiler/profiler.h Profiler singleton;
a copy of the JAX package's ``telemetry/tracer.py``).

Spans are recorded into a bounded ring buffer as plain dicts
``{name, cat, ts, dur, pid, tid, args}`` with ``ts``/``dur`` in microseconds
since tracer birth — the chrome trace-event "X" phase fields, so export is a
straight serialization (:mod:`.chrome_trace`). ``pid`` is the worker rank
(the reference tags profiler output per process; rank comes from
``MXTPU_WORKER_ID``), ``tid`` a dense per-thread id.

Overhead contract: when tracing is off, :func:`span` costs one attribute
check and returns a shared no-op context manager — no clock reads, no
allocation. The test-suite holds this to <1% on a tight step loop.

``MXTPU_PROFILE`` grammar (comma-separated tokens):

    MXTPU_PROFILE=on                         # everything, default ring
    MXTPU_PROFILE=1,ring=65536               # explicit ring capacity
    MXTPU_PROFILE=on,cat=comm|data_wait      # only these categories
    MXTPU_PROFILE=on,file=/tmp/trace.json    # atexit chrome-trace dump
    MXTPU_PROFILE=off                        # force off (same as unset)

Tokens: ``on``/``1``/``all`` | ``off``/``0`` | ``ring=<int>`` |
``cat=<c1>|<c2>|...`` | ``file=<path>``. Unknown tokens raise — a typo'd
profile request must not silently measure nothing.
"""
from __future__ import annotations

import atexit
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional

from ..base import MXNetError, env

__all__ = ["Tracer", "tracer", "span", "instant", "counter_event",
           "enabled", "configure", "enable", "disable"]

DEFAULT_RING = 65536


class _NoopSpan:
    """Shared do-nothing context manager for the tracing-off fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP = _NoopSpan()


class _Span:
    """One live span; records on exit."""
    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self._tr.record(self._name, self._cat, self._t0,
                        time.perf_counter(), self._args)
        return False


class Tracer:
    """Thread-safe span recorder with a bounded ring buffer."""

    def __init__(self, ring: int = DEFAULT_RING,
                 rank: Optional[int] = None):
        self._lock = threading.Lock()
        self._on = False
        self._paused = False
        self._categories: Optional[set] = None   # None = all
        self._ring = int(ring)
        self._spans: deque = deque(maxlen=self._ring)
        # perf_counter <-> epoch wall-clock anchor, captured at ONE
        # instant: trace ts 0 corresponds to epoch second _epoch0. The
        # chrome exporter ships it as process metadata ("clock_sync"),
        # which is what lets tools/fleet_trace.py align N per-rank
        # traces onto one clock.
        self._t0 = time.perf_counter()
        self._epoch0 = time.time()
        #: this rank's wall clock minus rank 0's, in ms (set by
        #: telemetry.collective.sync_clocks after the median-of-K
        #: round-trip handshake; 0.0 = unmeasured / reference rank)
        self.clock_offset_ms = 0.0
        self._rank = rank
        self._tids: Dict[int, int] = {}
        self._tid_counter = itertools.count()
        self._dropped = 0
        # aggregate stats (cat::name -> [count, total_ms, min_ms, max_ms]);
        # unbounded by design: the table is O(distinct names), not O(spans)
        self._agg: Dict[str, List[float]] = defaultdict(
            lambda: [0, 0.0, float("inf"), 0.0])
        self._aggregate = False
        self._file: Optional[str] = None

    # -- state ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._on and not self._paused

    @property
    def rank(self) -> int:
        if self._rank is None:
            self._rank = int(env.get("MXTPU_WORKER_ID"))
        return self._rank

    @property
    def epoch_anchor(self) -> float:
        """Epoch seconds at trace ts 0 (the wall-clock anchor)."""
        return self._epoch0

    @property
    def ring_capacity(self) -> int:
        return self._ring

    @property
    def dropped(self) -> int:
        """Spans evicted from the ring since the last clear()."""
        return self._dropped

    def enable(self) -> None:
        self._on = True
        self._paused = False

    def disable(self) -> None:
        self._on = False

    def pause(self) -> None:
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def set_aggregate(self, on: bool) -> None:
        self._aggregate = bool(on)

    def set_categories(self, cats: Optional[set]) -> None:
        self._categories = set(cats) if cats else None

    def set_ring(self, n: int) -> None:
        n = int(n)
        if n < 1:
            raise MXNetError(f"tracer ring capacity must be >= 1, got {n}")
        with self._lock:
            self._ring = n
            self._spans = deque(self._spans, maxlen=n)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._agg.clear()
            self._dropped = 0

    # -- recording ------------------------------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            # racy double-assign is harmless (same ident -> same dict slot)
            tid = self._tids[ident] = next(self._tid_counter)
        return tid

    def wants(self, category: str) -> bool:
        return self.enabled and (self._categories is None or
                                 category in self._categories)

    def span(self, name: str, category: str, args: Optional[dict] = None):
        """Context manager timing one span. The off path allocates
        nothing and never reads the clock."""
        if not self._on or self._paused or (
                self._categories is not None and
                category not in self._categories):
            return _NOOP
        return _Span(self, name, category, args)

    def record(self, name: str, category: str, t_start: float,
               t_end: float, args: Optional[dict] = None) -> None:
        """Record one completed span from perf_counter timestamps."""
        if not self.wants(category):
            return
        ev = {"name": name, "cat": category,
              "ts": (t_start - self._t0) * 1e6,
              "dur": max(t_end - t_start, 0.0) * 1e6,
              "pid": self.rank, "tid": self._tid()}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(ev)
            if self._aggregate:
                a = self._agg[f"{category}::{name}"]
                ms = (t_end - t_start) * 1e3
                a[0] += 1
                a[1] += ms
                a[2] = min(a[2], ms)
                a[3] = max(a[3], ms)

    def instant(self, name: str, category: str = "marker") -> None:
        """Instant event (chrome 'i' phase)."""
        if not self.wants(category):
            return
        ev = {"name": name, "cat": category, "ph": "i",
              "ts": (time.perf_counter() - self._t0) * 1e6,
              "pid": self.rank, "tid": self._tid(), "s": "t"}
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(ev)

    def counter_event(self, name: str, value,
                      category: str = "counter") -> None:
        """Counter sample (chrome 'C' phase -> stacked area in Perfetto).

        ``value`` may be a single number ({"value": v}) or a mapping of
        series name -> number — Perfetto renders a multi-key args object
        as one stacked counter track (the memory ledger's per-category
        track uses this)."""
        if not self.wants(category):
            return
        if isinstance(value, dict):
            args = {str(k): float(v) for k, v in value.items()}
        else:
            args = {"value": float(value)}
        ev = {"name": name, "cat": category, "ph": "C",
              "ts": (time.perf_counter() - self._t0) * 1e6,
              "pid": self.rank, "tid": self._tid(),
              "args": args}
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(ev)

    # -- inspection -----------------------------------------------------
    def events(self, category: Optional[str] = None) -> List[Dict[str, Any]]:
        """Snapshot of recorded events (copies — safe to mutate)."""
        with self._lock:
            evs = [dict(e) for e in self._spans]
        if category is None:
            return evs
        return [e for e in evs if e.get("cat") == category]

    def thread_names(self) -> Dict[int, str]:
        """tid -> thread name, for chrome metadata events."""
        by_ident = {t.ident: t.name for t in threading.enumerate()}
        return {tid: by_ident.get(ident, f"thread-{tid}")
                for ident, tid in dict(self._tids).items()}

    def aggregate_table(self, reset: bool = False) -> str:
        """Aggregate stats table (ref: AggregateStats dump, profiler.h)."""
        with self._lock:
            rows = sorted(self._agg.items(), key=lambda kv: -kv[1][1])
            lines = [f"{'Name':<50}{'Calls':>8}{'Total(ms)':>12}"
                     f"{'Avg(ms)':>10}{'Min':>10}{'Max':>10}"]
            for name, (count, total, mn, mx) in rows:
                lines.append(f"{name[:50]:<50}{int(count):>8}"
                             f"{total:>12.3f}{total / count:>10.3f}"
                             f"{mn:>10.3f}{mx:>10.3f}")
            if reset:
                self._agg.clear()
        return "\n".join(lines)

    # -- env grammar ----------------------------------------------------
    def configure(self, spec: str) -> None:
        """Apply one MXTPU_PROFILE spec string (see module docstring).

        A spec made only of modifiers (``file=...``, ``cat=...``) implies
        ``on`` — asking for a trace file and getting silence would be the
        silent-measure-nothing failure this grammar exists to prevent."""
        want_on = None
        saw_modifier = False
        for tok in (spec or "").split(","):
            tok = tok.strip()
            if not tok:
                continue
            low = tok.lower()
            if low in ("on", "1", "true", "all"):
                want_on = True
            elif low in ("off", "0", "false"):
                want_on = False
            elif "=" in tok:
                saw_modifier = True
                key, _, val = tok.partition("=")
                key = key.strip().lower()
                val = val.strip()
                if key == "ring":
                    try:
                        self.set_ring(int(val))
                    except ValueError:
                        raise MXNetError(
                            f"MXTPU_PROFILE: ring={val!r} is not an int")
                elif key == "cat":
                    cats = {c.strip() for c in val.split("|") if c.strip()}
                    if not cats:
                        raise MXNetError(
                            "MXTPU_PROFILE: cat= needs at least one "
                            "category, e.g. cat=comm|data_wait")
                    self.set_categories(cats)
                elif key == "file":
                    if not val:
                        raise MXNetError("MXTPU_PROFILE: file= needs a path")
                    self._file = val
                else:
                    raise MXNetError(
                        f"MXTPU_PROFILE: unknown key {key!r} "
                        "(known: ring, cat, file)")
            else:
                raise MXNetError(
                    f"MXTPU_PROFILE: unknown token {tok!r} (known: on, "
                    "off, ring=N, cat=a|b, file=PATH)")
        if want_on is False:
            self.disable()
        elif want_on or saw_modifier:
            self.enable()
            if self._file is not None:
                _register_atexit_dump(self)


# -- module-level singleton + convenience functions -------------------------

tracer = Tracer()

_atexit_registered = False


def _register_atexit_dump(tr: Tracer) -> None:
    global _atexit_registered
    if _atexit_registered:
        return
    _atexit_registered = True

    def _dump():
        if tr._file:
            from .chrome_trace import dump_chrome_trace
            try:
                dump_chrome_trace(tr._file, tracer=tr)
            except Exception:
                pass
    atexit.register(_dump)


def span(name: str, category: str, args: Optional[dict] = None):
    return tracer.span(name, category, args)


def instant(name: str, category: str = "marker") -> None:
    tracer.instant(name, category)


def counter_event(name: str, value,
                  category: str = "counter") -> None:
    tracer.counter_event(name, value, category)


def enabled() -> bool:
    return tracer.enabled


def enable() -> None:
    tracer.enable()


def disable() -> None:
    tracer.disable()


def configure(spec: str) -> None:
    tracer.configure(spec)


_env_spec = env.get("MXTPU_PROFILE")
if _env_spec:
    tracer.configure(_env_spec)
