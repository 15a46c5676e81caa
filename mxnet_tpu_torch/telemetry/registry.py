"""Shared metrics registry: counters, gauges, histograms (ref: the JAX
package's ``telemetry/registry.py``).

The metric types and their Prometheus / JSON renderings are the JAX
package's, byte for byte. The default registry holds what the port
counts:

- signature-cache hits / misses / evictions / occupancy of every
  :class:`~mxnet_tpu_torch.cached_op.SignatureLRU` (the megastep's
  graphs), polled at export time;
- kvstore push / pull retries after ``TransientKVError``
  (``kvstore.py``);
- chaos injections by kind (``contrib/chaos.py``);
- the Trainer's update dispatches (``gluon/trainer.py``);
- compiles, with their seconds: the port has no XLA compiles, so a CUDA
  graph capture (the megastep's, ``SPMDTrainer.run_steps``'s), an nvcc
  build of a kernel source (``ops/_build.py``) and an NVRTC compile
  (``rtc.py``) each land in ``mxtpu_compile_total`` /
  ``mxtpu_compile_seconds_total``, labelled by kind (:func:`note_compile`);
- device-memory watermarks from ``torch.cuda.memory_stats`` (polled
  gauges; on the CPU they read the memory ledger, as the JAX package's
  do on a backend without ``memory_stats``).

Export: :meth:`MetricsRegistry.render_prometheus` /
:meth:`MetricsRegistry.render_json`.
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "LatencyHistogram",
           "MetricsRegistry", "default_registry",
           "DEFAULT_LATENCY_BUCKETS_MS", "note_compile",
           "device_memory_watermark"]


# log-ish spaced, ms. Chosen to resolve both sub-ms CPU models and
# multi-second cold compiles.
DEFAULT_LATENCY_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                              250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


def _fmt(v: float) -> str:
    """Prometheus sample value: render integers without the trailing .0."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class Histogram:
    """Thread-safe histogram: cumulative buckets for Prometheus plus a
    bounded raw-sample reservoir for exact recent percentiles."""

    def __init__(self, buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS_MS,
                 max_samples: int = 8192):
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._samples: deque = deque(maxlen=max_samples)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            i = 0
            for i, b in enumerate(self.bounds):
                if value <= b:
                    break
            else:
                i = len(self.bounds)
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            self._samples.append(value)

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        """Exact percentile over the sample reservoir (0 when empty)."""
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
        k = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
        return float(s[k])

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            s = sorted(self._samples)  # ONE sort for all three percentiles

        def pct(q):
            if not s:
                return 0.0
            k = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
            return round(float(s[k]), 3)

        return {
            "count": count,
            "sum": round(total, 3),
            "mean": round(total / count, 3) if count else 0.0,
            "p50": pct(50),
            "p95": pct(95),
            "p99": pct(99),
        }

    def prometheus_lines(self, name: str, help_: str) -> List[str]:
        with self._lock:
            counts = list(self._counts)
            total, count = self._sum, self._count
        lines = [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            lines.append(f'{name}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{name}_sum {_fmt(round(total, 6))}")
        lines.append(f"{name}_count {count}")
        return lines


#: serving's historical name for the same type (back-compat alias)
LatencyHistogram = Histogram


class Counter:
    """Monotone counter, optionally labelled (one label dimension)."""

    def __init__(self, label: Optional[str] = None):
        self.label = label
        self._value = 0
        self._labelled: "OrderedDict[str, int]" = OrderedDict()
        self._lock = threading.Lock()

    def inc(self, n: int = 1, label_value: Optional[str] = None) -> None:
        with self._lock:
            self._value += n
            if label_value is not None:
                self._labelled[label_value] = \
                    self._labelled.get(label_value, 0) + n

    @property
    def value(self) -> int:
        return self._value

    def by_label(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._labelled)

    def prometheus_lines(self, name: str, help_: str) -> List[str]:
        lines = [f"# HELP {name} {help_}", f"# TYPE {name} counter"]
        with self._lock:
            if self.label and self._labelled:
                for lv, v in self._labelled.items():
                    lines.append(f'{name}{{{self.label}="{lv}"}} {v}')
            else:
                lines.append(f"{name} {self._value}")
        return lines


class Gauge:
    """Point-in-time value; tracks its high-water mark."""

    def __init__(self):
        self._value = 0.0
        self.peak = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v
            if v > self.peak:
                self.peak = v

    def inc(self, delta: float = 1.0) -> None:
        """Atomic read-modify-write (set(value+1) from two threads loses
        an increment; concurrent workers must use this)."""
        with self._lock:
            self._value += delta
            if self._value > self.peak:
                self.peak = self._value

    def dec(self, delta: float = 1.0) -> None:
        self.inc(-delta)

    @property
    def value(self) -> float:
        return self._value

    def prometheus_lines(self, name: str, help_: str) -> List[str]:
        return [f"# HELP {name} {help_}", f"# TYPE {name} gauge",
                f"{name} {_fmt(self._value)}"]


class _CallbackGauge:
    """Gauge whose value is polled from a callable at export time."""

    def __init__(self, fn: Callable[[], float]):
        self._fn = fn

    @property
    def value(self) -> float:
        try:
            return float(self._fn())
        except Exception:
            return 0.0

    def prometheus_lines(self, name: str, help_: str) -> List[str]:
        return [f"# HELP {name} {help_}", f"# TYPE {name} gauge",
                f"{name} {_fmt(self.value)}"]


class MetricsRegistry:
    """Named metric directory with get-or-create semantics.

    Names follow Prometheus conventions (``mxtpu_<subsystem>_<what>[_total]``).
    Re-requesting an existing name returns the same object; requesting it as
    a different metric type raises — two subsystems silently sharing one
    name with different meanings is the bug this registry exists to stop.
    """

    def __init__(self):
        self._metrics: "OrderedDict[str, tuple]" = OrderedDict()
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, kind: str, help_: str,
                       factory: Callable[[], object]):
        with self._lock:
            hit = self._metrics.get(name)
            if hit is not None:
                if hit[0] != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {hit[0]}, "
                        f"requested as {kind}")
                return hit[1]
            m = factory()
            self._metrics[name] = (kind, m, help_)
            return m

    def counter(self, name: str, help: str = "",
                label: Optional[str] = None) -> Counter:
        return self._get_or_create(name, "counter", help,
                                   lambda: Counter(label=label))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, "gauge", help, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> Histogram:
        return self._get_or_create(name, "histogram", help,
                                   lambda: Histogram(buckets=buckets))

    def callback_gauge(self, name: str, fn: Callable[[], float],
                       help: str = "") -> None:
        """Register (or replace) a gauge polled from ``fn`` at export."""
        with self._lock:
            self._metrics[name] = ("gauge", _CallbackGauge(fn), help)

    def get(self, name: str):
        with self._lock:
            hit = self._metrics.get(name)
        return hit[1] if hit is not None else None

    def names(self) -> List[str]:
        with self._lock:
            return list(self._metrics)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- export ---------------------------------------------------------
    def render_prometheus(self) -> str:
        with self._lock:
            items = list(self._metrics.items())
        lines: List[str] = []
        for name, (kind, m, help_) in items:
            lines += m.prometheus_lines(name, help_ or name)
        return "\n".join(lines) + ("\n" if lines else "")

    def render_json(self) -> dict:
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, object] = {}
        for name, (kind, m, _help) in items:
            if kind == "histogram":
                out[name] = m.snapshot()
            elif kind == "counter" and m.label:
                out[name] = {"total": m.value, "by_label": m.by_label()}
            else:
                out[name] = m.value
        return out

    def render_json_text(self) -> str:
        return json.dumps(self.render_json())


_default = MetricsRegistry()
_runtime_hooks_installed = False
_hooks_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (installs runtime hooks on first use)."""
    _install_runtime_hooks()
    return _default


def _compile_counters():
    return (_default.counter(
                "mxtpu_compile_total",
                "Compiles observed: CUDA graph captures, nvcc kernel "
                "builds, NVRTC compiles.", label="kind"),
            _default.counter(
                "mxtpu_compile_seconds_total",
                "Wall-clock seconds spent in compiles (graph capture, "
                "nvcc, NVRTC).", label="kind"))


def _install_runtime_hooks() -> None:
    """One-time wiring of the runtime-level sources: the compile counters
    and the device-memory watermark gauges. Idempotent, never raises
    (telemetry must not take down training)."""
    global _runtime_hooks_installed
    with _hooks_lock:
        if _runtime_hooks_installed:
            return
        _runtime_hooks_installed = True
    try:
        _compile_counters()
        _default.callback_gauge(
            "mxtpu_device_bytes_in_use", _device_bytes_in_use,
            "Live device-memory bytes (torch.cuda.memory_stats; the "
            "memory ledger without a card).")
        _default.callback_gauge(
            "mxtpu_device_peak_bytes", device_memory_watermark,
            "Peak device-memory bytes observed (high-water mark).")
    except Exception:
        pass


def note_compile(kind: str, seconds: float, name: str = "") -> None:
    """Count one compile of ``kind`` (``graph_capture``, ``nvcc`` or
    ``nvrtc``) that took ``seconds``, and record it as a ``compile`` span
    when tracing. Never raises."""
    try:
        count, secs = _compile_counters()
        count.inc(label_value=kind)
        secs.inc(max(float(seconds), 0.0), label_value=kind)
        from .tracer import tracer as _tr
        if _tr.enabled:
            now = time.perf_counter()
            _tr.record(name or kind, "compile",
                       max(now - seconds, _tr._t0), now, {"kind": kind})
    except Exception:
        pass


_mem_peak = 0.0


def _device_stats_value(key: str) -> float:
    """Sum of one ``torch.cuda.memory_stats`` key over the cards this
    process initialised (0 without a card)."""
    try:
        import torch
        if not torch.cuda.is_available() or \
                not torch.cuda.is_initialized():
            return 0.0
        return float(sum(torch.cuda.memory_stats(d).get(key, 0)
                         for d in range(torch.cuda.device_count())))
    except Exception:
        return 0.0


def _ledger_value(attr: str) -> float:
    try:
        from . import memory as _memory
        led = _memory.ledger()
        return float(led.live_bytes() if attr == "live" else led.peak_bytes)
    except Exception:
        return 0.0


def _device_bytes_in_use() -> float:
    v = _device_stats_value("allocated_bytes.all.current")
    if v <= 0:
        # no card: the framework's own live-byte ledger (exact for the
        # tracked categories), so these gauges do not read 0 on the CPU
        v = _ledger_value("live")
    global _mem_peak
    if v > _mem_peak:
        _mem_peak = v
    return v


def device_memory_watermark() -> float:
    """Peak device bytes seen by any poll (the allocator's peak when a
    card is in use, else the max over our own samples and the memory
    ledger's process-lifetime peak)."""
    reported = _device_stats_value("allocated_bytes.all.peak")
    return max(reported, _mem_peak, _ledger_value("peak"),
               _device_bytes_in_use())
