"""Serving metrics plane: latency histograms, counters, gauges (ref: the
JAX package's ``serving/metrics.py``; its Prometheus and JSON text, byte
for byte on the same counts).

The reference pairs MXNet with a model server (MMS) whose ops story is a
metrics sidecar (mms/metrics/*: request counts, latency, queue time,
worker memory — logged and scraped). Here the metrics plane is in-process
and first-class: every request is timed in three components,

- ``queue``    — admission to batch formation (waiting for peers),
- ``batch``    — batch formation to worker pickup (waiting for a worker),
- ``compute``  — model execution including device sync (on the card,
  one CUDA graph replay and the copy back),

plus an end-to-end ``total``. Batch sizes, queue depth, shed load and
compiled-signature cache traffic are tracked alongside. Two export
formats: Prometheus text exposition (:meth:`ServerMetrics.render_prometheus`)
and JSON (:meth:`ServerMetrics.render_json`); batch dispatches are also
emitted as ``profiler.record_span`` events so chrome://tracing shows the
serving timeline next to op execution.

The metric primitives (Counter / Gauge / Histogram with percentile
reservoirs) live in :mod:`mxnet_tpu_torch.telemetry.registry` — they started
here and were promoted to the shared telemetry layer; this module re-exports
them under their historical names.
"""
from __future__ import annotations

import json
import time
from typing import Callable, List, Optional

from ..telemetry.registry import (Counter, Gauge, Histogram,
                                  LatencyHistogram,
                                  DEFAULT_LATENCY_BUCKETS_MS, _fmt)

__all__ = ["LatencyHistogram", "Counter", "Gauge", "ServerMetrics",
           "DEFAULT_LATENCY_BUCKETS_MS"]


class ServerMetrics:
    """The full serving metrics surface for one :class:`ModelServer`.

    ``cache_info_fn`` (set by the server) is polled at export time so cache
    hit/miss/evict counters always reflect the live signature cache.
    """

    #: batch-size histogram bounds: powers of two cover every batch bucket
    BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

    def __init__(self, name: str = "model"):
        self.name = name
        self.started = time.time()
        self.requests_total = Counter()
        self.responses_total = Counter()
        self.rejected_total = Counter(label="reason")
        self.batches_total = Counter()
        self.dispatched_rows_total = Counter()
        self.padded_rows_total = Counter()
        self.queue_depth = Gauge()
        self.inflight_batches = Gauge()
        self.queue_ms = LatencyHistogram()
        self.batch_ms = LatencyHistogram()
        self.compute_ms = LatencyHistogram()
        self.total_ms = LatencyHistogram()
        self.batch_size = LatencyHistogram(buckets=self.BATCH_SIZE_BUCKETS)
        self.cache_info_fn: Optional[Callable] = None
        # per-model device bytes (set by the server): polls the memory
        # ledger's serving_cache bytes for the ACTIVE model's signature
        # cache, so a deploy/drain shows up as a rise/fall here
        self.memory_fn: Optional[Callable] = None

    # -- recording helpers (one call site each in the server) ------------
    def record_request(self) -> None:
        self.requests_total.inc()

    def record_rejection(self, reason: str) -> None:
        self.rejected_total.inc(label_value=reason)

    def record_batch(self, rows: int, padded_to: int, t_dispatch: float,
                     t_done: float) -> None:
        self.batches_total.inc()
        self.dispatched_rows_total.inc(rows)
        self.padded_rows_total.inc(padded_to - rows)
        self.batch_size.observe(rows)
        self.compute_ms.observe((t_done - t_dispatch) * 1000.0)

    def record_response(self, t_submit: float, t_formed: float,
                        t_dispatch: float, t_done: float) -> None:
        self.responses_total.inc()
        self.queue_ms.observe((t_formed - t_submit) * 1000.0)
        self.batch_ms.observe((t_dispatch - t_formed) * 1000.0)
        self.total_ms.observe((t_done - t_submit) * 1000.0)

    # -- export -----------------------------------------------------------
    def _cache_counts(self) -> dict:
        if self.cache_info_fn is None:
            return {}
        info = self.cache_info_fn()
        return {"hits": info.hits, "misses": info.misses,
                "evictions": info.evictions, "entries": info.currsize,
                "max_entries": info.maxsize}

    def _model_bytes(self) -> int:
        if self.memory_fn is None:
            return 0
        try:
            return int(self.memory_fn())
        except Exception:
            return 0

    def render_prometheus(self, prefix: str = "mxtpu_serve") -> str:
        up = time.time() - self.started
        lines: List[str] = []
        lines += self.requests_total.prometheus_lines(
            f"{prefix}_requests_total", "Requests admitted or rejected.")
        lines += self.responses_total.prometheus_lines(
            f"{prefix}_responses_total", "Requests answered successfully.")
        lines += self.rejected_total.prometheus_lines(
            f"{prefix}_rejected_total",
            "Requests shed, by reason (queue_full|deadline|no_bucket|closed).")
        lines += self.batches_total.prometheus_lines(
            f"{prefix}_batches_total", "Batches dispatched to the model.")
        lines += self.dispatched_rows_total.prometheus_lines(
            f"{prefix}_dispatched_rows_total",
            "Real (unpadded) rows dispatched.")
        lines += self.padded_rows_total.prometheus_lines(
            f"{prefix}_padded_rows_total",
            "Padding rows added to reach a batch bucket.")
        lines += self.queue_depth.prometheus_lines(
            f"{prefix}_queue_depth", "Admitted requests not yet dispatched.")
        lines += [f"# HELP {prefix}_queue_depth_peak "
                  "High-water mark of the admission queue.",
                  f"# TYPE {prefix}_queue_depth_peak gauge",
                  f"{prefix}_queue_depth_peak {_fmt(self.queue_depth.peak)}"]
        lines += self.inflight_batches.prometheus_lines(
            f"{prefix}_inflight_batches", "Batches currently executing.")
        lines += self.queue_ms.prometheus_lines(
            f"{prefix}_queue_latency_ms",
            "Admission to batch formation, milliseconds.")
        lines += self.batch_ms.prometheus_lines(
            f"{prefix}_batch_latency_ms",
            "Batch formation to worker pickup, milliseconds.")
        lines += self.compute_ms.prometheus_lines(
            f"{prefix}_compute_latency_ms",
            "Model execution including device sync, milliseconds.")
        lines += self.total_ms.prometheus_lines(
            f"{prefix}_total_latency_ms",
            "End-to-end request latency, milliseconds.")
        lines += self.batch_size.prometheus_lines(
            f"{prefix}_batch_size", "Real rows per dispatched batch.")
        cache = self._cache_counts()
        for key in ("hits", "misses", "evictions"):
            if key in cache:
                lines += [f"# HELP {prefix}_cache_{key}_total "
                          f"Compiled-signature cache {key}.",
                          f"# TYPE {prefix}_cache_{key}_total counter",
                          f"{prefix}_cache_{key}_total {cache[key]}"]
        if "entries" in cache:
            lines += [f"# HELP {prefix}_cache_entries "
                      "Resident compiled signatures.",
                      f"# TYPE {prefix}_cache_entries gauge",
                      f"{prefix}_cache_entries {cache['entries']}"]
        if self.memory_fn is not None:
            lines += [f"# HELP {prefix}_model_bytes Device bytes "
                      "attributed to the active model's compiled "
                      "signatures (memory ledger, serving_cache).",
                      f"# TYPE {prefix}_model_bytes gauge",
                      f"{prefix}_model_bytes {self._model_bytes()}"]
        lines += [f"# HELP {prefix}_uptime_seconds Server uptime.",
                  f"# TYPE {prefix}_uptime_seconds gauge",
                  f"{prefix}_uptime_seconds {_fmt(round(up, 3))}"]
        return "\n".join(lines) + "\n"

    def render_json(self) -> dict:
        up = max(time.time() - self.started, 1e-9)
        return {
            "model": self.name,
            "uptime_s": round(up, 3),
            "requests_total": self.requests_total.value,
            "responses_total": self.responses_total.value,
            "rejected": self.rejected_total.by_label(),
            "batches_total": self.batches_total.value,
            "dispatched_rows_total": self.dispatched_rows_total.value,
            "padded_rows_total": self.padded_rows_total.value,
            "queue_depth": self.queue_depth.value,
            "queue_depth_peak": self.queue_depth.peak,
            "throughput_rps": round(self.responses_total.value / up, 3),
            "latency_ms": {
                "queue": self.queue_ms.snapshot(),
                "batch": self.batch_ms.snapshot(),
                "compute": self.compute_ms.snapshot(),
                "total": self.total_ms.snapshot(),
            },
            "batch_size": self.batch_size.snapshot(),
            "cache": self._cache_counts(),
            "model_bytes": self._model_bytes(),
        }

    def render_json_text(self) -> str:
        return json.dumps(self.render_json())
