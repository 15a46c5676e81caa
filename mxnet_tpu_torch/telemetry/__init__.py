"""Telemetry of the port (ref: the JAX package's ``telemetry/``): what
``fit.FitLoop`` and the trainers report through.

- :mod:`.tracer` — thread-safe span tracer with a bounded ring buffer,
  category filtering and the ``MXTPU_PROFILE`` grammar; one flag check
  per span when off.
- :mod:`.chrome_trace` — Chrome trace-event JSON export (Perfetto) and
  its strict validator.
- :mod:`.registry` — the shared metrics registry (counters / gauges /
  histograms, Prometheus and JSON export); signature caches, kvstore
  retries, chaos injections, update dispatches, compiles (graph
  captures, nvcc, NVRTC) and device-memory watermarks land in the
  default registry.
- :mod:`.step_breakdown` — per-step exclusive time of data_wait / h2d /
  compute / optimizer / comm / checkpoint, with the input-bound /
  comm-bound detector.
- :mod:`.memory` — the live-byte ledger by owner, per-step watermarks,
  the check against ``torch.cuda.memory_allocated()``, OOM forensics and
  the per-program attribution (``record_program`` ...).
- :mod:`.numerics` — per-parameter tensor statistics computed in the
  grouped update (``MXTPU_NUMERICS``), non-finite provenance and the
  loss-scale timeline.
- :mod:`.efficiency` — per-program FLOP / byte costs counted on one
  observed execution, and the live MFU / goodput rollup
  (``MXTPU_EFFICIENCY``, ``MXTPU_DEVICE_PEAK``).
- :mod:`.run_report` — the persistent per-run verdict
  (``MXTPU_RUN_REPORT_DIR``), read by ``tools/run_compare.py``.
- :mod:`.autotune` — the probe-then-lock knob tuner (``MXTPU_AUTOTUNE``).

``mxnet_tpu_torch.profiler`` is the MXNet facade over this package and
``mxnet_tpu_torch.monitor`` the Monitor fed by the numerics plane. The
collective ledger and comm health go with the process group (ROADMAP
A10).
"""
from __future__ import annotations

from .tracer import (Tracer, tracer, span, instant, counter_event, enabled,
                     configure, enable, disable)
from .chrome_trace import (chrome_trace_events, dump_chrome_trace,
                           validate_chrome_trace)
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       default_registry)
from .step_breakdown import (StepBreakdown, segment, current_breakdown,
                             SEGMENTS)
from . import memory
from .memory import (MemoryLedger, ledger as memory_ledger, dump_forensics)
from . import numerics
from .numerics import NumericsPlane, plane as numerics_plane
from . import efficiency
from .efficiency import (EfficiencyRollup, compiled_program_stats,
                         rollup as efficiency_rollup)
from . import run_report
from .run_report import write_run_report, load_run_report
from . import autotune

__all__ = [
    "Tracer", "tracer", "span", "instant", "counter_event", "enabled",
    "configure", "enable", "disable",
    "chrome_trace_events", "dump_chrome_trace", "validate_chrome_trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "StepBreakdown", "segment", "current_breakdown", "SEGMENTS",
    "memory", "MemoryLedger", "memory_ledger", "dump_forensics",
    "numerics", "NumericsPlane", "numerics_plane",
    "efficiency", "EfficiencyRollup", "compiled_program_stats",
    "efficiency_rollup",
    "run_report", "write_run_report", "load_run_report", "autotune",
]
