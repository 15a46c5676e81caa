"""Telemetry of the port (ref: the JAX package's ``telemetry/``): what
``fit.FitLoop`` reports through.

- :mod:`.tracer` — thread-safe span tracer with a bounded ring buffer,
  category filtering and the ``MXTPU_PROFILE`` grammar; one flag check
  per span when off.
- :mod:`.chrome_trace` — Chrome trace-event JSON export (Perfetto) and
  its strict validator.
- :mod:`.step_breakdown` — per-step exclusive time of data_wait / h2d /
  compute / optimizer / comm / checkpoint, with the input-bound /
  comm-bound detector.
- :mod:`.memory` — the live-byte ledger by owner (params, grads,
  optimizer state, masters, staged batches), per-step watermarks, the
  check against ``torch.cuda.memory_allocated()`` and OOM forensics.
- :mod:`.numerics` and :mod:`.efficiency` — those planes' off states
  (the loss-scale timeline is kept with the plane off); on, they raise
  ``NotPortedError``.

Not ported (ROADMAP A9): the metrics registry, the compiled-program half
of the memory ledger, the numerics and efficiency planes, the run
report, the autotuner; the collective ledger and comm health go with the
process group (A10).
"""
from __future__ import annotations

from .tracer import (Tracer, tracer, span, instant, counter_event, enabled,
                     configure, enable, disable)
from .chrome_trace import (chrome_trace_events, dump_chrome_trace,
                           validate_chrome_trace)
from .step_breakdown import (StepBreakdown, segment, current_breakdown,
                             SEGMENTS)
from . import memory
from .memory import (MemoryLedger, ledger as memory_ledger, dump_forensics)
from . import numerics
from . import efficiency

__all__ = [
    "Tracer", "tracer", "span", "instant", "counter_event", "enabled",
    "configure", "enable", "disable",
    "chrome_trace_events", "dump_chrome_trace", "validate_chrome_trace",
    "StepBreakdown", "segment", "current_breakdown", "SEGMENTS",
    "memory", "MemoryLedger", "memory_ledger", "dump_forensics",
    "numerics", "efficiency",
]
