"""Per-step time breakdown: where does the step time go? (A copy of the
JAX package's ``telemetry/step_breakdown.py``.)

The first question any training-stack operator asks. ``fit.FitLoop`` (and
anything else that wants it) brackets each step's phases with
:func:`segment`; this module turns the brackets into

- tracer spans (category = segment name) for the chrome trace, and
- per-step **exclusive** second counts per segment — a segment nested
  inside another (h2d staging inside data_wait, a kvstore push inside comm)
  is charged once, to the innermost bracket, so the per-step segment sums
  compare directly against wall-clock step time.

Segments (the canonical set; producers may add their own names):

===============  ======================================================
data_wait        blocked on the input pipeline (iterator next())
h2d              host->device staging of batch arrays
compute          forward + backward + device sync of the loss
megastep         the ONE fused step program under ``MXTPU_MEGASTEP`` —
                 forward + backward + sentinel + update (+ in-graph
                 collectives) in a single dispatch; replaces
                 compute/optimizer/comm for the step and is exempt from
                 the bound detector exactly like ``compute`` (it IS the
                 compute)
optimizer        parameter update (incl. the fused sentinel reduction)
comm             gradient allreduce / kvstore push-pull after backward
comm_overlapped  collectives launched DURING backward by the overlap
                 scheduler (``MXTPU_COMM_OVERLAP``) — nested inside
                 ``compute``, charged exclusively here so overlapped
                 communication is neither double-counted against compute
                 nor silently vanished
checkpoint       checkpoint writes on the step path
===============  ======================================================

The **input-bound / comm-bound detector**: at each step end, any
non-compute segment whose share of wall-clock exceeds
``MXTPU_PROFILE_BOUND_FRAC`` (default 0.4) logs a one-line diagnosis
naming the bound segment, its share, and the first lever to reach for.
When a controller (the autotuner, :mod:`.autotune`) has already pulled
that lever, :meth:`StepBreakdown.note_action` upgrades the line from
diagnosis to "diagnosis → action taken". When the comm-health plane
(:mod:`.collective`, ``MXTPU_COLL_HEALTH``) has attributed collective
entry-time skew to a straggler rank (:meth:`StepBreakdown
.note_comm_health`), a comm-bound diagnosis upgrades to the
**straggler-bound** variant: the time is not wire bandwidth but one
rank arriving late at every collective, and the lever is that rank's
input pipeline / host, not the comm knobs.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

from ..base import env
from ..log import get_logger
from . import memory as _memory
from .tracer import tracer as _tracer

__all__ = ["SEGMENTS", "StepBreakdown", "segment", "current_breakdown"]

_LOG = get_logger("mxnet_tpu_torch.telemetry")

SEGMENTS = ("data_wait", "h2d", "compute", "megastep", "optimizer",
            "comm", "comm_overlapped", "checkpoint")

#: remedy hint per over-threshold segment (the one-line diagnosis tail)
_ADVICE = {
    "data_wait": "input-bound: add decode threads / PrefetchingIter "
                 "or stage with DeviceStagingIter",
    "h2d": "transfer-bound: overlap H2D with DeviceStagingIter(depth>1)",
    "comm": "comm-bound: enable MXTPU_COMM_OVERLAP / MXTPU_AUTOTUNE, "
            "raise MXTPU_GRAD_BUCKET_MB or enable gradient compression",
    "comm_overlapped": "comm-bound despite overlap: collectives outlast "
                       "backward — raise MXTPU_GRAD_BUCKET_MB or enable "
                       "gradient compression",
    "optimizer": "update-bound: raise MXTPU_OPTIMIZER_AGGREGATION",
    "checkpoint": "ckpt-bound: raise ckpt_every or use async_ckpt=True",
}

_tls = threading.local()


def current_breakdown() -> Optional["StepBreakdown"]:
    """The breakdown collecting on this thread, if any."""
    return getattr(_tls, "active", None)


class _Segment:
    """Context manager: tracer span + exclusive-time charge to the active
    breakdown. Nested segments subtract their time from the enclosing one
    (self-time accounting), so one wall-second is never charged twice."""
    __slots__ = ("_name", "_args", "_t0", "_child")

    def __init__(self, name: str, args: Optional[dict]):
        self._name = name
        self._args = args
        self._child = 0.0

    def __enter__(self):
        bd = getattr(_tls, "active", None)
        if bd is not None:
            bd._stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        t1 = time.perf_counter()
        dt = t1 - self._t0
        _tracer.record(self._name, self._name, self._t0, t1, self._args)
        bd = getattr(_tls, "active", None)
        if bd is not None and bd._stack and bd._stack[-1] is self:
            bd._stack.pop()
            bd._charge(self._name, max(dt - self._child, 0.0))
            if bd._stack:
                bd._stack[-1]._child += dt
        return False


class _NoopSegment:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP = _NoopSegment()


def segment(name: str, args: Optional[dict] = None):
    """Bracket one step phase. No-op (no clock reads) unless the tracer is
    enabled or a StepBreakdown is collecting on this thread."""
    if not _tracer.enabled and getattr(_tls, "active", None) is None:
        return _NOOP
    return _Segment(name, args)


class StepBreakdown:
    """Collects per-step exclusive segment seconds and runs the
    input-bound / comm-bound detector.

    Usage (FitLoop does exactly this)::

        bd = StepBreakdown()
        bd.install()                    # this thread's segments charge here
        for batch in it:
            bd.begin_step(step)
            with segment("compute"):
                ...
            bd.end_step()               # detector + per-step record
        bd.uninstall()
        bd.summary()                    # aggregate shares
    """

    #: per-step records retained (aggregates cover the full run)
    RECENT_STEPS = 64
    #: diagnosis strings retained; past this only counters advance
    MAX_DIAGNOSES = 100
    #: per-segment warning cadence after the first few occurrences
    _LOG_EVERY = 100

    def __init__(self, bound_frac: Optional[float] = None,
                 emit_counters: bool = True):
        if bound_frac is None:
            bound_frac = float(env.get("MXTPU_PROFILE_BOUND_FRAC"))
        self.bound_frac = float(bound_frac)
        self._emit_counters = emit_counters
        # bounded recent window; full-run aggregates live in _totals so a
        # 1M-step fit() never accrues a million per-step dicts
        self.steps: deque = deque(maxlen=self.RECENT_STEPS)
        self._totals: Dict[str, float] = defaultdict(float)
        self._wall_total = 0.0
        self._n_steps = 0
        # per-step memory watermarks (parallel to `steps`, NOT folded into
        # the segment records — those are second counts that sum against
        # wall-clock; a byte count in there would break that contract)
        self.mem_steps: deque = deque(maxlen=self.RECENT_STEPS)
        self._mem_peak_run = 0
        self._cur: Dict[str, float] = defaultdict(float)
        self._step_t0: Optional[float] = None
        self._step_id: Optional[int] = None
        self._stack: List[_Segment] = []
        self.diagnoses: List[str] = []
        self._diag_counts: Dict[str, int] = defaultdict(int)
        # segment -> description of the remedy a controller already
        # applied (autotuner lock); upgrades the detector's line from
        # diagnosis to "diagnosis → action taken"
        self.actions: Dict[str, str] = {}
        # last comm-health comparison (telemetry.collective.health_check
        # feeds it): a known straggler turns a comm-bound diagnosis into
        # the straggler-bound variant
        self._comm_health: Optional[Dict[str, object]] = None
        self._last_marked_step = object()  # sentinel: != any step id

    # -- thread binding -------------------------------------------------
    def install(self) -> "StepBreakdown":
        _tls.active = self
        return self

    def uninstall(self) -> None:
        if getattr(_tls, "active", None) is self:
            _tls.active = None

    # -- per-step lifecycle ---------------------------------------------
    def note_action(self, segment_name: str, action: str) -> None:
        """Record that a controller acted on ``segment_name``'s lever
        (e.g. the autotuner locking a bigger gradient bucket). Subsequent
        detector lines for that segment read "… → action taken: …"."""
        self.actions[segment_name] = str(action)

    def note_comm_health(self, info) -> None:
        """Record the latest cross-rank comm-health comparison
        (``telemetry.collective.health_check`` calls this when handed a
        breakdown). A non-None straggler rank re-aims subsequent
        comm-bound diagnoses at that rank instead of the comm knobs."""
        self._comm_health = dict(info) if info else None

    def begin_step(self, step: Optional[int] = None) -> None:
        self._cur = defaultdict(float)
        self._stack = []
        self._step_id = step
        if _tracer.enabled and step != self._last_marked_step:
            # step delimiter in the trace: offline tools
            # (tools/trace_report.py) reconstruct per-step segment tables
            # from these markers without needing the live StepBreakdown.
            # Deduped by id: resume fast-forward replays begin_step with
            # the step frozen at the checkpoint — one marker, not one per
            # replayed batch (the replay's data_wait folds into that
            # step's row, which is the true cost of resuming there)
            self._last_marked_step = step
            _tracer.instant(f"step:{step}", "step")
        _memory.ledger().begin_window()
        self._step_t0 = time.perf_counter()

    def _charge(self, name: str, seconds: float) -> None:
        self._cur[name] += seconds

    def end_step(self) -> Dict[str, float]:
        """Close the step: record wall time, emit tracer counters, run the
        detector. Returns this step's {segment: seconds, 'wall': seconds}."""
        if self._step_t0 is None:
            return {}
        wall = time.perf_counter() - self._step_t0
        rec = dict(self._cur)
        rec["wall"] = wall
        self.steps.append(rec)
        self._n_steps += 1
        self._wall_total += wall
        for name, s in self._cur.items():
            self._totals[name] += s
        if self._emit_counters and _tracer.enabled and wall > 0:
            for name, s in rec.items():
                if name != "wall":
                    _tracer.counter_event(f"step_share:{name}", s / wall)
        # memory axis: the ledger window opened in begin_step closes here.
        # Kept OUT of the segment record (bytes vs seconds); the counter
        # events give Perfetto a per-category memory track aligned with
        # the step markers, and `device_memory_peak` is byte-identical to
        # the per-step record FitResult publishes (test-enforced).
        led = _memory.ledger()
        mem_peak, mem_delta = led.window_stats()
        if mem_peak > self._mem_peak_run:
            self._mem_peak_run = mem_peak
        self.mem_steps.append({"step": self._step_id,
                               "peak_bytes": int(mem_peak),
                               "delta_bytes": int(mem_delta),
                               "live_bytes": int(led.live_bytes())})
        if self._emit_counters and _tracer.enabled:
            _tracer.counter_event("device_memory", led.snapshot(),
                                  category="memory")
            _tracer.counter_event("device_memory_peak", mem_peak,
                                  category="memory")
        self._detect(rec, wall)
        self._step_t0 = None
        return rec

    def _detect(self, rec: Dict[str, float], wall: float) -> None:
        if wall <= 0 or self.bound_frac <= 0:
            return
        for name, s in sorted(rec.items(), key=lambda kv: -kv[1]):
            if name in ("wall", "compute", "megastep"):
                continue
            frac = s / wall
            if frac >= self.bound_frac:
                advice = _ADVICE.get(name, "non-compute bound")
                if name in ("comm", "comm_overlapped"):
                    advice = self._straggler_advice() or advice
                msg = (f"step {self._step_id}: {name} is {frac:.0%} of "
                       f"step time ({s * 1e3:.1f}ms of {wall * 1e3:.1f}ms) "
                       f"— {advice}")
                if name in self.actions:
                    msg += f" → action taken: {self.actions[name]}"
                if len(self.diagnoses) < self.MAX_DIAGNOSES:
                    self.diagnoses.append(msg)
                # a persistently bound run must not warn once per step:
                # first 3 occurrences per segment, then every 100th
                self._diag_counts[name] += 1
                n = self._diag_counts[name]
                if n <= 3 or n % self._LOG_EVERY == 0:
                    if n > 3:
                        msg += f" [{n} occurrences]"
                    _LOG.warning(msg)

    def _straggler_advice(self) -> Optional[str]:
        """The straggler-bound diagnosis tail, when the comm-health plane
        has attributed the comm time to one rank entering collectives
        late — the comm knobs cannot fix a straggler."""
        ch = self._comm_health
        if not ch:
            return None
        rank = ch.get("straggler_rank")
        skew = float(ch.get("max_skew_ms") or 0.0)
        if rank is None or skew <= 0:
            return None
        return (f"straggler-bound: rank {rank} enters collectives up to "
                f"{skew:.1f}ms late (mxtpu_coll_skew_ms) — check that "
                "rank's input pipeline / host load before touching comm "
                "knobs")

    # -- aggregate ------------------------------------------------------
    def memory_summary(self) -> Dict[str, object]:
        """Per-step memory watermarks (bounded recent window) + the run
        peak, from the ledger windows opened/closed around each step."""
        return {"peak_bytes": int(self._mem_peak_run),
                "per_step": [dict(r) for r in self.mem_steps]}

    def summary(self) -> Dict[str, object]:
        """Aggregate over ALL recorded steps (running totals — not just
        the bounded recent window): total seconds and wall-clock shares
        per segment, plus step count and mean step seconds."""
        wall = self._wall_total
        shares = {name: (s / wall if wall > 0 else 0.0)
                  for name, s in self._totals.items()}
        accounted = sum(self._totals.values())
        return {
            "steps": self._n_steps,
            "wall_s": round(wall, 6),
            "mean_step_s": round(wall / self._n_steps, 6)
            if self._n_steps else 0.0,
            "seconds": {k: round(v, 6)
                        for k, v in sorted(self._totals.items())},
            "shares": {k: round(v, 4) for k, v in sorted(shares.items())},
            "accounted_frac": round(accounted / wall, 4) if wall > 0
            else 0.0,
            # recent per-step records (bounded so a 100k-step run's
            # summary stays a summary)
            "per_step": [{k: round(v, 6) for k, v in rec.items()}
                         for rec in self.steps],
            "diagnoses": list(self.diagnoses),
            "actions": dict(self.actions),
            "memory": self.memory_summary(),
        }
