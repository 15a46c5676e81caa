"""Chrome trace-event JSON exporter + strict validator (a copy of the JAX
package's ``telemetry/chrome_trace.py``).

Reference: src/profiler/profiler.cc dumps the trace-event ``JSON Array
Format`` consumed by chrome://tracing; this exporter emits the richer
``JSON Object Format`` ({"traceEvents": [...]}) that Perfetto also loads,
with process/thread metadata events so ranks and thread names label the
tracks.

The validator is the contract the exporter (and every producer routing
through it — serving spans, op dispatch, step breakdown) is held to by the
test-suite: required keys per phase, numeric ``ts``/``dur``, and proper
per-thread span nesting (a thread's "X" spans must form a forest — strictly
nested or disjoint, never partially overlapping).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Union

from .tracer import Tracer, tracer as _default_tracer

__all__ = ["chrome_trace_events", "dump_chrome_trace",
           "validate_chrome_trace"]

#: phases the exporter may emit / the validator accepts
_PHASES = {"X", "i", "I", "C", "M", "B", "E"}

#: keys every event must carry, plus per-phase requirements
_REQUIRED = {"name", "ph", "ts", "pid", "tid"}


def chrome_trace_events(tr: Optional[Tracer] = None) -> List[Dict[str, Any]]:
    """Serialize a tracer's ring buffer into trace-event dicts, prefixed
    with process/thread metadata events."""
    tr = tr or _default_tracer
    events: List[Dict[str, Any]] = []
    rank = tr.rank
    events.append({"name": "process_name", "ph": "M", "ts": 0.0,
                   "pid": rank, "tid": 0,
                   "args": {"name": f"rank{rank}"}})
    # wall-clock anchor: trace ts 0 == epoch second epoch_t0_s on this
    # rank's clock, which runs clock_offset_ms ahead of rank 0's
    # (telemetry.collective.sync_clocks). tools/fleet_trace.py uses this
    # pair to merge N per-rank traces onto one aligned clock.
    events.append({"name": "clock_sync", "ph": "M", "ts": 0.0,
                   "pid": rank, "tid": 0,
                   "args": {"epoch_t0_s": float(tr.epoch_anchor),
                            "clock_offset_ms":
                            float(getattr(tr, "clock_offset_ms", 0.0))}})
    for tid, tname in sorted(tr.thread_names().items()):
        events.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                       "pid": rank, "tid": tid,
                       "args": {"name": tname}})
    for ev in tr.events():
        out = {"name": ev["name"], "cat": ev.get("cat", "default"),
               "ph": ev.get("ph", "X"), "ts": float(ev["ts"]),
               "pid": int(ev["pid"]), "tid": int(ev["tid"])}
        if out["ph"] == "X":
            out["dur"] = float(ev.get("dur", 0.0))
        if ev.get("ph") == "i":
            out["s"] = ev.get("s", "t")
        if "args" in ev:
            out["args"] = ev["args"]
        events.append(out)
    return events


def dump_chrome_trace(path: Optional[str] = None,
                      tracer: Optional[Tracer] = None) -> Dict[str, Any]:
    """Export the tracer as a chrome-trace object; write JSON to ``path``
    when given. Returns the trace dict (validator-clean by construction)."""
    payload = {"traceEvents": chrome_trace_events(tracer),
               "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(payload, f)
    return payload


def _fail(msg: str) -> None:
    raise ValueError(f"chrome-trace validation failed: {msg}")


def validate_chrome_trace(trace: Union[str, Dict[str, Any]],
                          require_complete: bool = True) -> List[dict]:
    """Strictly validate a chrome-trace payload; returns the event list.

    Checks (raises ``ValueError`` on the first violation):

    - top level is an object with a ``traceEvents`` list (a JSON string is
      parsed first);
    - every event is an object carrying ``name``/``ph``/``ts``/``pid``/
      ``tid`` with the right types, ``ph`` drawn from the known phase set;
    - ``X`` events carry a numeric non-negative ``dur``;
    - ``C`` events carry an ``args`` object (the sampled values);
    - per (pid, tid), ``X`` spans form a forest: sorted by start time they
      are strictly nested or disjoint — partial overlap on one thread means
      broken instrumentation (a span outlived its parent);
    - ``require_complete``: at least one non-metadata event exists.
    """
    if isinstance(trace, (str, bytes)):
        try:
            trace = json.loads(trace)
        except json.JSONDecodeError as e:
            _fail(f"not valid JSON ({e})")
    if not isinstance(trace, dict):
        _fail(f"top level must be an object, got {type(trace).__name__}")
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        _fail("missing 'traceEvents' list")
    per_thread: Dict[tuple, List[tuple]] = {}
    substantive = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            _fail(f"event {i} is not an object")
        missing = _REQUIRED - set(ev)
        if missing:
            _fail(f"event {i} ({ev.get('name')!r}) missing keys "
                  f"{sorted(missing)}")
        if not isinstance(ev["name"], str):
            _fail(f"event {i}: 'name' must be a string")
        ph = ev["ph"]
        if ph not in _PHASES:
            _fail(f"event {i} ({ev['name']!r}): unknown phase {ph!r}")
        if not isinstance(ev["ts"], (int, float)) or \
                isinstance(ev["ts"], bool):
            _fail(f"event {i} ({ev['name']!r}): 'ts' must be numeric")
        for key in ("pid", "tid"):
            if not isinstance(ev[key], int) or isinstance(ev[key], bool):
                _fail(f"event {i} ({ev['name']!r}): {key!r} must be an int")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or isinstance(dur, bool):
                _fail(f"event {i} ({ev['name']!r}): 'X' event needs a "
                      "numeric 'dur'")
            if dur < 0:
                _fail(f"event {i} ({ev['name']!r}): negative dur {dur}")
            if ev["ts"] < 0:
                _fail(f"event {i} ({ev['name']!r}): negative ts {ev['ts']}")
            per_thread.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(dur), ev["name"]))
        if ph == "C" and not isinstance(ev.get("args"), dict):
            _fail(f"event {i} ({ev['name']!r}): 'C' event needs an "
                  "'args' object")
        if ph != "M":
            substantive += 1
    # monotonic per-thread nesting: within one thread the span set must be
    # a forest (timer misuse shows up as partial overlap)
    eps = 0.5  # µs slack: perf_counter quantization on coarse clocks
    for (pid, tid), spans in per_thread.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[tuple] = []  # (end_ts, name)
        for ts, dur, name in spans:
            while stack and stack[-1][0] <= ts + eps:
                stack.pop()
            if stack and ts + dur > stack[-1][0] + eps:
                _fail(f"thread ({pid}, {tid}): span {name!r} "
                      f"[{ts:.1f}, {ts + dur:.1f}] partially overlaps "
                      f"enclosing span {stack[-1][1]!r} ending at "
                      f"{stack[-1][0]:.1f}")
            stack.append((ts + dur, name))
    if require_complete and substantive == 0:
        _fail("trace holds no events beyond metadata")
    return events
