"""Profiler: MXNet-compatible facade over the port's tracer (ref: the JAX
package's ``profiler.py``; src/profiler/profiler.h and
python/mxnet/profiler.py in the reference).

The span store, ring buffer and exporters live in
:mod:`mxnet_tpu_torch.telemetry`; this module keeps the reference's API
(``set_config`` / ``set_state`` / ``dump`` / ``dumps`` / ``pause`` /
``resume``, ``Domain`` / ``Task`` / ``Event`` / ``Frame`` / ``Counter`` /
``Marker``, ``record_span``, ``events``), all delegating to the shared
tracer. Device-level tracing (``start_xla_trace`` / ``stop_xla_trace``,
the JAX package's names) wraps ``torch.profiler`` with the CPU and CUDA
activities and writes a Chrome trace (``trace_<pid>_<n>.json``) into
``logdir``. ``profile_process='server'`` routes commands over the dist
kvstore's command channel, which comes with the process group: it raises
``NotPortedError`` (ROADMAP A10).
"""
from __future__ import annotations

import atexit
import json
import time
from typing import Any, Dict, List, Optional

import itertools
import os

from .base import check, env
from .ops.registry import NotPortedError
from .telemetry import chrome_trace as _ct
from .telemetry.tracer import tracer as _tracer

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "pause",
           "resume", "Domain", "Task", "Event", "Frame", "Counter",
           "Marker", "record_span", "events", "start_xla_trace",
           "stop_xla_trace", "set_kvstore_handle"]

def set_kvstore_handle(kv) -> None:
    """(ref: profiler.set_kvstore_handle) A dist kvstore is ROADMAP A10."""
    raise NotPortedError("profiler.set_kvstore_handle: the dist kvstore "
                         "is not ported yet (ROADMAP.md, queue A10)")


def _route_server(cmd: str, body: str = "") -> bool:
    raise NotPortedError(
        f"profiler {cmd} with profile_process='server' rides the dist "
        "kvstore's command channel, which is not ported yet (ROADMAP.md, "
        "queue A10)")


_config = {"filename": "profile.json", "profile_all": False,
           "profile_symbolic": True, "profile_imperative": True,
           "profile_memory": False, "profile_api": False,
           "aggregate_stats": False, "continuous_dump": False}


def set_config(profile_process: str = "worker", **kwargs) -> None:
    """(ref: MXSetProcessProfilerConfig / python profiler.set_config)"""
    if profile_process == "server":
        _route_server("set_config", json.dumps(kwargs))
        return
    for k, v in kwargs.items():
        _config[k] = v
    _tracer.set_aggregate(bool(_config.get("aggregate_stats")))


def set_state(state_name: str = "stop",
              profile_process: str = "worker") -> None:
    check(state_name in ("run", "stop"), "state must be run|stop")
    if profile_process == "server":
        _route_server("state", state_name)
        return
    was = _tracer._on  # not .enabled: a paused profiler still dumps on stop
    if state_name == "run":
        _tracer.set_aggregate(bool(_config.get("aggregate_stats")))
        _tracer.enable()
    else:
        _tracer.disable()
        if was and _config.get("continuous_dump"):
            dump()


def state() -> str:
    return "run" if _tracer._on else "stop"


def pause(profile_process: str = "worker") -> None:
    if profile_process == "server":
        _route_server("pause")
        return
    _tracer.pause()


def resume(profile_process: str = "worker") -> None:
    if profile_process == "server":
        _route_server("resume")
        return
    _tracer.resume()


def is_active() -> bool:
    return _tracer.enabled


def record_span(name: str, category: str, t_start: float, t_end: float,
                args: Optional[dict] = None) -> None:
    """Append one complete event (chrome trace 'X' phase)."""
    _tracer.record(name, category, t_start, t_end, args)


def events(category: Optional[str] = None) -> List[Dict[str, Any]]:
    """Snapshot of recorded trace events, optionally filtered by category
    — lets subsystems (e.g. serving's metrics plane) and tests inspect
    their spans without round-tripping through a dump file."""
    evs = _tracer.events(category)
    for e in evs:  # historical shape: every event carries ph + args
        e.setdefault("ph", "X")
        e.setdefault("args", {})
    return evs


def dump(finished: bool = True, profile_process: str = "worker") -> None:
    """Write chrome-trace JSON (ref: profiler.h:437 dump to profile.json)."""
    if profile_process == "server":
        _route_server("dump")
        return
    _ct.dump_chrome_trace(_config["filename"])


def dumps(reset: bool = False) -> str:
    """Aggregate stats table (ref: AggregateStats dump, mx.profiler.dumps)."""
    return _tracer.aggregate_table(reset)


class Domain:
    """(ref: profiler.h ProfileDomain)"""

    def __init__(self, name: str):
        self.name = name


class _Scope:
    _category = "scope"

    def __init__(self, name: str, domain: Optional[Domain] = None):
        self.name = name if domain is None else f"{domain.name}:{name}"
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is not None:
            record_span(self.name, self._category, self._start,
                        time.perf_counter())
            self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


class Task(_Scope):
    _category = "task"


class Event(_Scope):
    _category = "event"


class Frame(_Scope):
    _category = "frame"


class Marker:
    def __init__(self, name: str, domain: Optional[Domain] = None):
        self.name = name

    def mark(self, scope: str = "process") -> None:
        _tracer.instant(self.name, "marker")


class Counter:
    """(ref: profiler.h ProfileCounter)"""

    def __init__(self, name: str, domain: Optional[Domain] = None, value=0):
        self.name = name
        self.value = value

    def set_value(self, value) -> None:
        self.value = value
        _tracer.counter_event(self.name, value)

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)

    __iadd__ = lambda self, d: (self.increment(d), self)[1]
    __isub__ = lambda self, d: (self.decrement(d), self)[1]


# -- device-level tracing (torch.profiler) ---------------------------------

_xla_trace = None       # (torch.profiler.profile, logdir)
_trace_seq = itertools.count(1)


def start_xla_trace(logdir: str = "mxnet_tpu_torch_trace") -> None:
    """Start a device-level profile: ``torch.profiler`` over the CPU and
    (with a card) CUDA activities. The JAX package's name is kept."""
    global _xla_trace
    import torch
    check(_xla_trace is None, "start_xla_trace: a trace is running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _xla_trace = (prof, logdir)


def stop_xla_trace() -> Optional[str]:
    """Stop the trace and write it as Chrome trace JSON into its
    ``logdir``; returns the file's path (None when no trace ran)."""
    global _xla_trace
    if _xla_trace is None:
        return None
    prof, logdir = _xla_trace
    _xla_trace = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{next(_trace_seq)}.json")
    prof.export_chrome_trace(path)
    return path


if env.get("MXNET_PROFILER_AUTOSTART"):
    set_state("run")
    atexit.register(dump)
