"""Self-healing training fleet: a supervisor that turns failure
DETECTION into automatic resize-and-resume (ref: the JAX package's
``parallel/supervisor.py``; MXNet's ps-lite scheduler restarting dead
workers, PAPER.md §KVStore fault model).

The framework already detects every failure mode it cares about — the
hung-collective watchdog dumps a flight record naming the absent rank
(telemetry/collective.py), SIGTERM preemption drains to a final verified
checkpoint and exits with the resumable code (fit.py), elastic resume
re-splits the data stream exactly at any world size (elastic.py). But
detection without REACTION still pages a human at 3am. This module is
the missing control loop: a per-job supervisor process (spawned by
``python -m mxnet_tpu_torch.launch --supervise``) that watches the worker group and the
watchdog's dump directory, and converts each detected failure into the
one mechanical response the lower layers already support:

* a rank exits with the resumable code (preemption drain, chaos
  ``resize@N``) → relaunch at the checkpoint's requested world;
* a rank dies with any other code or a signal → signal survivors to
  checkpoint-and-exit, relaunch at the surviving world under
  ``MXTPU_ELASTIC=on``;
* a hung collective → the watchdog flight record names the absent rank;
  same shrink path (survivors are SIGTERMed out of the wedged
  collective — the drain-to-checkpoint flag is step-boundary safe);
* capacity returns (pluggable :class:`CapacityModel`; the stock one
  models spot/preemption recovery) → grow back toward the target world.

The escalation ladder is BOUNDED and is factored out as the pure
function :func:`decide` so every rung is table-testable without a
process tree:

1. transient coordination-service flake → the existing retry/backoff in
   the transport already absorbed it; the supervisor only logs;
2. hung collective / rank death → shrink to survivors and resume;
3. repeated crash of the SAME rank slot within
   ``MXTPU_SUPERVISE_CRASH_WINDOW_S`` → exclude the slot (continue
   smaller) instead of relaunching into the same bad host forever;
4. restart budget ``MXTPU_SUPERVISE_MAX_RESTARTS`` exhausted → fail
   LOUDLY with a forensic bundle (merged fleet trace when traces exist,
   every flight record, the last run report, the full event history) —
   never an infinite relaunch loop.

Correctness contract: across any sequence of kills, hangs and resizes the union
of trained samples equals the no-failure stream exactly — zero
duplicated, zero dropped — and the post-resize loss trajectory matches a
never-failed run at the same global batch size. The supervisor never
touches training state; it only decides WHO runs and WHEN, and the
checkpoint + re-split machinery (``fault.py``, ``parallel/elastic.py``)
makes any world transition exact.

Every generation's workers form a new ``torch.distributed`` group on a
fresh coordinator port (a group cannot change its size), so a shrink or
a grow is a drain to a checkpoint and a relaunch at the new world.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, check, env

__all__ = [
    "EVENT_KINDS", "classify_exit", "decide",
    "CapacityModel", "StaticCapacity", "SpotCapacityModel",
    "Supervisor", "write_forensic_bundle",
    "supervise_max_restarts", "supervise_crash_window_s",
    "supervise_crash_limit",
]

# Every failure event the supervisor reasons about, in escalation order.
# ``flake`` is observational (the transport's own retry/backoff already
# absorbed it); the other four terminate a fleet generation.
EVENT_KINDS = ("flake", "hang", "crash", "signal", "resumable")

# Kinds that consume the restart budget: each one forces a relaunch.
# Capacity-driven grows do NOT — growing back to target when a spot
# slot returns is the system working, not the system failing.
_RESTART_KINDS = ("hang", "crash", "signal", "resumable")


# ---------------------------------------------------------------------------
# Env knobs (strict parse — the MXTPU_ZERO discipline: a typo'd budget
# must not silently become an infinite relaunch loop).

def supervise_max_restarts() -> int:
    try:
        n = int(env.get("MXTPU_SUPERVISE_MAX_RESTARTS"))
    except (TypeError, ValueError):
        raise MXNetError(
            "MXTPU_SUPERVISE_MAX_RESTARTS: expected an integer, got "
            f"{env.raw('MXTPU_SUPERVISE_MAX_RESTARTS')!r}")
    check(n >= 0, f"MXTPU_SUPERVISE_MAX_RESTARTS: must be >= 0, got {n}")
    return n


def supervise_crash_window_s() -> float:
    try:
        s = float(env.get("MXTPU_SUPERVISE_CRASH_WINDOW_S"))
    except (TypeError, ValueError):
        raise MXNetError(
            "MXTPU_SUPERVISE_CRASH_WINDOW_S: expected a number, got "
            f"{env.raw('MXTPU_SUPERVISE_CRASH_WINDOW_S')!r}")
    check(s > 0, f"MXTPU_SUPERVISE_CRASH_WINDOW_S: must be > 0, got {s}")
    return s


def supervise_crash_limit() -> int:
    try:
        n = int(env.get("MXTPU_SUPERVISE_CRASH_LIMIT"))
    except (TypeError, ValueError):
        raise MXNetError(
            "MXTPU_SUPERVISE_CRASH_LIMIT: expected an integer, got "
            f"{env.raw('MXTPU_SUPERVISE_CRASH_LIMIT')!r}")
    check(n >= 1, f"MXTPU_SUPERVISE_CRASH_LIMIT: must be >= 1, got {n}")
    return n


def _resumable_code() -> int:
    from .. import fit
    return fit.resumable_exit_code()


def classify_exit(rc: Optional[int]) -> str:
    """Exit-code taxonomy shared with ``launch.py``: ``"ok"`` (0),
    ``"resumable"`` (the MXTPU_RESUMABLE_EXIT_CODE drain code, default
    75/EX_TEMPFAIL), ``"signal"`` (negative — Popen's killed-by-signal
    convention), ``"fatal"`` (everything else). ``None`` (still
    running) is a caller bug."""
    check(rc is not None, "classify_exit: process has not exited")
    if rc == 0:
        return "ok"
    if rc == _resumable_code():
        return "resumable"
    if rc < 0:
        return "signal"
    return "fatal"


# ---------------------------------------------------------------------------
# The escalation ladder, as a pure function of the event history.

def decide(events: Sequence[Dict[str, Any]], *, world: int,
           floor: int = 1,
           max_restarts: Optional[int] = None,
           crash_window_s: Optional[float] = None,
           crash_limit: Optional[int] = None) -> Dict[str, Any]:
    """What the supervisor does about the LATEST event in ``events``.

    Pure: no clock, no process tree, no env reads when all knobs are
    passed — the whole ladder is table-testable. Each event is a dict
    ``{"kind": one of EVENT_KINDS, "rank": int|None, "time": float,
    "ranks": [int, ...] (optional, defaults to [rank])}`` with ``time``
    on any monotonic clock (only differences are compared).

    Returns one action dict:

    * ``{"op": "retry"}`` — rung 1: the latest event is a transient kv
      flake; the transport's retry/backoff already handled it, nothing
      to relaunch.
    * ``{"op": "fail", "reason": ...}`` — rung 4: the restart budget is
      exhausted (or a shrink/exclude would go below ``floor``); the
      caller must write the forensic bundle and exit nonzero.
    * ``{"op": "exclude", "rank": r, "world": w}`` — rung 3: rank slot
      ``r`` crashed ``crash_limit`` times within ``crash_window_s``;
      continue at ``w = world - 1`` with the slot excluded.
    * ``{"op": "shrink", "world": w, "lost": [...]}`` — rung 2: relaunch
      at the surviving world under elastic resume.
    * ``{"op": "resume", "world": world}`` — every rank drained with the
      resumable code; relaunch at the same world (the caller then honors
      any ``resize_to`` the final checkpoint requested).
    """
    check(len(events) > 0, "decide: empty event history")
    if max_restarts is None:
        max_restarts = supervise_max_restarts()
    if crash_window_s is None:
        crash_window_s = supervise_crash_window_s()
    if crash_limit is None:
        crash_limit = supervise_crash_limit()
    ev = events[-1]
    kind = ev.get("kind")
    check(kind in EVENT_KINDS,
          f"decide: unknown event kind {kind!r} (known: {EVENT_KINDS})")

    # Rung 1: transient flake — already absorbed downstream.
    if kind == "flake":
        return {"op": "retry"}

    # Rung 4 (checked first among the relaunch rungs: a relaunch the
    # budget does not cover must not happen no matter which lower rung
    # would otherwise fire). The latest event IS a restart-requiring
    # incident at this point, so strictly-greater means "this relaunch
    # would be restart number max_restarts + 1".
    incidents = [e for e in events if e.get("kind") in _RESTART_KINDS]
    if len(incidents) > max_restarts:
        return {"op": "fail",
                "reason": f"restart budget exhausted: "
                          f"{len(incidents)} failure-driven relaunches "
                          f"needed, MXTPU_SUPERVISE_MAX_RESTARTS="
                          f"{max_restarts}"}

    # Rung 3: crash loop — the SAME slot keeps dying; relaunching it a
    # fourth time onto the same bad host is not resilience.
    if kind in ("crash", "signal") and ev.get("rank") is not None:
        rank, now = ev["rank"], ev.get("time", 0.0)
        recent = [e for e in events
                  if e.get("kind") in ("crash", "signal")
                  and e.get("rank") == rank
                  and now - e.get("time", 0.0) <= crash_window_s]
        if len(recent) >= crash_limit:
            if world - 1 < floor:
                return {"op": "fail",
                        "reason": f"rank slot {rank} crash-looped "
                                  f"({len(recent)}x within "
                                  f"{crash_window_s:g}s) and excluding "
                                  f"it would drop the fleet below the "
                                  f"floor of {floor}"}
            return {"op": "exclude", "rank": rank, "world": world - 1}

    # Rung 2: one-off death or hang — shrink to the survivors.
    if kind in ("hang", "crash", "signal"):
        lost = sorted(set(ev.get("ranks") or
                          ([ev["rank"]] if ev.get("rank") is not None
                           else [])))
        survivors = world - len(lost)
        if survivors < floor:
            # Whole-group death: nothing survived to shrink to, but the
            # last checkpoint did — relaunch at the floor (the budget
            # rung above bounds how often).
            survivors = floor
        return {"op": "shrink", "world": survivors, "lost": lost}

    # Graceful drain: every rank exited with the resumable code.
    return {"op": "resume", "world": world}


# ---------------------------------------------------------------------------
# Capacity models: how many rank slots COULD run right now.

class CapacityModel:
    """Pluggable answer to "how many slots does the scheduler offer"
    — the supervisor grows back toward the target world only when the
    model says the capacity exists. Subclass for a real scheduler
    (query the TPU pod manager, the k8s node pool, ...)."""

    def note_lost(self, n: int, now: float) -> None:  # pragma: no cover
        """A failure just took ``n`` slots away at monotonic ``now``."""

    def available(self, now: float) -> int:  # pragma: no cover
        raise NotImplementedError


class StaticCapacity(CapacityModel):
    """Capacity never moves: ``target`` slots, always (dedicated pod)."""

    def __init__(self, target: int):
        check(target >= 1, f"StaticCapacity: target must be >= 1, "
                           f"got {target}")
        self._target = target

    def note_lost(self, n: int, now: float) -> None:
        pass

    def available(self, now: float) -> int:
        return self._target


class SpotCapacityModel(CapacityModel):
    """Spot/preemption capacity: a lost slot comes back ``recovery_s``
    seconds later (the scheduler reschedules the preempted VM). This is
    the model the chaos soak exercises: kill a rank, watch the fleet
    shrink, watch it grow back once the modeled recovery elapses."""

    def __init__(self, target: int, recovery_s: float = 30.0):
        check(target >= 1, f"SpotCapacityModel: target must be >= 1, "
                           f"got {target}")
        check(recovery_s >= 0, f"SpotCapacityModel: recovery_s must be "
                               f">= 0, got {recovery_s}")
        self._target = target
        self._recovery_s = recovery_s
        self._lost: List[Tuple[float, int]] = []  # (when, how many)

    def note_lost(self, n: int, now: float) -> None:
        if n > 0:
            self._lost.append((now, n))

    def available(self, now: float) -> int:
        still_out = sum(n for t, n in self._lost
                        if now - t < self._recovery_s)
        return max(0, self._target - still_out)


# ---------------------------------------------------------------------------
# Forensic bundle: what rung 4 leaves behind instead of a relaunch.

def write_forensic_bundle(out_dir: str, *, events: Sequence[Dict],
                          summary: Dict[str, Any],
                          dump_dir: Optional[str] = None,
                          run_report_dir: Optional[str] = None,
                          trace_paths: Sequence[str] = ()) -> str:
    """Assemble the fail-loudly artifact: the full supervisor event
    history, every watchdog flight record, the newest run report, and —
    when per-rank chrome traces exist — the clock-aligned merged fleet
    trace (``parallel/fleet_trace.py``). Everything is COPIED into one
    directory with a SHA-256 manifest so the bundle survives the
    job's scratch space being reaped. Returns the bundle directory."""
    bdir = os.path.join(out_dir, "forensics")
    os.makedirs(bdir, exist_ok=True)
    contents: Dict[str, Any] = {"flight_records": [], "run_report": None,
                                "fleet_trace": None}

    with open(os.path.join(bdir, "events.json"), "w") as f:
        json.dump({"events": list(events), "summary": summary}, f,
                  indent=2, sort_keys=True, default=str)

    if dump_dir and os.path.isdir(dump_dir):
        for name in sorted(os.listdir(dump_dir)):
            if name.startswith("coll_flight_") and name.endswith(".json"):
                try:
                    shutil.copy2(os.path.join(dump_dir, name),
                                 os.path.join(bdir, name))
                    contents["flight_records"].append(name)
                except OSError:
                    pass

    if run_report_dir is None:
        run_report_dir = str(env.get("MXTPU_RUN_REPORT_DIR") or "")
    if run_report_dir and os.path.isdir(run_report_dir):
        reports = sorted(
            (n for n in os.listdir(run_report_dir) if n.endswith(".json")),
            key=lambda n: os.path.getmtime(os.path.join(run_report_dir, n)))
        if reports:
            try:
                shutil.copy2(os.path.join(run_report_dir, reports[-1]),
                             os.path.join(bdir, "last_run_report.json"))
                contents["run_report"] = reports[-1]
            except OSError:
                pass

    existing = [p for p in trace_paths if os.path.exists(p)]
    if existing:
        try:
            from . import fleet_trace
            merged = fleet_trace.merge(
                [fleet_trace.load_trace(p) for p in existing])
            with open(os.path.join(bdir, "fleet_trace.json"), "w") as f:
                json.dump({"traceEvents": merged}, f)
            contents["fleet_trace"] = "fleet_trace.json"
        except Exception:  # best-effort: a broken trace must not
            pass           # mask the failure being bundled

    with open(os.path.join(bdir, "MANIFEST.txt"), "w") as f:
        json.dump(contents, f, indent=2, sort_keys=True)
    try:
        from ..fault import write_manifest
        write_manifest(bdir)
    except Exception:
        pass
    return bdir


# ---------------------------------------------------------------------------
# The supervisor driver.

def _counter(name: str, doc: str):
    from ..telemetry import default_registry
    return default_registry().counter(name, doc)


class Supervisor:
    """The control loop. ``spawn(world, gen, extra_env)`` (provided by
    ``launch.py``) must start ``world`` worker processes and return
    ``{rank: subprocess.Popen}``; the supervisor owns everything after
    that: watching exits and the watchdog dump dir, terminating
    survivors, deciding via :func:`decide`, and relaunching.

    One fleet GENERATION = one spawn. Generation 0 is the fresh start;
    every later generation runs under ``MXTPU_ELASTIC=on`` +
    ``MXNET_IS_RECOVERY=1`` and resumes from the shared checkpoint
    stream. ``run()`` returns a process exit code: 0 when a generation
    ran to completion, nonzero after rung 4 wrote the forensic bundle.
    """

    def __init__(self, spawn: Callable[[int, int, Dict[str, str]],
                                       Dict[int, subprocess.Popen]],
                 target_world: int, *,
                 ckpt_dir: Optional[str] = None,
                 dump_dir: Optional[str] = None,
                 state_dir: Optional[str] = None,
                 capacity: Optional[CapacityModel] = None,
                 floor: int = 1,
                 term_grace_s: float = 5.0,
                 poll_s: float = 0.05,
                 max_restarts: Optional[int] = None,
                 crash_window_s: Optional[float] = None,
                 crash_limit: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 log: Callable[[str], None] = None):
        check(target_world >= 1,
              f"Supervisor: target_world must be >= 1, got {target_world}")
        self._spawn = spawn
        self._target = target_world
        self._ckpt_dir = ckpt_dir
        self._dump_dir = dump_dir or str(env.get("MXTPU_MEM_DUMP_DIR")
                                         or "") or None
        self._state_dir = state_dir
        self._capacity = capacity or StaticCapacity(target_world)
        self._floor = floor
        self._grace = term_grace_s
        self._poll = poll_s
        self._max_restarts = (supervise_max_restarts()
                              if max_restarts is None else max_restarts)
        self._crash_window = (supervise_crash_window_s()
                              if crash_window_s is None else crash_window_s)
        self._crash_limit = (supervise_crash_limit()
                             if crash_limit is None else crash_limit)
        self._clock = clock
        self._log = log or (lambda m: print(f"[supervisor] {m}",
                                            file=sys.stderr, flush=True))
        self.events: List[Dict[str, Any]] = []
        self.restarts = 0        # failure-driven relaunches (budgeted)
        self.grows = 0           # capacity-driven relaunches (free)
        self.excluded: List[int] = []   # crash-looped rank slots
        self.generations: List[Dict[str, Any]] = []
        self._seen_flights: set = set()

    # -- group control ----------------------------------------------------

    def _terminate(self, procs: Dict[int, subprocess.Popen]) -> Dict[int, int]:
        """SIGTERM everyone still alive (FitLoop drains to a final
        checkpoint at the next step boundary and exits resumable), wait
        out the grace period, SIGKILL stragglers. Returns {rank: rc}."""
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = self._clock() + self._grace
        while self._clock() < deadline and \
                any(p.poll() is None for p in procs.values()):
            time.sleep(self._poll)
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        return {r: p.wait() for r, p in procs.items()}

    def _scan_hangs(self) -> List[int]:
        """New watchdog flight records naming an absent rank."""
        if not self._dump_dir:
            return []
        from ..telemetry.collective import scan_flight_records
        recs = scan_flight_records(self._dump_dir, self._seen_flights)
        return sorted({r["absent_rank"] for r in recs
                       if r.get("absent_rank") is not None})

    def _watch(self, procs: Dict[int, subprocess.Popen],
               world: int) -> Dict[str, Any]:
        """Run one generation to its end. Returns
        ``{"kind": "done"}`` | ``{"kind": "grow", "world": w}`` |
        ``{"kind": "incident", "event": {...}}``."""
        alive = dict(procs)
        exits: Dict[int, int] = {}
        while alive:
            for rank, p in list(alive.items()):
                rc = p.poll()
                if rc is not None:
                    exits[rank] = rc
                    del alive[rank]

            # Hard death: kill the rest NOW — they would only wedge in
            # the next collective waiting for the dead peer. (A
            # resumable exit is NOT a death: peers may still be draining
            # their own final checkpoint; let them finish.) Checked
            # BEFORE the hang scan: a registered exit code is more
            # authoritative than a survivor's flight record naming the
            # same absent rank — both fire when a peer dies mid-step,
            # and the incident is a crash, not a hang.
            dead = {r: rc for r, rc in exits.items()
                    if classify_exit(rc) in ("fatal", "signal")}
            if dead:
                # Event time is DETECTION time (pre-drain): it is what
                # the crash-loop window should measure, and what the
                # shrink-latency metric counts from.
                t_dec = self._clock()
                exits.update(self._terminate(alive))
                kinds = {classify_exit(rc) for rc in dead.values()}
                kind = "signal" if kinds == {"signal"} else "crash"
                lost = sorted(dead)
                self._log(f"rank(s) {lost} died "
                          f"({ {r: rc for r, rc in dead.items()} }); "
                          f"draining survivors")
                return {"kind": "incident", "event": {
                    "kind": kind, "rank": lost[0], "ranks": lost,
                    "time": t_dec, "exits": exits}}

            # Hung collective: a flight record names the withholding
            # rank. The wedged survivors are still "alive" — drain them.
            absent = self._scan_hangs()
            if absent:
                t_dec = self._clock()
                self._log(f"hung collective: absent rank(s) {absent}; "
                          f"draining survivors")
                exits.update(self._terminate(alive))
                return {"kind": "incident", "event": {
                    "kind": "hang", "rank": absent[0], "ranks": absent,
                    "time": t_dec, "exits": exits}}

            # Grow: capacity says more slots exist than we are using.
            if alive and world < self._eff_target() and \
                    self._capacity.available(self._clock()) > world:
                t_dec = self._clock()
                self._log(f"capacity returned: growing {world} -> "
                          f"{self._grow_world(world)}; draining fleet")
                exits.update(self._terminate(alive))
                # A negative rc here is OUR signal (the SIGTERM drain,
                # or the SIGKILL after grace on a worker that could not
                # reach a step boundary) — the relaunch resumes from
                # the last durable checkpoint either way, so it is not
                # an incident. Only a worker FAILING on its own during
                # the drain (positive non-resumable exit) is.
                bad = {r: rc for r, rc in exits.items()
                       if rc > 0 and classify_exit(rc) == "fatal"}
                if bad:
                    lost = sorted(bad)
                    return {"kind": "incident", "event": {
                        "kind": "crash", "rank": lost[0], "ranks": lost,
                        "time": self._clock(), "exits": exits}}
                return {"kind": "grow", "world": self._grow_world(world),
                        "time": t_dec}

            time.sleep(self._poll)

        # Everyone exited on their own.
        classes = {classify_exit(rc) for rc in exits.values()}
        if classes == {"ok"}:
            return {"kind": "done", "exits": exits}
        if classes <= {"ok", "resumable"}:
            return {"kind": "incident", "event": {
                "kind": "resumable", "rank": None, "ranks": [],
                "time": self._clock(), "exits": exits}}
        dead = sorted(r for r, rc in exits.items()
                      if classify_exit(rc) in ("fatal", "signal"))
        kinds = {classify_exit(exits[r]) for r in dead}
        return {"kind": "incident", "event": {
            "kind": "signal" if kinds == {"signal"} else "crash",
            "rank": dead[0], "ranks": dead,
            "time": self._clock(), "exits": exits}}

    # -- world arithmetic -------------------------------------------------

    def _eff_target(self) -> int:
        """Target world minus crash-loop-excluded slots."""
        return max(self._floor, self._target - len(self.excluded))

    def _grow_world(self, world: int) -> int:
        return min(self._eff_target(),
                   max(world + 1,
                       min(self._capacity.available(self._clock()),
                           self._eff_target())))

    def _resume_world(self, fallback: int) -> int:
        """World for a resumable-drain relaunch: the ``resize_to`` the
        final checkpoint requested (chaos ``resize@N:M``, or an operator
        writing one) wins; otherwise same world."""
        if self._ckpt_dir:
            from ..fault import latest_checkpoint_meta
            from .elastic import resize_request
            found = latest_checkpoint_meta(self._ckpt_dir)
            rz = resize_request(found[1]) if found else None
            if rz:
                self._log(f"checkpoint requests resize_to={rz}")
                return max(self._floor, min(rz, self._eff_target()))
        return fallback

    # -- main loop --------------------------------------------------------

    def run(self) -> int:
        world = max(self._floor,
                    min(self._target,
                        self._capacity.available(self._clock())))
        gen = 0
        while True:
            extra = {"MXTPU_SUPERVISE_GEN": str(gen)}
            if gen > 0:
                extra["MXTPU_ELASTIC"] = "on"
                extra["MXNET_IS_RECOVERY"] = "1"
            t0 = self._clock()
            self._log(f"generation {gen}: world={world} "
                      f"(target {self._eff_target()}, "
                      f"restarts {self.restarts}/{self._max_restarts})")
            # Absorb flight records written during the previous
            # generation's drain grace window — they describe a fleet
            # that no longer exists and must not indict the new one.
            self._scan_hangs()
            procs = self._spawn(world, gen, extra)
            check(len(procs) == world,
                  f"spawn returned {len(procs)} processes for "
                  f"world={world}")
            outcome = self._watch(procs, world)
            rec = {"gen": gen, "world": world, "t_start": t0,
                   "t_end": self._clock(), "outcome": outcome["kind"],
                   # detection time: when the incident was observed /
                   # the grow was decided, BEFORE the drain — what
                   # relaunch-latency metrics count from
                   "t_decide": outcome.get(
                       "event", {}).get("time", outcome.get("time"))}
            self.generations.append(rec)

            if outcome["kind"] == "done":
                self._summary(world, ok=True)
                return 0

            if outcome["kind"] == "grow":
                self.grows += 1
                _counter("mxtpu_supervisor_grows_total",
                         "Capacity-driven fleet grow relaunches.").inc()
                world = outcome["world"]
                gen += 1
                continue

            event = outcome["event"]
            self.events.append(event)
            if event["kind"] in ("hang", "crash", "signal"):
                self._capacity.note_lost(len(event.get("ranks") or [1]),
                                         event["time"])
            action = decide(self.events, world=world, floor=self._floor,
                            max_restarts=self._max_restarts,
                            crash_window_s=self._crash_window,
                            crash_limit=self._crash_limit)
            self._log(f"event {event['kind']} (ranks "
                      f"{event.get('ranks')}) -> {action}")

            if action["op"] == "fail":
                self._fail(world, action["reason"])
                return 1

            self.restarts += 1
            _counter("mxtpu_supervisor_restarts_total",
                     "Failure-driven fleet relaunches (budgeted by "
                     "MXTPU_SUPERVISE_MAX_RESTARTS).").inc()
            if action["op"] == "exclude":
                self.excluded.append(action["rank"])
                self._log(f"rank slot {action['rank']} excluded "
                          f"(crash loop); continuing at "
                          f"{action['world']}")
                world = max(self._floor, action["world"])
            elif action["op"] == "shrink":
                world = max(self._floor, action["world"])
            else:  # resume
                world = self._resume_world(action["world"])
            gen += 1

    # -- reporting --------------------------------------------------------

    def _summary_payload(self, world: int, ok: bool) -> Dict[str, Any]:
        return {"ok": ok, "final_world": world,
                "target_world": self._target,
                "restarts": self.restarts, "grows": self.grows,
                "excluded": self.excluded,
                "generations": len(self.generations),
                "events": [{k: v for k, v in e.items() if k != "exits"}
                           for e in self.events],
                "gen_log": self.generations}

    def _summary(self, world: int, ok: bool,
                 forensics: Optional[str] = None) -> None:
        payload = self._summary_payload(world, ok)
        if forensics:
            payload["forensics"] = forensics
        print("SUPERVISOR_SUMMARY " + json.dumps(payload, sort_keys=True,
                                                 default=str), flush=True)

    def _fail(self, world: int, reason: str) -> None:
        self._log(f"FAILING LOUDLY: {reason}")
        bundle = None
        if self._state_dir:
            try:
                bundle = write_forensic_bundle(
                    self._state_dir, events=self.events,
                    summary=dict(self._summary_payload(world, ok=False),
                                 reason=reason),
                    dump_dir=self._dump_dir)
                self._log(f"forensic bundle: {bundle}")
            except OSError as e:
                self._log(f"forensic bundle write failed: {e}")
        self._summary(world, ok=False, forensics=bundle)
