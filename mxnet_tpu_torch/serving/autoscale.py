"""Fleet autoscaler: a pure, table-testable ``decide()`` ladder (ref: the
JAX package's ``serving/autoscale.py``).

Same design as the training supervisor
(:mod:`mxnet_tpu_torch.parallel.supervisor`): all policy lives in a pure
function of the observation history, so every rung is a table test with
no processes, sockets, or clocks. :class:`Autoscaler` is the thin
executor that snapshots :meth:`FleetRouter.states` into observations and
turns decisions into spawn/drain/respawn callbacks.

The ladder (first matching rung wins):

1. **Replica death -> respawn from CURRENT.** A dead replica is replaced
   immediately (zero-compile cold start makes this cheap); the router
   already retried its in-flight requests on survivors.
2. **Below floor -> scale up to the floor** (``MXTPU_FLEET_MIN``).
3. **Sustained queue pressure -> scale up by one.** Mean healthy-replica
   queue depth above ``MXTPU_FLEET_TARGET_QUEUE`` for
   ``pressure_ticks`` consecutive observations, bounded by
   ``MXTPU_FLEET_MAX``.
4. **Sustained idle -> scale down by one.** Zero total queue depth and
   zero in-flight for ``idle_ticks`` consecutive observations, bounded
   by ``MXTPU_FLEET_MIN``. The victim is *drained*, never killed:
   routing stops first, in-flight requests finish, then the process
   gets a drain-stop.
5. Otherwise **no-op**.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..base import MXNetError, check, env
from ..log import get_logger

__all__ = ["decide", "Autoscaler", "fleet_min", "fleet_max",
           "fleet_target_queue"]

_LOG = get_logger("mxnet_tpu_torch.serving")  # see router.py: child
#                                               handlers double-emit


# -- strict env parsers (supervisor style) ----------------------------------

def fleet_min() -> int:
    """Lower replica bound (``MXTPU_FLEET_MIN``)."""
    try:
        n = int(env.get("MXTPU_FLEET_MIN"))
    except (TypeError, ValueError):
        raise MXNetError("MXTPU_FLEET_MIN: expected an integer, got "
                         f"{env.raw('MXTPU_FLEET_MIN')!r}")
    check(n >= 1, f"MXTPU_FLEET_MIN must be >= 1, got {n}")
    return n


def fleet_max() -> int:
    """Upper replica bound (``MXTPU_FLEET_MAX``)."""
    try:
        n = int(env.get("MXTPU_FLEET_MAX"))
    except (TypeError, ValueError):
        raise MXNetError("MXTPU_FLEET_MAX: expected an integer, got "
                         f"{env.raw('MXTPU_FLEET_MAX')!r}")
    check(n >= 1, f"MXTPU_FLEET_MAX must be >= 1, got {n}")
    return n


def fleet_target_queue() -> int:
    """Per-replica queue-depth target (``MXTPU_FLEET_TARGET_QUEUE``):
    sustained mean depth above this is scale-up pressure."""
    try:
        n = int(env.get("MXTPU_FLEET_TARGET_QUEUE"))
    except (TypeError, ValueError):
        raise MXNetError("MXTPU_FLEET_TARGET_QUEUE: expected an integer, "
                         f"got {env.raw('MXTPU_FLEET_TARGET_QUEUE')!r}")
    check(n >= 1, f"MXTPU_FLEET_TARGET_QUEUE must be >= 1, got {n}")
    return n


# -- the pure policy --------------------------------------------------------

def decide(history: List[Dict], *, min_replicas: Optional[int] = None,
           max_replicas: Optional[int] = None,
           target_queue: Optional[int] = None,
           pressure_ticks: int = 3, idle_ticks: int = 6) -> Dict:
    """Pure scaling decision over an observation history.

    ``history`` is time-ordered (oldest first); each observation is
    ``{"replicas": {name: {"queue_depth": int, "healthy": bool,
    "inflight": int}}}`` — exactly what :meth:`FleetRouter.states`
    returns. Knobs default to the ``MXTPU_FLEET_*`` env values when not
    passed (pass them explicitly in tests: no env reads happen then).

    Returns one action dict: ``{"op": "none"|"respawn"|"scale_up"|
    "scale_down", "reason": str, ...}`` (``respawn`` carries
    ``replicas``, ``scale_up`` carries ``add``, ``scale_down`` carries
    ``drain``).
    """
    lo = fleet_min() if min_replicas is None else int(min_replicas)
    hi = fleet_max() if max_replicas is None else int(max_replicas)
    tq = fleet_target_queue() if target_queue is None else int(target_queue)
    check(lo >= 1, f"min_replicas must be >= 1, got {lo}")
    check(hi >= lo, f"max_replicas ({hi}) must be >= min_replicas ({lo})")
    check(tq >= 1, f"target_queue must be >= 1, got {tq}")
    check(pressure_ticks >= 1 and idle_ticks >= 1,
          "pressure_ticks/idle_ticks must be >= 1")
    if not history:
        return {"op": "none", "reason": "no observations yet"}
    latest = history[-1].get("replicas", {})
    dead = sorted(n for n, s in latest.items() if not s.get("healthy", True))
    healthy = {n: s for n, s in latest.items() if s.get("healthy", True)}
    n_live = len(healthy)

    # rung 1: death -> respawn from CURRENT (bounded by max: a respawn
    # replaces capacity, it never exceeds the observed membership)
    if dead:
        return {"op": "respawn", "replicas": dead,
                "reason": f"replica death: {', '.join(dead)}"}

    # rung 2: below the floor (e.g. after an operator removed replicas)
    if n_live < lo:
        return {"op": "scale_up", "add": lo - n_live,
                "reason": f"{n_live} live < MXTPU_FLEET_MIN={lo}"}

    def _mean_depth(obs) -> Optional[float]:
        reps = [s for s in obs.get("replicas", {}).values()
                if s.get("healthy", True)]
        if not reps:
            return None
        return sum(int(s.get("queue_depth", 0)) for s in reps) / len(reps)

    # rung 3: sustained pressure -> +1 (bounded)
    if len(history) >= pressure_ticks:
        window = history[-pressure_ticks:]
        depths = [_mean_depth(o) for o in window]
        if all(d is not None and d > tq for d in depths):
            if n_live >= hi:
                return {"op": "none",
                        "reason": (f"pressure (mean depth {depths[-1]:.1f} "
                                   f"> {tq}) but at MXTPU_FLEET_MAX={hi}")}
            return {"op": "scale_up", "add": 1,
                    "reason": (f"queue pressure: mean depth > {tq} for "
                               f"{pressure_ticks} ticks")}

    # rung 4: sustained idle -> drain one (bounded)
    if n_live > lo and len(history) >= idle_ticks:
        window = history[-idle_ticks:]

        def _idle(obs) -> bool:
            reps = obs.get("replicas", {})
            return bool(reps) and all(
                int(s.get("queue_depth", 0)) == 0
                and int(s.get("inflight", 0)) == 0
                for s in reps.values() if s.get("healthy", True))

        if all(_idle(o) for o in window):
            # drain the least-loaded name; lexicographic tie-break keeps
            # the choice deterministic for the decision table
            victim = min(sorted(healthy),
                         key=lambda n: (int(healthy[n].get("inflight", 0)),
                                        int(healthy[n].get(
                                            "queue_depth", 0))))
            return {"op": "scale_down", "drain": victim,
                    "reason": f"idle for {idle_ticks} ticks"}

    return {"op": "none", "reason": "steady"}


# -- the thin executor ------------------------------------------------------

class Autoscaler:
    """Turns :func:`decide` into fleet actions against a router.

    ``spawn(name) -> (addr, pid)`` starts a replica process and returns
    its endpoint; ``retire(name, pid)`` reaps a drained process. Both
    come from the launcher (``serving/serve_fleet.py``) or the test
    harness —
    the autoscaler itself never forks.
    """

    def __init__(self, router, spawn: Callable[[str], Tuple[Tuple, int]],
                 retire: Optional[Callable[[str, Optional[int]], None]]
                 = None, min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 target_queue: Optional[int] = None,
                 pressure_ticks: int = 3, idle_ticks: int = 6,
                 history: int = 64):
        self.router = router
        self._spawn = spawn
        self._retire = retire or (lambda name, pid: None)
        self._min = fleet_min() if min_replicas is None else int(min_replicas)
        self._max = fleet_max() if max_replicas is None else int(max_replicas)
        self._tq = (fleet_target_queue() if target_queue is None
                    else int(target_queue))
        check(self._max >= self._min,
              f"MXTPU_FLEET_MAX ({self._max}) must be >= MXTPU_FLEET_MIN "
              f"({self._min})")
        self._pressure_ticks = pressure_ticks
        self._idle_ticks = idle_ticks
        self._history: Deque[Dict] = deque(maxlen=history)
        self._seq = 0
        self._lock = threading.Lock()

    def _next_name(self) -> str:
        with self._lock:
            self._seq += 1
            return f"r{self._seq}"

    def seed_seq(self, n: int) -> None:
        """Advance the replica-name counter past launcher-created names."""
        with self._lock:
            self._seq = max(self._seq, int(n))

    def observe(self) -> Dict:
        obs = {"t": time.monotonic(), "replicas": self.router.states()}
        self._history.append(obs)
        return obs

    def step(self) -> Dict:
        """One observe -> decide -> apply tick; returns the decision."""
        self.observe()
        action = decide(list(self._history), min_replicas=self._min,
                        max_replicas=self._max, target_queue=self._tq,
                        pressure_ticks=self._pressure_ticks,
                        idle_ticks=self._idle_ticks)
        op = action["op"]
        if op == "none":
            return action
        _LOG.info("autoscale: %s (%s)", op, action["reason"])
        if op == "respawn":
            for name in action["replicas"]:
                pid = None
                client = self.router._replicas.get(name)
                if client is not None:
                    pid = client.pid
                self.router.remove_replica(name, drain=False)
                self._retire(name, pid)
                self._spawn_one()
            # dead state consumed: without this the next tick re-fires
            # on the same stale observation
            self._history.clear()
        elif op == "scale_up":
            for _ in range(int(action.get("add", 1))):
                self._spawn_one()
            self._history.clear()
        elif op == "scale_down":
            name = action["drain"]
            client = self.router._replicas.get(name)
            pid = client.pid if client is not None else None
            self.router.remove_replica(name, drain=True)
            self._retire(name, pid)
            self._history.clear()
        return action

    def _spawn_one(self) -> str:
        name = self._next_name()
        addr, pid = self._spawn(name)
        self.router.add_replica(name, addr, pid=pid)
        return name
