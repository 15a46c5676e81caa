"""Deterministic fault injection for resilience testing (a copy of the JAX
package's ``contrib/chaos.py``; the port's hooks are listed at the end).

The reference stack *survives* worker death (ps-lite heartbeats +
restart-from-checkpoint, kvstore_dist.h GetDeadNodes/is_recovery) but never
*proves* it: nothing in the tree injects the failures the recovery code
claims to handle. This module turns every robustness claim into a test.

A :class:`ChaosPlan` is a deterministic schedule of faults, parsed from the
``MXTPU_CHAOS`` env var (or installed programmatically)::

    MXTPU_CHAOS=nan_grad@12,kill@40,ckpt_corrupt@latest,kv_flake:0.2

Grammar: comma-separated events, each ``kind[:prob][@target]``:

- ``nan_grad@S`` / ``inf_grad@S`` — poison one parameter gradient with
  NaN/Inf at step ``S`` (hook: ``gluon.Trainer.step`` and ``fit.FitLoop``).
- ``kill@S`` — abrupt simulated worker death at step ``S``: raises
  :class:`ChaosKilled` with nothing flushed (hook: ``fit.FitLoop``).
- ``preempt@S`` — simulated preemption at step ``S``: delivers SIGTERM
  to this process, exercising the graceful final-checkpoint exit path.
- ``resize@S[:M]`` — elastic fleet resize at step ``S``: ``fit.FitLoop``
  writes a final verified checkpoint whose topology record carries
  ``resize_to: M`` (when given) and exits with the resumable code — the
  relaunch harness resumes the run at world ``M`` through the elastic
  path (``parallel/elastic.py``, ``MXTPU_ELASTIC=on``).
- ``ckpt_corrupt@latest`` / ``ckpt_corrupt@S`` — flip bytes inside the
  ``params`` file of the next completed checkpoint (/ of checkpoint ``S``)
  *after* its DONE marker lands: a forged-complete corrupt checkpoint,
  exactly what ``CheckpointManager.verify`` + quarantine must catch
  (hook: ``fault.CheckpointManager._write``).
- ``kv_flake:P`` — every kvstore push/pull raises
  :class:`~mxnet_tpu_torch.kvstore.TransientKVError` with probability ``P``
  (seeded RNG, ``MXTPU_CHAOS_SEED``), exercising the bounded
  retry-with-backoff (hook: ``kvstore.KVStoreBase.push/pull``).
- ``kv_slow:P@MS`` — each kvstore push/pull attempt sleeps ``MS``
  milliseconds with probability ``P`` (``kv_slow@MS`` = always),
  simulating a slow interconnect so comm-bound steps are reproducible on
  a laptop: the step-breakdown comm-bound detector, the comm/backward
  overlap path and the autotuner are all testable against it (hook:
  ``kvstore.KVStoreBase.push/pull``, same entry point as ``kv_flake``).
- ``kv_hang:<rank>@N[:MS]`` — the named rank delays/withholds its next
  kvstore exchange at step ``N``: its push/pull/reduce-scatter/allgather
  entry sleeps ``MS`` milliseconds (default 60000 — long enough to be a
  withhold for any sane ``MXTPU_COLL_TIMEOUT_S``) before touching the
  wire, so every OTHER rank blocks inside the collective waiting for it.
  Consume-once and deterministic; the hung-collective watchdog
  (``telemetry/collective.py``) is testable on CPU against it: surviving
  ranks' flight records must name the hung ``(kind, key, seq)`` and the
  absent rank (hook: ``kvstore.KVStoreBase`` push/pull and the ZeRO
  collective entry points, same entry as ``kv_flake``/``kv_slow``).
- ``serve_slow:P@MS`` — each serving batch dispatch sleeps ``MS``
  milliseconds with probability ``P`` (``serve_slow@MS`` = always),
  simulating compute stragglers/compile stalls so deadline shedding and
  queue backpressure are testable (hook: ``serving.ModelServer`` worker,
  before the batch is padded and dispatched).
- ``mem_pressure@N[:BYTES]`` — synthetic device-memory budget shrink at
  step ``N``: the memory monitor treats ``BYTES`` (default 0) as the
  budget for that step, so the live-byte watermark exceeds it and the
  OOM forensics dump fires deterministically — the black-box recording
  path is testable on CPU without a real allocation failure (hook:
  ``fit.FitLoop`` per-step ``telemetry.memory.check_pressure``).
- ``registry_corrupt@V`` — flip bytes inside the params artifact of model-
  registry version ``V`` (``latest`` = the next published version) *after*
  its DONE marker and manifest land: a forged-complete corrupt model,
  exactly what ``ModelRegistry.resolve``'s verify + quarantine + fallback
  must catch (hook: ``serving.registry.ModelRegistry.publish``).
- ``replica_kill@N[:R]`` — kill one serving-fleet replica process once the
  router has dispatched ``N`` requests: replica index ``R`` of the sorted
  live set, default the busiest. Runs on the router's *routed-request*
  clock, not the training step clock. The zero-dropped-in-flight proof:
  the router must retry every un-acked request of the corpse on a
  survivor (hook: ``serving.router.FleetRouter.submit`` via
  ``set_kill_hook``).

Step-scheduled events fire on the plan's step clock, advanced exactly once
per training step by the loop owner (``FitLoop`` and ``Trainer.step`` both
call :meth:`ChaosPlan.begin_step`); each fires once and is consumed. All
randomness comes from one seeded ``random.Random`` so a plan replays
identically — chaos runs are regression tests, not flake generators.

In the port the training events fire (``nan_grad``, ``inf_grad``, ``kill``,
``preempt``, ``resize``, ``ckpt_corrupt``, ``kv_flake``, ``kv_slow``,
``mem_pressure``), ``serve_slow`` fires in ``serving.ModelServer``'s
workers, once per dispatched batch, and ``kv_hang`` in the kvstore's
exchange entry (``kvstore._chaos_kv``: the named rank sleeps before its
first exchange of the step). ``registry_corrupt`` fires in
``serving.ModelRegistry.publish`` once the version's DONE marker lands
(``ModelRegistry.resolve`` then quarantines it), and ``replica_kill`` in
``serving.FleetRouter.submit`` through the kill hook its launcher
installs, as in the JAX package.
"""
from __future__ import annotations

import os
import random
import signal
import threading
from typing import Dict, Optional, Set

from ..base import MXNetError, env

__all__ = ["ChaosKilled", "ChaosPlan", "install", "uninstall", "active"]


def _count_injection(kind: str) -> None:
    """Mirror a fired fault into the shared telemetry registry (the
    per-plan ``injected`` dict stays the test-facing source of truth)."""
    try:
        from ..telemetry import default_registry
        default_registry().counter(
            "mxtpu_chaos_injections_total",
            "Chaos faults actually fired, by kind.",
            label="kind").inc(label_value=kind)
    except Exception:
        pass


class ChaosKilled(MXNetError):
    """Simulated abrupt worker death (``kill@step``): the process 'dies'
    with nothing flushed. Deliberately NOT caught by FitLoop — recovery is
    restart + ``restore_latest``, same as a real kill -9."""

    def __init__(self, step: int):
        super().__init__(f"chaos: simulated worker death at step {step}")
        self.step = step


_KINDS = ("nan_grad", "inf_grad", "kill", "preempt", "resize",
          "ckpt_corrupt", "kv_flake", "kv_slow", "kv_hang", "serve_slow",
          "registry_corrupt", "mem_pressure", "replica_kill")


class ChaosPlan:
    """Parsed, deterministic fault schedule. See module docstring for the
    grammar."""

    def __init__(self, spec: str = "", seed: Optional[int] = None,
                 _env_spec: Optional[str] = None):
        if seed is None:
            seed = int(env.get("MXTPU_CHAOS_SEED"))
        self._rng = random.Random(seed)
        # serving workers roll serve_slow concurrently; the lock keeps the
        # draw sequence + injected counters data-race-free (which batch
        # consumes which draw is still scheduling-dependent with >1
        # worker — exact replay holds for single-worker servers)
        self._rng_lock = threading.Lock()
        self._env_spec = _env_spec
        self._step: Optional[int] = None
        self._at: Dict[str, Set[int]] = {k: set() for k in _KINDS}
        self._ckpt_latest = False
        self._registry_targets: Set[str] = set()  # version names
        self._registry_latest = False
        self.kv_flake_p = 0.0
        self.kv_slow_p = 0.0
        self.kv_slow_ms = 0.0
        self.serve_slow_p = 0.0
        self.serve_slow_ms = 0.0
        self._kv_hang: Dict[int, tuple] = {}  # step -> (rank, delay_ms)
        self._mem_pressure: Dict[int, int] = {}  # step -> budget bytes
        self._replica_kill: Dict[int, int] = {}  # routed count -> replica
        self._resize: Dict[int, Optional[int]] = {}  # step -> world|None
        # observability: how many of each fault actually fired
        self.injected: Dict[str, int] = {k: 0 for k in _KINDS}
        for tok in (spec or "").split(","):
            tok = tok.strip()
            if not tok:
                continue
            self._parse_token(tok)

    def _parse_token(self, tok: str) -> None:
        target: Optional[str] = None
        if "@" in tok:
            tok, target = tok.split("@", 1)
        prob: Optional[str] = None
        if ":" in tok:
            tok, prob = tok.split(":", 1)
        kind = tok.strip()
        if kind not in _KINDS:
            raise MXNetError(f"chaos: unknown event kind {kind!r} "
                             f"(known: {', '.join(_KINDS)})")
        if kind == "kv_flake":
            if target is not None:
                raise MXNetError("chaos: kv_flake takes no step target "
                                 "(it flakes every push/pull attempt)")
            if prob is None:
                raise MXNetError("chaos: kv_flake needs a probability, "
                                 "e.g. kv_flake:0.2")
            p = float(prob)
            if not 0.0 <= p <= 1.0:
                raise MXNetError(f"chaos: kv_flake probability {p} "
                                 "outside [0, 1]")
            self.kv_flake_p = p
            return
        if kind in ("serve_slow", "kv_slow"):
            if target is None:
                raise MXNetError(f"chaos: {kind} needs a delay target "
                                 f"in ms, e.g. {kind}:0.5@20 or "
                                 f"{kind}@20")
            ms = float(target)
            if ms < 0:
                raise MXNetError(f"chaos: {kind} delay {ms} < 0")
            p = 1.0 if prob is None else float(prob)
            if not 0.0 <= p <= 1.0:
                raise MXNetError(f"chaos: {kind} probability {p} "
                                 "outside [0, 1]")
            if kind == "kv_slow":
                self.kv_slow_p = p
                self.kv_slow_ms = ms
            else:
                self.serve_slow_p = p
                self.serve_slow_ms = ms
            return
        if kind == "kv_hang":
            # kv_hang:<rank>@N[:MS] — the ':' slot carries the RANK (not
            # a probability: which rank withholds is never random), the
            # '@' target the step and optional delay
            if prob is None:
                raise MXNetError("chaos: kv_hang needs a rank, e.g. "
                                 "kv_hang:1@3 or kv_hang:1@3:500")
            if target is None:
                raise MXNetError("chaos: kv_hang needs a step target, "
                                 "e.g. kv_hang:1@3")
            try:
                rank = int(prob)
            except ValueError:
                raise MXNetError(
                    f"chaos: bad kv_hang rank {prob!r} (expected an int)")
            if rank < 0:
                raise MXNetError(f"chaos: kv_hang rank {rank} < 0")
            step_s, _, ms_s = target.partition(":")
            try:
                step = int(step_s)
                ms = float(ms_s) if ms_s else 60000.0
            except ValueError:
                raise MXNetError(
                    f"chaos: bad kv_hang target {target!r} "
                    "(expected STEP or STEP:MS)")
            if ms < 0:
                raise MXNetError(f"chaos: kv_hang delay {ms} < 0")
            self._kv_hang[step] = (rank, ms)
            return
        if kind == "resize":
            # resize@S[:M] — kill-with-resumable-exit at step S; the
            # optional M stamps the target world into the checkpoint's
            # topology record for the relaunch harness
            if prob is not None:
                raise MXNetError("chaos: resize takes no probability")
            if target is None:
                raise MXNetError("chaos: resize needs a step target, "
                                 "e.g. resize@5 or resize@5:3")
            step_s, _, world_s = target.partition(":")
            try:
                step = int(step_s)
                world = int(world_s) if world_s else None
            except ValueError:
                raise MXNetError(
                    f"chaos: bad resize target {target!r} "
                    "(expected STEP or STEP:WORLD)")
            if world is not None and world < 1:
                raise MXNetError(f"chaos: resize world {world} < 1")
            self._resize[step] = world
            return
        if kind == "replica_kill":
            # replica_kill@N[:R] — fire once the router has dispatched N
            # requests; R = victim index in the sorted live-replica set
            # (omitted = -1 = busiest). The ':' slot would be a
            # probability for other kinds; which replica dies is never
            # random here, so the index rides the '@' target.
            if prob is not None:
                raise MXNetError("chaos: replica_kill takes no probability")
            if target is None:
                raise MXNetError("chaos: replica_kill needs a routed-count "
                                 "target, e.g. replica_kill@40 or "
                                 "replica_kill@40:1")
            n_s, _, r_s = target.partition(":")
            try:
                n = int(n_s)
                r = int(r_s) if r_s else -1
            except ValueError:
                raise MXNetError(
                    f"chaos: bad replica_kill target {target!r} "
                    "(expected COUNT or COUNT:REPLICA)")
            if n < 1:
                raise MXNetError(f"chaos: replica_kill count {n} < 1")
            if r < -1:
                raise MXNetError(f"chaos: replica_kill replica index {r} "
                                 "< 0 (or -1 for busiest)")
            self._replica_kill[n] = r
            return
        if kind == "mem_pressure":
            # mem_pressure@N[:BYTES] — synthetic budget shrink at step N:
            # the memory monitor treats BYTES (default 0, i.e. "any live
            # byte is over budget") as the budget for that one step and
            # dumps forensics, making the OOM black-box path
            # deterministic and testable on CPU
            if prob is not None:
                raise MXNetError("chaos: mem_pressure takes no probability")
            if target is None:
                raise MXNetError("chaos: mem_pressure needs a step target, "
                                 "e.g. mem_pressure@3 or "
                                 "mem_pressure@3:1048576")
            step_s, _, bytes_s = target.partition(":")
            try:
                step = int(step_s)
                budget = int(bytes_s) if bytes_s else 0
            except ValueError:
                raise MXNetError(
                    f"chaos: bad mem_pressure target {target!r} "
                    "(expected STEP or STEP:BYTES)")
            if budget < 0:
                raise MXNetError(f"chaos: mem_pressure budget {budget} < 0")
            self._mem_pressure[step] = budget
            return
        if prob is not None:
            raise MXNetError(f"chaos: {kind} takes no probability")
        if kind == "registry_corrupt":
            if target is None or not target.strip():
                raise MXNetError("chaos: registry_corrupt needs a version "
                                 "target, e.g. registry_corrupt@v2 or "
                                 "registry_corrupt@latest")
            if target.strip() == "latest":
                self._registry_latest = True
            else:
                self._registry_targets.add(target.strip())
            return
        if target is None:
            raise MXNetError(f"chaos: {kind} needs a step target, "
                             f"e.g. {kind}@12")
        if kind == "ckpt_corrupt" and target.strip() == "latest":
            self._ckpt_latest = True
            return
        try:
            self._at[kind].add(int(target))
        except ValueError:
            raise MXNetError(
                f"chaos: bad target {target!r} for {kind} "
                "(expected an integer step"
                + (" or 'latest'" if kind == "ckpt_corrupt" else "") + ")")

    # -- step clock -----------------------------------------------------
    def begin_step(self, step: int) -> None:
        """Advance the plan's step clock; called once per training step by
        the loop owner (FitLoop)."""
        self._step = int(step)

    def should(self, kind: str) -> bool:
        """True iff a ``kind`` event is scheduled at the current step.
        Consumes the event (fires once)."""
        if self._step is None or self._step not in self._at[kind]:
            return False
        self._at[kind].discard(self._step)
        self.injected[kind] += 1
        _count_injection(kind)
        return True

    # -- injection actions ----------------------------------------------
    def maybe_kill(self) -> None:
        """kill@step -> raise ChaosKilled; preempt@step -> SIGTERM to self
        (the preemption signal, caught by FitLoop's handler)."""
        if self.should("kill"):
            raise ChaosKilled(self._step)
        if self.should("preempt"):
            signal.raise_signal(signal.SIGTERM)

    def poison_grads(self, params) -> bool:
        """nan_grad/inf_grad@step: overwrite the first trainable
        parameter's gradient with NaN (resp. Inf), simulating an overflowed
        backward. Returns True when poison was applied."""
        fill = None
        if self.should("nan_grad"):
            fill = float("nan")
        elif self.should("inf_grad"):
            fill = float("inf")
        if fill is None:
            return False
        for p in params:
            if getattr(p, "grad_req", "null") == "null" or \
                    p.tensor is None:
                continue
            p.grad()._data.fill_(fill)   # in place: the buffer is kept
            return True
        return False

    def poisons_step(self, step: int) -> bool:
        """True when a grad-poison event (nan_grad/inf_grad) is scheduled
        at ``step``. The FitLoop consults this BEFORE backward to disable
        comm/backward overlap for exactly that step: the poison is written
        AFTER backward, and overlapped collectives would already have
        shipped the clean gradients (the deferred bucket split would then
        overwrite the poisoned buffers), silently neutering the injected
        fault the chaos test exists to exercise."""
        return (int(step) in self._at["nan_grad"] or
                int(step) in self._at["inf_grad"])

    def resize_target(self) -> Optional[Dict[str, Optional[int]]]:
        """resize@S[:M] — ``{"world": M or None}`` when a resize is
        scheduled at the current step, else None. Consumed on read
        (fires once); ``fit.FitLoop`` writes the final checkpoint with
        ``resize_to`` in its topology record and exits resumable."""
        if self._step is None or self._step not in self._resize:
            return None
        world = self._resize.pop(self._step)
        self.injected["resize"] += 1
        _count_injection("resize")
        return {"world": world}

    def mem_pressure_bytes(self) -> Optional[int]:
        """mem_pressure@N[:BYTES] — the synthetic memory budget for the
        current step, or None when none is scheduled. Consumed on read
        (fires once); the memory monitor (``telemetry.memory
        .check_pressure``) compares the step's ledger watermark against
        it and dumps forensics when exceeded."""
        if self._step is None or self._step not in self._mem_pressure:
            return None
        budget = self._mem_pressure.pop(self._step)
        self.injected["mem_pressure"] += 1
        _count_injection("mem_pressure")
        return budget

    def replica_kill_due(self, routed: int) -> Optional[int]:
        """replica_kill@N[:R] — the victim replica index once ``routed``
        dispatched requests have been reached (-1 = busiest), else None.
        Runs on the router's routed-request clock (no ``begin_step``
        needed). Consumed on read (fires once); the router feeds the
        index to its kill hook, which destroys the process/endpoint."""
        due = [n for n in self._replica_kill if int(routed) >= n]
        if not due:
            return None
        r = self._replica_kill.pop(min(due))
        self.injected["replica_kill"] += 1
        _count_injection("replica_kill")
        return r

    def kv_delay_s(self) -> float:
        """kv_slow:P@MS — seconds of injected wire delay for this kvstore
        push/pull attempt (0.0 when the roll misses). The caller sleeps
        this long before the op, simulating a congested DCN hop; rolls
        come from the plan's seeded RNG so runs replay."""
        if not self.kv_slow_ms:
            return 0.0
        with self._rng_lock:
            if self.kv_slow_p < 1.0 and \
                    self._rng.random() >= self.kv_slow_p:
                return 0.0
            self.injected["kv_slow"] += 1
            _count_injection("kv_slow")
        return self.kv_slow_ms / 1000.0

    def kv_hang_delay_s(self, rank: int) -> float:
        """kv_hang:<rank>@N[:MS] — seconds THIS rank must withhold its
        kvstore exchange at the current step (0.0 otherwise). Consumed on
        the first matching exchange of the step, so exactly one
        collective hangs; every other rank's watchdog then has one hung
        ``(kind, key, seq)`` to name."""
        if self._step is None or self._step not in self._kv_hang:
            return 0.0
        hang_rank, ms = self._kv_hang[self._step]
        if int(rank) != hang_rank:
            return 0.0
        del self._kv_hang[self._step]
        self.injected["kv_hang"] += 1
        _count_injection("kv_hang")
        return ms / 1000.0

    def kv_maybe_fail(self, op: str, key) -> None:
        """kv_flake:P — raise TransientKVError with probability P on each
        push/pull attempt (retries re-roll, so a retry loop eventually
        succeeds for P < 1)."""
        if self.kv_flake_p and self._rng.random() < self.kv_flake_p:
            self.injected["kv_flake"] += 1
            _count_injection("kv_flake")
            from ..kvstore import TransientKVError
            raise TransientKVError(
                f"chaos: injected transient {op} failure (key={key!r})")

    def serve_delay_s(self) -> float:
        """serve_slow:P@MS — seconds of injected per-batch compute delay
        for this dispatch (0.0 when the roll misses). The serving worker
        sleeps this long before running the model, simulating a straggler
        batch; rolls come from the plan's seeded RNG so runs replay."""
        if not self.serve_slow_ms:
            return 0.0
        with self._rng_lock:
            if self.serve_slow_p < 1.0 and \
                    self._rng.random() >= self.serve_slow_p:
                return 0.0
            self.injected["serve_slow"] += 1
            _count_injection("serve_slow")
        return self.serve_slow_ms / 1000.0

    def on_checkpoint_complete(self, step: int, path: str) -> None:
        """ckpt_corrupt — called by CheckpointManager._write after the DONE
        marker lands; corrupts the params payload while leaving DONE and the
        manifest intact (a forged-complete checkpoint)."""
        if self._ckpt_latest:
            self._ckpt_latest = False
        elif step in self._at["ckpt_corrupt"]:
            self._at["ckpt_corrupt"].discard(step)
        else:
            return
        self.injected["ckpt_corrupt"] += 1
        _count_injection("ckpt_corrupt")
        corrupt_file(os.path.join(path, "params"))

    def on_publish_complete(self, model: str, version: str,
                            path: str) -> None:
        """registry_corrupt — called by ``ModelRegistry.publish`` after
        the version's DONE marker lands; corrupts the params artifact
        while leaving DONE and both manifests intact (a forged-complete
        model version)."""
        if self._registry_latest:
            self._registry_latest = False
        elif version in self._registry_targets:
            self._registry_targets.discard(version)
        else:
            return
        self.injected["registry_corrupt"] += 1
        _count_injection("registry_corrupt")
        # the serving registry's artifact name (its ARTIFACT_PREFIX)
        corrupt_file(os.path.join(path, "model-0000.params"))


def corrupt_file(path: str, nbytes: int = 64) -> None:
    """Flip a run of bytes in the middle of ``path`` (size preserved, so
    only content verification — not a length check — can catch it)."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            f.write(b"\xff")
            return
        start = size // 2
        n = min(nbytes, size - start)
        f.seek(start)
        chunk = f.read(n)
        f.seek(start)
        f.write(bytes(b ^ 0xFF for b in chunk))


_plan: Optional[ChaosPlan] = None


def install(plan) -> ChaosPlan:
    """Install a plan (a ChaosPlan or a spec string) programmatically."""
    global _plan
    if isinstance(plan, str):
        plan = ChaosPlan(plan)
    if not isinstance(plan, ChaosPlan):
        raise MXNetError(f"chaos.install needs a ChaosPlan or spec string, "
                         f"got {type(plan).__name__}")
    _plan = plan
    return plan


def uninstall() -> None:
    global _plan
    _plan = None


def active() -> Optional[ChaosPlan]:
    """The installed plan, auto-installing from ``MXTPU_CHAOS`` when set.
    An env-installed plan is dropped/reparsed when the env var changes
    (keeps monkeypatched tests honest); a programmatic plan sticks until
    :func:`uninstall`."""
    global _plan
    spec = env.get("MXTPU_CHAOS") or None
    if _plan is not None:
        if _plan._env_spec is not None and spec != _plan._env_spec:
            _plan = ChaosPlan(spec, _env_spec=spec) if spec else None
        return _plan
    if spec:
        _plan = ChaosPlan(spec, _env_spec=spec)
    return _plan
