"""Fleet-wide communication observability: the collective ledger, desync
and straggler detection, the hung-collective flight recorder (ref: the
JAX package's ``telemetry/collective.py``; the reference's distributed
profiler over the kvstore command channel).

**Collective ledger** (:class:`CollectiveLedger`): every collective entry
point records ``(seq, kind, key, bytes, rank, t_enter, t_exit)`` into a
bounded per-process ring (``MXTPU_COLL_RING``) with a per-``(kind,
key)`` monotone ``seq``: the dist kvstore's push / pull and its ZeRO-1
``reduce_scatter`` / ``allgather`` / ``all_finite`` (``kvstore.py``), and
each cross-process collective of ``parallel/collectives.py`` (all-reduce,
all-gather, reduce-scatter, byte exchange, barrier). Off by default, one
flag check a collective when off; on whenever ``MXTPU_COLL_HEALTH`` or
``MXTPU_COLL_TIMEOUT_S`` is armed.

**The absent rank.** A ``torch.distributed`` collective blocks inside
the backend with no word of which peer it waits for. So while the plane
is on, every cross-process collective starts with an arrival handshake
over the group's ``TCPStore`` (``parallel/collectives.py _arrive``):
each rank sets its key for that call and waits for every peer's in rank
order, stamping the peer it waits on (:func:`note_waiting`). A rank that
withholds its exchange (chaos ``kv_hang:<rank>@N``) is then the peer
every survivor's in-flight record names.

**Desync / straggler detection**: :func:`health_check` allgathers each
rank's recent ledger digest over the group and :func:`compare_digests`
diffs them: a mismatch in the ``(kind, key, seq)`` order between ranks
is a desync diagnosis (logged, counted in ``mxtpu_coll_desync_total``,
raised under ``strict=True``); per-collective entry-time skew is
attributed per rank (``mxtpu_coll_skew_ms`` /
``mxtpu_coll_straggler_rank`` gauges, ``FitResult.comm_health``). Entry
times are normalised onto rank 0's clock by the median-of-K offset
handshake (:func:`sync_clocks`), the anchor the fleet trace merge
(``parallel/fleet_trace.py``) aligns per-rank traces with.

**Hung-collective flight recorder**: with ``MXTPU_COLL_TIMEOUT_S > 0`` a
watchdog thread is armed at each collective entry; a collective still in
flight past the timeout dumps a flight record (the ring, the hung
``(kind, key, seq)``, the absent rank, every thread's stack) to
``MXTPU_MEM_DUMP_DIR`` (tmp + rename). The fleet supervisor
(``parallel/supervisor.py``) reads it with :func:`scan_flight_records`.

The plane reads clocks and writes JSON, never a gradient: trajectories
are bit for bit the same with it on or off.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from ..base import MXNetError, env

__all__ = ["CollectiveLedger", "ledger", "enabled", "enter", "exit_",
           "note_waiting", "compare_digests", "health_check",
           "health_summary", "reset_health", "sync_clocks", "timeout_s",
           "health_interval", "ring_capacity", "parse_flight_record",
           "scan_flight_records"]

DEFAULT_RING = 4096

#: ring records serialized into a flight record / digest exchange
_TAIL = 200


def timeout_s() -> float:
    """``MXTPU_COLL_TIMEOUT_S``: hung-collective watchdog timeout in
    seconds (0 = watchdog off). Unparseable values raise — a typo'd
    watchdog request must not silently never fire."""
    try:
        t = float(env.get("MXTPU_COLL_TIMEOUT_S"))
    except (TypeError, ValueError) as e:
        raise MXNetError(
            f"MXTPU_COLL_TIMEOUT_S: not a number: "
            f"{env.raw('MXTPU_COLL_TIMEOUT_S')!r}") from e
    if t < 0:
        raise MXNetError(f"MXTPU_COLL_TIMEOUT_S must be >= 0, got {t}")
    return t


def health_interval() -> int:
    """``MXTPU_COLL_HEALTH``: run the cross-rank comm-health exchange
    every N steps (0 = off). N > 0 also turns the collective ledger on.
    Distributed runs: the exchange is a COLLECTIVE — every rank must
    call it at the same cadence (``fit.FitLoop`` does)."""
    try:
        n = int(env.get("MXTPU_COLL_HEALTH"))
    except (TypeError, ValueError) as e:
        raise MXNetError(
            f"MXTPU_COLL_HEALTH: not an integer: "
            f"{env.raw('MXTPU_COLL_HEALTH')!r}") from e
    if n < 0:
        raise MXNetError(f"MXTPU_COLL_HEALTH must be >= 0, got {n}")
    return n


def ring_capacity() -> int:
    """``MXTPU_COLL_RING``: collective-ledger ring capacity."""
    try:
        n = int(env.get("MXTPU_COLL_RING"))
    except (TypeError, ValueError) as e:
        raise MXNetError(
            f"MXTPU_COLL_RING: not an integer: "
            f"{env.raw('MXTPU_COLL_RING')!r}") from e
    if n < 1:
        raise MXNetError(f"MXTPU_COLL_RING must be >= 1, got {n}")
    return n


class CollectiveLedger:
    """Bounded per-process ring of collective records + the in-flight set
    the watchdog scans.

    A record is ``{seq, kind, key, bytes, rank, t_enter, t_exit,
    waiting_for}`` with times in ``perf_counter`` seconds; the
    perf↔epoch anchor captured at construction converts them to wall
    clock for the cross-rank digest and the flight record. ``seq`` is
    monotone per ``(kind, key)`` — the identity two ranks compare to
    detect a desynced collective order.
    """

    def __init__(self, ring: Optional[int] = None):
        self._lock = threading.Lock()
        self._cap = int(ring) if ring else DEFAULT_RING
        self._ring: deque = deque(maxlen=self._cap)
        self._seq: Dict[tuple, int] = {}
        self._inflight: Dict[int, Dict[str, Any]] = {}
        self._tokens = itertools.count(1)
        self._dropped = 0
        # perf_counter <-> epoch anchor, captured at one instant: every
        # cross-rank time comparison converts through it
        self._perf0 = time.perf_counter()
        self._epoch0 = time.time()
        #: this rank's clock minus rank 0's, in ms (sync_clocks)
        self.clock_offset_ms = 0.0
        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_lock = threading.Lock()
        self.watchdog_fired = 0
        self.flight_records: List[str] = []
        self._forced: Optional[bool] = None
        # raw env strings -> parsed (on, ring_cap, timeout_s): neither
        # enabled() nor enter() may re-run a typed parse per kvstore op
        self._env_cache: Optional[tuple] = None

    def _env_state(self) -> tuple:
        """(plane_on, ring_capacity, timeout_s), parsed once and cached
        against the raw env strings — the hot path pays three environ
        lookups and a tuple compare, not typed parses — while staying
        responsive to env changes (tests monkeypatch these vars
        mid-process). Strict-parse errors still raise on every call."""
        raw = (env.raw("MXTPU_COLL_HEALTH"),
               env.raw("MXTPU_COLL_TIMEOUT_S"),
               env.raw("MXTPU_COLL_RING"))
        c = self._env_cache
        if c is not None and c[0] == raw:
            return c[1]
        t = timeout_s()
        state = (health_interval() > 0 or t > 0, ring_capacity(), t)
        self._env_cache = (raw, state)
        return state

    # -- state ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        """On when forced programmatically, or when either the health
        exchange or the watchdog is armed (the flight record needs the
        ring, so arming the watchdog turns recording on too)."""
        if self._forced is not None:
            return self._forced
        return self._env_state()[0]

    def force(self, on: Optional[bool]) -> None:
        """Programmatic override: True/False pins the plane on/off
        regardless of env; None restores env-driven behavior."""
        self._forced = on

    def epoch_of(self, t_perf: float) -> float:
        return self._epoch0 + (t_perf - self._perf0)

    def depth(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq.clear()
            self._dropped = 0

    # -- recording ------------------------------------------------------
    def enter(self, kind: str, key, nbytes: int = 0, rank: int = 0) -> int:
        """Open one collective; returns the token :meth:`exit` closes.
        Callers gate on :attr:`enabled` — this method assumes the plane
        is on."""
        _, cap, tmo = self._env_state()
        t0 = time.perf_counter()
        with self._lock:
            if cap != self._cap:
                # a SHRINK evicts the oldest records right here — they
                # count as drops like any ring eviction, never silent
                self._dropped += max(0, len(self._ring) - cap)
                self._cap = cap
                self._ring = deque(self._ring, maxlen=cap)
            ident = (kind, str(key))
            # pop+reinsert keeps dict insertion order == recency, so the
            # bound below always evicts the LONGEST-IDLE identity. The
            # seq map must not grow forever: byte-channel collectives
            # (exchange/barrier/health tags) carry a counter in the KEY,
            # so each is a fresh identity. An identity idle for 4x the
            # ring has left the comparable window anyway — its seq
            # restarting at 0 can no longer desync a digest diff.
            seq = self._seq.pop(ident, -1) + 1
            self._seq[ident] = seq
            limit = 4 * self._cap
            while len(self._seq) > limit:
                del self._seq[next(iter(self._seq))]
            tok = next(self._tokens)
            self._inflight[tok] = {
                "seq": seq, "kind": kind, "key": str(key),
                "bytes": int(nbytes), "rank": int(rank),
                "t_enter": t0, "t_exit": None, "waiting_for": None}
        if tmo > 0:
            self._ensure_watchdog()
        return tok

    def note_waiting(self, tok: int, rank) -> None:
        """Stamp the peer rank the in-flight collective is currently
        blocked on (the byte-channel loop calls this before each blocking
        get) — the flight record's "absent rank"."""
        with self._lock:
            rec = self._inflight.get(tok)
            if rec is not None:
                rec["waiting_for"] = rank

    def exit(self, tok: int) -> None:
        with self._lock:
            rec = self._inflight.pop(tok, None)
            if rec is None:
                return
            rec["t_exit"] = time.perf_counter()
            rec["waiting_for"] = None
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(rec)

    # -- inspection -----------------------------------------------------
    def records(self, last_n: int = _TAIL) -> List[Dict[str, Any]]:
        """Completed records (copies), newest last, with epoch-converted
        times alongside the raw perf_counter ones."""
        with self._lock:
            recs = list(self._ring)[-last_n:]
        out = []
        for r in recs:
            d = dict(r)
            d["t_enter_epoch"] = self.epoch_of(r["t_enter"])
            if r["t_exit"] is not None:
                d["dur_ms"] = (r["t_exit"] - r["t_enter"]) * 1e3
            out.append(d)
        return out

    def digest(self, last_n: int = _TAIL) -> List[Dict[str, Any]]:
        """The cross-rank comparison payload: the last ``last_n``
        completed collectives as ``{kind, key, seq, bytes,
        t_enter_epoch}`` with entry times normalized onto rank 0's clock
        (``clock_offset_ms`` subtracted) so peers diff them directly."""
        off_s = self.clock_offset_ms / 1e3
        with self._lock:
            recs = list(self._ring)[-last_n:]
        return [{"kind": r["kind"], "key": r["key"], "seq": r["seq"],
                 "bytes": r["bytes"],
                 "t_enter_epoch": self.epoch_of(r["t_enter"]) - off_s}
                for r in recs]

    def inflight(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._inflight.values()]

    # -- watchdog -------------------------------------------------------
    def _ensure_watchdog(self) -> None:
        with self._watchdog_lock:
            if self._watchdog is not None and self._watchdog.is_alive():
                return
            self._watchdog = threading.Thread(
                target=self._watch, name="mxtpu-coll-watchdog", daemon=True)
            self._watchdog.start()

    def _watch(self) -> None:
        while True:
            try:
                t = self._env_state()[2]
            except MXNetError:
                t = 0.0  # env mutated to junk mid-run: disarm, don't die
            # poll capped at 250ms: the timeout can SHRINK between
            # wakes (env re-armed tighter), and a sleep sized from the
            # old value would doze through a whole hang window
            time.sleep(min(0.25, max(0.02, (t or 1.0) / 4.0)))
            if t <= 0:
                # disarmed with nothing in flight: exit instead of
                # polling for the process lifetime — the next armed
                # enter() re-spawns. The re-check runs under the spawn
                # lock so an enter() that just re-armed can't see a
                # live thread that then exits.
                with self._watchdog_lock:
                    try:
                        rearmed = self._env_state()[2] > 0
                    except MXNetError:
                        rearmed = False
                    with self._lock:
                        idle = not self._inflight
                    if not rearmed and idle:
                        self._watchdog = None
                        return
                continue
            now = time.perf_counter()
            with self._lock:
                overdue = [r for r in self._inflight.values()
                           if now - r["t_enter"] > t
                           and not r.get("_dumped")]
            if not overdue:
                continue
            try:
                self._dump_flight(overdue, t)
                with self._lock:
                    for r in overdue:
                        r["_dumped"] = True
            except Exception as e:
                # a failed dump (full/unwritable disk) RETRIES on the
                # next wake — marking first would silently lose the one
                # record the recorder exists to write; after 3 failures
                # give up, but the hang is still NAMED in the log
                with self._lock:
                    for r in overdue:
                        r["_fails"] = r.get("_fails", 0) + 1
                        if r["_fails"] >= 3:
                            r["_dumped"] = True
                try:
                    from ..log import get_logger
                    get_logger("mxnet_tpu_torch.telemetry").error(
                        "flight-record dump failed (%s); hung "
                        "collectives: %s", e,
                        [(r["kind"], r["key"], r["seq"])
                         for r in overdue])
                except Exception:
                    pass  # the black box must not take down the run

    def _dump_flight(self, overdue: List[dict], timeout: float) -> str:
        """The flight record: every surviving rank writes one naming the
        hung ``(kind, key, seq)`` and the absent rank, with the ring and
        all-thread stacks — enough to diagnose the hang from disk after
        the group is killed. tmp+rename like ``memory.dump_forensics``."""
        now = time.perf_counter()
        names = {th.ident: th.name for th in threading.enumerate()}
        stacks = {}
        for ident, frame in sys._current_frames().items():
            stacks[names.get(ident, f"thread-{ident}")] = \
                traceback.format_stack(frame)
        hung = []
        absent = None
        for r in sorted(overdue, key=lambda r: -r["t_enter"]):
            hung.append({
                "kind": r["kind"], "key": r["key"], "seq": r["seq"],
                "bytes": r["bytes"], "rank": r["rank"],
                "waiting_for_rank": r["waiting_for"],
                "elapsed_s": round(now - r["t_enter"], 3),
                "t_enter_epoch": self.epoch_of(r["t_enter"])})
            if absent is None and r["waiting_for"] is not None:
                # the most recently entered collective with a named peer
                # is the innermost transport hop — its peer is the rank
                # that never showed up
                absent = r["waiting_for"]
        payload = {
            "reason": "hung_collective",
            "time_unix": time.time(),
            "pid": os.getpid(),
            "rank": hung[0]["rank"] if hung else 0,
            "timeout_s": timeout,
            "absent_rank": absent,
            # when the EARLIEST still-hung collective entered (epoch
            # seconds): with absent_rank these two top-level fields are
            # the machine-readable contract the fleet supervisor
            # (parallel/supervisor.py) keys its shrink decision on —
            # everything else in the record is for humans
            "hung_since": min(self.epoch_of(r["t_enter"])
                              for r in overdue),
            "hung": hung,
            "ring": self.records(_TAIL),
            "thread_stacks": stacks,
        }
        d = str(env.get("MXTPU_MEM_DUMP_DIR") or "") or "."
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            d = "."
        path = os.path.join(
            d, f"coll_flight_{os.getpid()}_{next(_dump_seq)}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        os.replace(tmp, path)
        self.watchdog_fired += 1
        self.flight_records.append(path)
        try:
            from .registry import default_registry
            default_registry().counter(
                "mxtpu_coll_watchdog_fired_total",
                "Hung-collective flight records written "
                "(MXTPU_COLL_TIMEOUT_S watchdog).").inc()
        except Exception:
            pass
        try:
            from ..log import get_logger
            get_logger("mxnet_tpu_torch.telemetry").error(
                "hung collective: %s:%s seq=%d in flight > %gs "
                "(absent rank: %s) — flight record %s",
                hung[0]["kind"], hung[0]["key"], hung[0]["seq"],
                timeout, absent, path)
        except Exception:
            pass
        return path


#: the process-wide ledger
ledger = CollectiveLedger()

_dump_seq = itertools.count(1)
_clk_seq = itertools.count(1)
_health_seq = itertools.count(1)


def enabled() -> bool:
    return ledger.enabled


def enter(kind: str, key, nbytes: int = 0, rank: int = 0) -> int:
    return ledger.enter(kind, key, nbytes, rank)


def exit_(tok: int) -> None:
    ledger.exit(tok)


def note_waiting(tok: int, rank) -> None:
    ledger.note_waiting(tok, rank)


# ---------------------------------------------------------------------------
# Flight-record consumption (the supervisor side of the watchdog)
# ---------------------------------------------------------------------------

def parse_flight_record(path: str) -> Dict[str, Any]:
    """Parse one ``coll_flight_*.json`` dump into the stable supervisor
    schema: ``{path, pid, rank, absent_rank, hung_since, time_unix,
    hung}``. Tolerates pre-``hung_since`` records (PR 12 layout:
    ``hung_since`` comes back None) — the supervisor must be able to read
    a record written by an older surviving rank. Raises
    :class:`MXNetError` on anything that is not a hung-collective flight
    record; an unreadable record must fail the parse, not silently count
    as "no hang"."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        raise MXNetError(f"flight record {path}: unreadable: {e}") from e
    if payload.get("reason") != "hung_collective":
        raise MXNetError(
            f"flight record {path}: reason is "
            f"{payload.get('reason')!r}, not 'hung_collective'")
    absent = payload.get("absent_rank")
    return {
        "path": path,
        "pid": payload.get("pid"),
        "rank": payload.get("rank"),
        "absent_rank": int(absent) if absent is not None else None,
        "hung_since": payload.get("hung_since"),
        "time_unix": payload.get("time_unix"),
        "hung": payload.get("hung", []),
    }


def scan_flight_records(dump_dir: str,
                        seen: Optional[set] = None) -> List[Dict[str, Any]]:
    """List-and-parse every ``coll_flight_*.json`` under ``dump_dir`` not
    already in ``seen`` (a set of paths the caller owns; updated in
    place). The supervisor polls this between worker waits — records are
    tmp+rename so a listed file always parses; one that still fails is
    skipped this pass and retried on the next (never marked seen)."""
    out: List[Dict[str, Any]] = []
    if not os.path.isdir(dump_dir):
        return out
    for name in sorted(os.listdir(dump_dir)):
        if not (name.startswith("coll_flight_")
                and name.endswith(".json")):
            continue
        path = os.path.join(dump_dir, name)
        if seen is not None and path in seen:
            continue
        try:
            rec = parse_flight_record(path)
        except MXNetError:
            continue
        if seen is not None:
            seen.add(path)
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Desync / straggler detection
# ---------------------------------------------------------------------------

_health_lock = threading.Lock()
_last_compare: Optional[Dict[str, Any]] = None
_checks = 0
# watchdog/flight baselines at the last reset_health(): a FitResult's
# comm_health reports THIS run's firings, not the process lifetime's
_baseline = {"fired": 0, "flights": 0}


def reset_health() -> None:
    """Re-arm the health plane for a fresh run (``fit.FitLoop`` calls
    this at fit start, like ``memory.reset_pressure_state``): drops the
    previous run's comparison/check count and snapshots the watchdog
    baselines so :func:`health_summary` describes only this run."""
    global _last_compare, _checks
    with _health_lock:
        _last_compare = None
        _checks = 0
        _baseline["fired"] = ledger.watchdog_fired
        _baseline["flights"] = len(ledger.flight_records)


def compare_digests(per_rank: Dict[int, List[dict]]) -> Dict[str, Any]:
    """Diff per-rank ledger digests: desynced collective order + per-rank
    entry-time skew.

    - **Desync**: restricted to the ``(kind, key, seq)`` identities every
      rank saw, the ORDER must be identical on all ranks — ranks issuing
      the same collectives in different orders is the deadlock-in-waiting
      the reference's dependency engine makes possible. The first
      divergence is named in the diagnosis.
    - **Skew**: for each common identity, each rank's entry lag behind
      the earliest rank, in ms (entry times are already normalized onto
      rank 0's clock by :meth:`CollectiveLedger.digest`). The rank with
      the largest mean lag is the straggler.
    """
    ranks = sorted(int(r) for r in per_rank)
    ids_by_rank = {r: [(d["kind"], d["key"], d["seq"]) for d in per_rank[r]]
                   for r in ranks}
    common = None
    for r in ranks:
        s = set(ids_by_rank[r])
        common = s if common is None else common & s
    common = common or set()
    desync = None
    ref_order = [i for i in ids_by_rank[ranks[0]] if i in common]
    for r in ranks[1:]:
        mine = [i for i in ids_by_rank[r] if i in common]
        if mine != ref_order:
            pos = 0
            for pos, (a, b) in enumerate(zip(ref_order, mine)):
                if a != b:
                    break
            desync = {
                "ranks": [ranks[0], r], "position": pos,
                "expected": list(ref_order[pos])
                if pos < len(ref_order) else None,
                "got": list(mine[pos]) if pos < len(mine) else None}
            break
    times: Dict[tuple, Dict[int, float]] = {}
    for r in ranks:
        for d in per_rank[r]:
            i = (d["kind"], d["key"], d["seq"])
            if i in common:
                times.setdefault(i, {})[r] = float(d["t_enter_epoch"])
    lags: Dict[int, List[float]] = {r: [] for r in ranks}
    for ts in times.values():
        mn = min(ts.values())
        for r, t in ts.items():
            lags[r].append((t - mn) * 1e3)
    skew_by_rank = {}
    for r in ranks:
        ls = lags[r]
        skew_by_rank[r] = {
            "mean_ms": round(sum(ls) / len(ls), 3) if ls else 0.0,
            "max_ms": round(max(ls), 3) if ls else 0.0}
    max_skew = max((v["max_ms"] for v in skew_by_rank.values()),
                   default=0.0)
    straggler = None
    if max_skew > 0:
        straggler = max(ranks, key=lambda r: skew_by_rank[r]["mean_ms"])
    return {"world": len(ranks), "compared": len(common),
            "desync": desync, "skew_ms_by_rank": skew_by_rank,
            "max_skew_ms": max_skew, "straggler_rank": straggler}


def sync_clocks(k: int = 5) -> float:
    """Median-of-K round-trip clock-offset handshake over the group:
    estimates this rank's wall clock minus rank 0's, in ms. Each round
    every rank publishes its epoch time; a peer reads rank 0's inside a
    locally timed window, so ``offset ~ midpoint - rank0_publish`` per
    round; the median fences scheduler noise. The offset lands in the
    ledger (digest normalisation) and the tracer's clock anchor. A
    collective: every rank calls with the same ``k``. Outside a group it
    returns 0.0."""
    import pickle
    from ..parallel import collectives as _c
    if _c.world() <= 1:
        return 0.0
    rank = _c.rank()
    offsets = []
    base = next(_clk_seq)
    for i in range(int(k)):
        t0 = time.time()
        blobs = _c.cross_process_exchange_bytes(
            pickle.dumps(time.time()), f"clk{base}_{i}")
        t1 = time.time()
        ref_t = pickle.loads(blobs[0])
        offsets.append(((t0 + t1) / 2.0 - ref_t) * 1e3)
    offsets.sort()
    # rank 0 IS the reference clock: it runs the K rounds (the collective
    # contract) and pins 0.0
    off = 0.0 if rank == 0 else offsets[len(offsets) // 2]
    ledger.clock_offset_ms = off
    try:
        from .tracer import tracer as _tr
        _tr.clock_offset_ms = off
    except Exception:
        pass
    return off


def health_check(kv=None, breakdown=None, strict: bool = False
                 ) -> Dict[str, Any]:
    """One comm-health round: exchange ledger digests across the worker
    group (``kv.num_workers > 1``; a single-worker / simulated-world run
    compares against itself) and
    publish the diagnosis — skew gauges, desync counter/log, the
    step-breakdown straggler note. ``strict=True`` raises on a desynced
    collective order instead of just diagnosing it.

    Distributed runs: this is a COLLECTIVE (the digest allgather rides
    the group's byte exchange) — every rank must call at the same cadence;
    ``fit.FitLoop`` drives it every ``MXTPU_COLL_HEALTH`` steps."""
    global _checks, _last_compare
    my_rank = int(getattr(kv, "rank", 0) or 0)
    world = int(getattr(kv, "num_workers", 1) or 1)
    my = ledger.digest()
    per_rank = {my_rank: my}
    if kv is not None and world > 1:
        from ..parallel.collectives import cross_process_allgather_object
        outs = cross_process_allgather_object(
            {"rank": my_rank, "digest": my},
            f"health{next(_health_seq)}_")
        per_rank = {int(o["rank"]): o["digest"] for o in outs}
    cmp = compare_digests(per_rank)
    cmp["rank"] = my_rank
    with _health_lock:
        _checks += 1
        _last_compare = cmp
    try:
        from .registry import default_registry
        reg = default_registry()
        reg.gauge("mxtpu_coll_skew_ms",
                  "Max per-collective entry-time skew across ranks at "
                  "the last comm-health check (ms).").set(
            cmp["max_skew_ms"])
        reg.gauge("mxtpu_coll_straggler_rank",
                  "Rank with the largest mean collective entry lag at "
                  "the last comm-health check (-1 = none).").set(
            cmp["straggler_rank"] if cmp["straggler_rank"] is not None
            else -1)
        if cmp["desync"]:
            reg.counter(
                "mxtpu_coll_desync_total",
                "Cross-rank collective-order mismatches diagnosed by "
                "the comm-health exchange.").inc()
    except Exception:
        pass
    if cmp["desync"]:
        msg = (f"collective desync between ranks {cmp['desync']['ranks']}"
               f" at position {cmp['desync']['position']}: expected "
               f"{cmp['desync']['expected']}, got {cmp['desync']['got']}")
        try:
            from ..log import get_logger
            get_logger("mxnet_tpu_torch.telemetry").error(
                "comm health: %s", msg)
        except Exception:
            pass
        if strict:
            raise MXNetError(f"comm health: {msg}")
    if breakdown is not None:
        try:
            breakdown.note_comm_health(cmp)
        except Exception:
            pass
    return cmp


def health_summary() -> Dict[str, Any]:
    """The ``FitResult.comm_health`` payload: the last comparison since
    :func:`reset_health` (or a zero-skew self view when no check ran),
    plus the ledger / watchdog state — watchdog firings and flight
    records are reported relative to the last reset, so one run's
    summary never carries an earlier run's hangs."""
    with _health_lock:
        cmp = dict(_last_compare) if _last_compare else None
        checks = _checks
        fired0 = _baseline["fired"]
        flights0 = _baseline["flights"]
    if cmp is None:
        cmp = compare_digests({0: ledger.digest()})
        cmp["rank"] = 0
    cmp.update({
        "checks": checks,
        "ledger_depth": ledger.depth(),
        "ledger_dropped": ledger.dropped,
        "watchdog_fired": ledger.watchdog_fired - fired0,
        "flight_records": list(ledger.flight_records[flights0:]),
        "clock_offset_ms": round(ledger.clock_offset_ms, 3),
    })
    return cmp
