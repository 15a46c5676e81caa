"""Device-memory observability: live-byte ledger and pressure forensics
(ref: the JAX package's ``telemetry/memory.py``).

**Live-byte ledger** (:class:`MemoryLedger`): every framework-owned
device allocation is registered by its OWNER at the moment it happens —
``gluon.Parameter`` data and gradient buffers, optimizer state and f32
masters (the per-parameter ``Updater`` and the grouped update),
``DeviceStagingIter``'s staged-ahead batches — keyed by category, with
the byte count derived from the tensor's shape and dtype. The ledger is
exact by construction for the tracked categories on every device; on the
card it is a lower bound of ``torch.cuda.memory_allocated()``
(activations, workspaces and the caching allocator's rounding are not
framework objects), and :func:`reconcile` cross-checks the two.

**Pressure forensics**: :func:`dump_forensics` writes the black-box
recording — ranked ledger categories, top live buffers with owners, the
allocator's statistics and the recent trace window — to a JSON file. It
fires on allocation failure (``torch.cuda.OutOfMemoryError``, via
:func:`oom_guard` / :func:`maybe_dump_oom`), on the live watermark
exceeding ``MXTPU_MEM_BUDGET`` (checked per step by ``fit.FitLoop``), and
on the deterministic ``mem_pressure@N[:BYTES]`` chaos event, so the dump
path is testable on the CPU.

**Per-program attribution** (``record_program`` ... ``program_report``):
the static footprint and cost of each program the port runs as one unit
(a megastep graph, ``SPMDTrainer.run_steps``'s K-step graph, a grouped
optimizer bucket, a hybridized block's forward and backward), counted on
one observed execution by ``efficiency.CostCounter`` (the JAX package
reads XLA's ``memory_analysis()`` instead). A program's ``temp_bytes``
are the activations and workspaces the ledger does not see, so the
ledger plus the programs' ``temp_bytes`` is the split of
``torch.cuda.memory_allocated()`` the ledger alone cannot give. The
registry gauges ``mxtpu_mem_*`` and ``mxtpu_program_*`` read both.

Ledger mutations are rare (allocation-time, not per-op) and O(1); nothing
here touches the hot dispatch path.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..base import env

__all__ = ["CATEGORIES", "MemoryLedger", "ledger", "nd_bytes",
           "compiled_memory_stats", "record_program", "merge_program",
           "get_program", "program_report", "program_total",
           "register_cache_programs", "dump_forensics", "check_pressure",
           "oom_guard", "maybe_dump_oom", "is_oom", "budget_bytes",
           "reset_pressure_state", "reconcile", "track_param_data",
           "track_param_grad", "drop_param_grad", "track_optimizer_state",
           "drop_optimizer_state", "drop_updater_states", "track_ndarray"]

#: ledger categories, in the order forensics ranks ties
CATEGORIES = ("params", "grads", "grad_buckets", "optimizer", "masters",
              "staging", "kvstore", "serving_cache", "aot_bundles", "other")

_KEYS = itertools.count(1)


def nd_bytes(x) -> int:
    """Bytes of a torch tensor, an NDArray (its tensor) or a numpy array,
    from shape x itemsize; a row_sparse array counts its values and its
    row ids."""
    try:
        n = 0
        idx = getattr(x, "_indices", None)
        if isinstance(idx, torch.Tensor):
            n = int(idx.numel()) * int(idx.element_size())
        t = getattr(x, "_data", x)
        if isinstance(t, torch.Tensor):
            return n + int(t.numel()) * int(t.element_size())
        return n + int(t.size) * int(t.dtype.itemsize)
    except Exception:
        return 0


class MemoryLedger:
    """Thread-safe category/owner-keyed byte ledger with watermarks.

    Entries are ``(category, key) -> (nbytes, owner)``; :meth:`set`
    replaces in place (re-allocation, dtype cast), :meth:`drop` frees.
    Owners that cannot call drop deterministically attach a
    ``weakref.finalize`` via :meth:`attach` so the entry dies with the
    buffer's owning object. Besides the live totals the ledger keeps a
    process-lifetime peak and a resettable *window* peak — ``fit.FitLoop``
    opens a window per step, giving per-step ``peak_bytes``/``delta_bytes``.
    """

    def __init__(self):
        # RLock: drops run from weakref.finalize, which the cyclic GC may
        # fire on this thread while it already holds the lock
        self._lock = threading.RLock()
        self._entries: Dict[Tuple[str, Any], Tuple[int, str]] = {}
        self._by_cat: Dict[str, int] = {}
        self._total = 0
        self._peak = 0
        self._win_base = 0
        self._win_peak = 0

    # -- mutation -------------------------------------------------------
    def _bump(self, category: str, delta: int) -> None:
        # caller holds the lock
        self._by_cat[category] = self._by_cat.get(category, 0) + delta
        self._total += delta
        if self._total > self._peak:
            self._peak = self._total
        if self._total > self._win_peak:
            self._win_peak = self._total

    def set(self, category: str, key, nbytes: int, owner: str = "") -> None:
        """Register (or resize) one live allocation."""
        nbytes = int(nbytes)
        with self._lock:
            old = self._entries.get((category, key))
            self._entries[(category, key)] = (nbytes, owner)
            self._bump(category, nbytes - (old[0] if old else 0))

    def drop(self, category: str, key) -> None:
        with self._lock:
            old = self._entries.pop((category, key), None)
            if old is not None:
                self._bump(category, -old[0])

    def drop_owner(self, category: str, owner_prefix: str) -> None:
        """Free every entry in ``category`` whose owner starts with
        ``owner_prefix``."""
        self.drop_matching(lambda cat, _key, own:
                           cat == category and own.startswith(owner_prefix))

    def drop_matching(self, predicate: Callable[[str, Any, str], bool]
                      ) -> None:
        """Free every entry for which ``predicate(category, key, owner)``
        is true."""
        with self._lock:
            doomed = [k for k, (_, own) in self._entries.items()
                      if predicate(k[0], k[1], own)]
            for k in doomed:
                nbytes, _ = self._entries.pop(k)
                self._bump(k[0], -nbytes)

    def attach(self, category: str, nbytes: int, owner: str, obj,
               key=None):
        """Register an allocation and free it automatically when ``obj``
        is garbage-collected. Returns the entry key."""
        if key is None:
            key = ("auto", next(_KEYS))
        self.set(category, key, nbytes, owner)
        try:
            weakref.finalize(obj, self.drop, category, key)
        except TypeError:
            pass  # un-weakref-able owner: entry lives for the process
        return key

    # -- inspection -----------------------------------------------------
    def live_bytes(self, category: Optional[str] = None,
                   owner_prefix: Optional[str] = None) -> int:
        with self._lock:
            if category is None:
                return self._total
            if owner_prefix is None:
                return self._by_cat.get(category, 0)
            return sum(n for (cat, _), (n, own) in self._entries.items()
                       if cat == category and own.startswith(owner_prefix))

    def snapshot(self) -> Dict[str, int]:
        """Live bytes per category (only categories with bytes)."""
        with self._lock:
            return {c: n for c, n in sorted(self._by_cat.items()) if n}

    @property
    def peak_bytes(self) -> int:
        return self._peak

    def begin_window(self) -> int:
        """Open a watermark window (one per step); returns live bytes."""
        with self._lock:
            self._win_base = self._total
            self._win_peak = self._total
            return self._total

    def window_stats(self) -> Tuple[int, int]:
        """(peak, delta) bytes since :meth:`begin_window`."""
        with self._lock:
            return self._win_peak, self._total - self._win_base

    def top(self, n: int = 20) -> List[Dict[str, Any]]:
        """The ``n`` largest live allocations, ranked."""
        with self._lock:
            items = [{"category": cat, "owner": own, "bytes": size}
                     for (cat, _), (size, own) in self._entries.items()]
        items.sort(key=lambda e: -e["bytes"])
        return items[:n]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            total, peak = self._total, self._peak
            by_cat = {c: n for c, n in sorted(self._by_cat.items()) if n}
        return {"live_bytes": total, "peak_bytes": peak,
                "by_category": by_cat,
                "budget_bytes": budget_bytes() or None}


_LEDGER = MemoryLedger()
_metrics_installed = False
_install_lock = threading.Lock()


def ledger() -> MemoryLedger:
    """The process-wide ledger (installs registry gauges on first use)."""
    _install_metrics()
    return _LEDGER


def _install_metrics() -> None:
    global _metrics_installed
    with _install_lock:
        if _metrics_installed:
            return
        _metrics_installed = True
    try:
        from .registry import default_registry
        reg = default_registry()
        reg.callback_gauge(
            "mxtpu_mem_live_bytes", _LEDGER.live_bytes,
            "Live framework-attributed device bytes (memory ledger).")
        reg.callback_gauge(
            "mxtpu_mem_peak_bytes", lambda: _LEDGER.peak_bytes,
            "Process-lifetime peak of the memory-ledger total.")
        for cat in CATEGORIES:
            reg.callback_gauge(
                f"mxtpu_mem_{cat}_bytes",
                (lambda c=cat: _LEDGER.live_bytes(c)),
                f"Live device bytes attributed to category '{cat}'.")
        reg.callback_gauge(
            "mxtpu_program_temp_bytes", lambda: _program_total("temp_bytes"),
            "Temp (workspace / activation) bytes over recorded programs "
            "(one counted execution each).")
        reg.callback_gauge(
            "mxtpu_program_argument_bytes",
            lambda: _program_total("argument_bytes"),
            "Argument bytes over recorded programs.")
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Owner hooks. Never raise: observability must not take down training.
# ---------------------------------------------------------------------------

def _param_key(p) -> Optional[int]:
    key = getattr(p, "_mem_key", None)
    if key is None:
        key = next(_KEYS)
        try:
            p._mem_key = key
        except Exception:
            return None
        weakref.finalize(p, _drop_param_entries, key)
    return key


def _drop_param_entries(key: int) -> None:
    try:
        _LEDGER.drop("params", ("p", key))
        _LEDGER.drop("grads", ("g", key))
    except Exception:
        pass  # interpreter shutdown


def track_param_data(p) -> None:
    """Register (or resize) a Parameter's tensor."""
    try:
        t = p.tensor
        if t is None:
            return
        key = _param_key(p)
        if key is not None:
            _LEDGER.set("params", ("p", key), nd_bytes(t), owner=p.name)
    except Exception:
        pass


def track_param_grad(p, grad=None) -> None:
    """Register (or resize) a Parameter's gradient buffer."""
    try:
        if grad is None:
            nd_ = getattr(p, "_nd", None)
            grad = getattr(nd_, "_grad", None)
        if grad is None:
            return
        key = _param_key(p)
        if key is not None:
            _LEDGER.set("grads", ("g", key), nd_bytes(grad), owner=p.name)
    except Exception:
        pass


def drop_param_grad(p) -> None:
    try:
        key = getattr(p, "_mem_key", None)
        if key is not None:
            _LEDGER.drop("grads", ("g", key))
    except Exception:
        pass


def _updater_key(updater) -> Optional[int]:
    key = getattr(updater, "_mem_key", None)
    if key is None:
        key = next(_KEYS)
        try:
            updater._mem_key = key
        except Exception:
            return None
        weakref.finalize(updater, _drop_updater_entries, key)
    return key


def _drop_updater_entries(utok: int) -> None:
    try:
        _LEDGER.drop_matching(
            lambda _cat, key, _own: isinstance(key, tuple) and
            len(key) == 2 and key[0] == utok)
    except Exception:
        pass


def drop_updater_states(updater) -> None:
    """Free every optimizer/masters entry of this updater (checkpoint
    restore replaces the state dict wholesale)."""
    utok = getattr(updater, "_mem_key", None)
    if utok is not None:
        _drop_updater_entries(utok)


def _state_arrays(state) -> List:
    out = []
    if state is None:
        return out
    if isinstance(state, (tuple, list)):
        for s in state:
            out.extend(_state_arrays(s))
    elif isinstance(state, torch.Tensor) or hasattr(state, "_data"):
        out.append(state)
    return out


def track_optimizer_state(updater, index, state, param=None,
                          weight=None) -> None:
    """Register one parameter's optimizer state; the f32 master copy of a
    multi-precision state (the ``(inner, w32)`` convention of
    ``create_state_multi_precision``) is split into the ``masters``
    category. The split needs the weight's dtype, from ``param``, the
    ``weight`` array or ``opt.param_dict``; without one the state lands
    wholly in ``optimizer`` (the total stays exact)."""
    try:
        utok = _updater_key(updater)
        if utok is None:
            return
        opt = updater.optimizer
        if param is None:
            param = getattr(opt, "param_dict", {}).get(index)
        name = getattr(param, "name", str(index))
        wdt = None
        t = getattr(param, "tensor", None) if param is not None else None
        if t is not None:
            wdt = t.dtype
        elif weight is not None:
            wdt = getattr(weight, "_data", weight).dtype
        master = None
        inner = state
        if bool(getattr(opt, "multi_precision", False)) and \
                isinstance(state, tuple) and len(state) == 2 and \
                _state_arrays(state[1]) and \
                wdt is not None and wdt != torch.float32:
            inner, master = state
        # a ZeRO-1 plane stamps the updater with its partition: each
        # entry names its owning rank ('state:zr<r>/<N>:'), so per-rank
        # bytes are a queryable prefix
        zs = getattr(updater, "_zero_shard", None)
        tag = zs.get(index) if zs else None
        shard = f"zr{tag}:" if tag is not None else ""
        inner_bytes = sum(nd_bytes(a) for a in _state_arrays(inner))
        _LEDGER.set("optimizer", (utok, index), inner_bytes,
                    owner=f"state:{shard}{name}")
        if master is not None:
            _LEDGER.set("masters", (utok, index), nd_bytes(master),
                        owner=f"master:{shard}{name}")
        else:
            _LEDGER.drop("masters", (utok, index))
    except Exception:
        pass


def drop_optimizer_state(updater, index) -> None:
    """Free one state's entries (sentinel-skipped step rollback)."""
    try:
        utok = getattr(updater, "_mem_key", None)
        if utok is not None:
            _LEDGER.drop("optimizer", (utok, index))
            _LEDGER.drop("masters", (utok, index))
    except Exception:
        pass


# ---------------------------------------------------------------------------
# The sparse embedding plane (parallel/embedding_plane.py; ref: the JAX
# package's telemetry/memory.py): each rank's table shard under
# ``params`` as ``emb<r>/<N>:<table>`` and its lazily created row
# optimizer state under ``optimizer`` as ``state:emb<r>/<N>:<table>``, so
# "per-rank bytes are exactly 1/world" is a ledger query. Stable keys:
# the entry tracks the logical shard.
# ---------------------------------------------------------------------------

def plane_owner(rank: int, world: int, name: str,
                state: bool = False) -> str:
    """The ledger owner string of one plane shard (or its row state)."""
    tag = f"emb{int(rank)}/{int(world)}:{name}"
    return f"state:{tag}" if state else tag


def track_plane_shard(name: str, rank: int, world: int, arr) -> None:
    """Register (or resize) one rank's table shard."""
    try:
        _LEDGER.set("params", ("embshard", name, int(rank)),
                    nd_bytes(arr), owner=plane_owner(rank, world, name))
    except Exception:
        pass


def track_plane_state(name: str, rank: int, world: int, arrs) -> None:
    """Register one rank's lazily created row optimizer state."""
    try:
        _LEDGER.set("optimizer", ("embstate", name, int(rank)),
                    sum(nd_bytes(a) for a in arrs),
                    owner=plane_owner(rank, world, name, state=True))
    except Exception:
        pass


def drop_plane_state(name: str, rank: int, world: int) -> None:
    """Free one rank's row-state entry (the rollback of a skipped step
    that first created it)."""
    try:
        _LEDGER.drop("optimizer", ("embstate", name, int(rank)))
    except Exception:
        pass


def drop_plane(name: str) -> None:
    """Free every ledger entry of one plane."""
    try:
        _LEDGER.drop_matching(
            lambda _cat, key, _own: isinstance(key, tuple) and len(key) == 3
            and key[0] in ("embshard", "embstate") and key[1] == name)
    except Exception:
        pass


def track_ndarray(category: str, nd, owner: str = "") -> None:
    """Register a transient buffer, freed when the array dies."""
    try:
        _LEDGER.attach(category, nd_bytes(nd), owner, nd)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Per-program attribution
# ---------------------------------------------------------------------------

_PROGRAMS: Dict[Tuple[str, str], Dict[str, Any]] = {}
_prog_lock = threading.Lock()


def compiled_memory_stats(counter, arguments=(),
                          outputs=()) -> Optional[Dict[str, int]]:
    """The memory fields of one counted execution (an
    ``efficiency.CostCounter`` that observed it) as a plain int dict;
    None without a counter. A view over ``efficiency.program_stats``,
    whose cost half lands in the same registry records."""
    from .efficiency import MEMORY_FIELDS, compiled_program_stats
    stats = compiled_program_stats(counter, arguments, outputs)
    if stats is None or "argument_bytes" not in stats:
        return None
    return {k: stats[k] for k in MEMORY_FIELDS}


def record_program(kind: str, label: str, stats: Dict[str, Any]) -> None:
    """Record one program's footprint and cost, keyed by (kind, label),
    e.g. ("megastep", "megastep:SGD:ab12..."). The registry's
    ``mxtpu_program_*`` gauges read the records."""
    _install_metrics()
    with _prog_lock:
        _PROGRAMS[(kind, label)] = dict(stats)


def merge_program(kind: str, label: str, stats: Dict[str, Any]) -> None:
    """Merge fields into one program's record ATOMICALLY (under the
    registry lock): two threads adding fields to one record must not
    clobber each other's."""
    _install_metrics()
    with _prog_lock:
        rec = dict(_PROGRAMS.get((kind, label)) or {})
        rec.update(stats)
        _PROGRAMS[(kind, label)] = rec


def get_program(kind: str, label: str) -> Optional[Dict[str, Any]]:
    with _prog_lock:
        hit = _PROGRAMS.get((kind, label))
    return dict(hit) if hit is not None else None


def drop_program(kind: str, label: str) -> None:
    """Forget one program's record (it is counted again when it next
    runs)."""
    with _prog_lock:
        _PROGRAMS.pop((kind, label), None)


def program_report(limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Recorded programs ranked by temp (workspace) bytes."""
    with _prog_lock:
        rows = [{"kind": k, "label": lbl, **st}
                for (k, lbl), st in _PROGRAMS.items()]
    rows.sort(key=lambda r: -int(r.get("temp_bytes", 0)))
    return rows[:limit] if limit else rows


def _program_total(field: str) -> int:
    with _prog_lock:
        return sum(int(st.get(field, 0) or 0) for st in _PROGRAMS.values())


def program_total(field: str) -> int:
    """Sum of one numeric field over every recorded program (the
    ``mxtpu_program_*`` gauges — memory fields here, cost fields via
    ``efficiency``'s gauges)."""
    return _program_total(field)


def register_cache_programs(owner: str, op, stats: Dict[str, dict]) -> None:
    """Ledger the footprint (temp + output bytes) of a signature cache's
    programs under ``serving_cache``, freed when the owning object dies
    and refreshed wholesale on each call (evicted signatures drop
    out)."""
    try:
        # trailing ':' keeps prefix matching exact — owner 'sigcache3'
        # must not also claim 'sigcache30' entries
        _LEDGER.drop_owner("serving_cache", owner + ":")
        for digest, st in stats.items():
            _LEDGER.set("serving_cache", (owner, digest),
                        int(st.get("temp_bytes", 0)) +
                        int(st.get("output_bytes", 0)),
                        owner=f"{owner}:{digest}")
        if not getattr(op, "_mem_finalized", False):
            try:
                op._mem_finalized = True
                weakref.finalize(op, _LEDGER.drop_owner,
                                 "serving_cache", owner + ":")
            except Exception:
                pass
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Pressure monitoring + forensics
# ---------------------------------------------------------------------------

_dump_seq = itertools.count(1)
_budget_exceeded = [False]  # rising-edge latch; re-armed per fit() run


def budget_bytes() -> int:
    """MXTPU_MEM_BUDGET in bytes (0 = no budget)."""
    try:
        return int(env.get("MXTPU_MEM_BUDGET"))
    except (TypeError, ValueError):
        return 0


def reset_pressure_state() -> None:
    """Re-arm the budget-exceeded edge detector (one dump per run)."""
    _budget_exceeded[0] = False


def is_oom(exc: BaseException) -> bool:
    """Does this exception look like a device allocation failure?"""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in text or "Out of memory" in text or
            "out of memory" in text)


def maybe_dump_oom(exc: BaseException, step: Optional[int] = None) -> bool:
    """If ``exc`` is an allocation failure, write the forensics dump
    (best-effort — a failed dump must not mask the OOM) and return True.
    ``oom_guard`` and ``fit.FitLoop``'s exception path both route here."""
    if not (isinstance(exc, Exception) and is_oom(exc)):
        return False
    try:
        dump_forensics("resource_exhausted", step=step,
                       error=f"{type(exc).__name__}: {exc}")
    except Exception:
        pass
    return True


@contextlib.contextmanager
def oom_guard(step_fn: Optional[Callable[[], Optional[int]]] = None):
    """Re-raises everything, but an allocation failure first triggers a
    forensics dump — the black-box recording written while the evidence
    is still live."""
    try:
        yield
    except BaseException as e:  # noqa: B902 — inspect, always re-raise
        try:
            step = step_fn() if step_fn is not None else None
        except Exception:
            step = None
        maybe_dump_oom(e, step=step)
        raise


def _dump_path() -> str:
    d = str(env.get("MXTPU_MEM_DUMP_DIR") or "") or "."
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        d = "."
    return os.path.join(
        d, f"mem_forensics_{os.getpid()}_{next(_dump_seq)}.json")


def _allocator_stats() -> Dict[str, int]:
    """The caching allocator's counters for the current card ({} without
    one)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    return {"allocated_bytes": int(torch.cuda.memory_allocated()),
            "max_allocated_bytes": int(torch.cuda.max_memory_allocated()),
            "reserved_bytes": int(torch.cuda.memory_reserved())}


def dump_forensics(reason: str, budget: Optional[int] = None,
                   step: Optional[int] = None, path: Optional[str] = None,
                   error: Optional[str] = None) -> str:
    """Write the ranked memory diagnosis to a JSON file and return its
    path: ledger categories and top live buffers (with owners), the
    allocator's statistics and the recent trace window."""
    total = _LEDGER.live_bytes()
    by_cat = _LEDGER.snapshot()
    cats = [{"category": c, "bytes": n,
             "share": round(n / total, 4) if total else 0.0}
            for c, n in sorted(by_cat.items(), key=lambda kv: -kv[1])]
    backend = {}
    try:
        backend = _allocator_stats()
    except Exception:
        pass
    trace_window: List[dict] = []
    try:
        from .tracer import tracer as _tr
        trace_window = _tr.events()[-200:]
    except Exception:
        pass
    payload = {
        "reason": reason,
        "error": error,
        "time_unix": time.time(),
        "pid": os.getpid(),
        "step": step,
        "budget_bytes": budget if budget is not None else
        (budget_bytes() or None),
        "live_bytes": total,
        "peak_bytes": _LEDGER.peak_bytes,
        "categories": cats,
        "top_buffers": _LEDGER.top(20),
        "programs": program_report(limit=20),
        "backend_memory_stats": backend,
        "trace_window": trace_window,
    }
    if path is None:
        path = _dump_path()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        # default=str: span args are producer-defined objects
        json.dump(payload, f, indent=1, default=str)
    os.replace(tmp, path)
    try:
        from ..log import get_logger
        get_logger("mxnet_tpu_torch.telemetry").warning(
            "memory forensics (%s): live %d bytes, peak %d — dumped to %s",
            reason, total, _LEDGER.peak_bytes, path)
    except Exception:
        pass
    return path


def check_pressure(step: Optional[int] = None, plan=None) -> Optional[str]:
    """Per-step watermark check (called by ``fit.FitLoop`` at each step
    end): fires a forensics dump when the deterministic ``mem_pressure``
    chaos event is scheduled at this step, or — on the rising edge only —
    when the step's ledger watermark exceeds ``MXTPU_MEM_BUDGET``.
    Returns the dump path, or None."""
    peak, _ = _LEDGER.window_stats()
    peak = max(peak, _LEDGER.live_bytes())
    dumped = None
    if plan is not None:
        b = None
        try:
            b = plan.mem_pressure_bytes()
        except AttributeError:
            pass
        if b is not None and peak > b:
            dumped = dump_forensics("chaos_mem_pressure", budget=b,
                                    step=step)
    budget = budget_bytes()
    if budget > 0:
        if peak > budget and not _budget_exceeded[0]:
            _budget_exceeded[0] = True
            dumped = dump_forensics("budget_exceeded", budget=budget,
                                    step=step)
        elif peak <= budget:
            _budget_exceeded[0] = False
    return dumped


def reconcile(device=None) -> Dict[str, Any]:
    """Cross-check the ledger against the card's caching allocator: the
    ledger is a lower bound of ``torch.cuda.memory_allocated()``
    (activations and workspaces are not framework objects). Returns
    {"ledger_bytes", "backend_bytes_in_use", "backend_peak",
    "consistent"}; the backend fields are None on the host."""
    led = _LEDGER.live_bytes()
    dev = None if device is None else torch.device(
        getattr(device, "torch_device", device))
    if (dev is not None and dev.type != "cuda") or \
            not torch.cuda.is_available():
        return {"ledger_bytes": led, "backend_bytes_in_use": None,
                "backend_peak": None, "consistent": None}
    in_use = int(torch.cuda.memory_allocated(dev))
    peak = int(torch.cuda.max_memory_allocated(dev))
    return {"ledger_bytes": led, "backend_bytes_in_use": in_use,
            "backend_peak": peak,
            "consistent": led <= in_use * 1.02 + (1 << 20)}
