"""Efficiency and goodput: per-program FLOP / byte costs, live MFU (ref:
the JAX package's ``telemetry/efficiency.py``).

The JAX package reads XLA's ``cost_analysis()`` / ``memory_analysis()``
of its compiled programs. The port has no executables, so a program's
cost is counted by observing ONE real execution per signature under a
counting dispatch mode (:class:`CostCounter`, a ``TorchDispatchMode``):

- ``flops``: ``torch.utils.flop_counter``'s formulas, the ones
  ``FlopCounterMode`` applies (matmuls, convolutions, attention and their
  backward). Every other op counts 0 FLOPs (model FLOPs, the MFU
  convention);
- ``bytes_accessed``: the sum over the aten ops of their tensor inputs'
  and outputs' bytes (views and ``empty`` count nothing). It is an
  unfused upper bound of the traffic: an intermediate a fused program
  would keep on chip is counted as written and read again;
- ``argument_bytes`` / ``output_bytes``: the bytes of the tensors the
  caller names as the program's arguments and outputs;
- ``temp_bytes``: on the card, the allocator's peak during the counted
  run (sampled after every op) above the larger of its start and end;
  on the CPU the counter's own tally of live op outputs, the same way;
- ``alias_bytes``: bytes of tensors written in place;
- ``generated_code_bytes``: 0. The hand-written kernels are loaded once
  per process, not per program, and a CUDA graph holds no code;
- ``held_bytes`` (the port's own): what the run left allocated above its
  start, e.g. the activations a forward saved for its backward.

The hand-written kernels launch through ``ctypes`` on raw pointers, which
no dispatch mode sees: each wrapper reports its own cost with
:func:`report_kernel` when it launches (one flag check with no counter
open). A kernel's bytes are its formula's (``ops/kernel_cost.py``, the
formulas behind the kernel table's bounds), its FLOPs those of the same
convention as everything else (0 for the BatchNorm kernels, which do
elementwise work; the attention product's for flash). On the CPU the
wrappers run their plain versions, whose ops the mode counts itself.
The counter is part of the thread's dispatch state, which PyTorch hands
to autograd's device threads, so a backward run inside a counted scope
is counted too. A CUDA graph's replay runs no op the mode can see, so
graphs are counted on the eager run before their capture
(``megastep.py``, ``parallel/spmd.py``, ``cached_op.py``) and the cost is
cached per signature; a warm step runs no counting mode.

:func:`program_stats` (exported as :func:`compiled_program_stats`, the
JAX package's name) turns a counted run into the JAX package's field
layout (:data:`COST_FIELDS` + :data:`MEMORY_FIELDS`); :func:`observe`
counts a program the first time it runs and records it in the memory
ledger's program registry (``memory.record_program``).

**Live MFU / goodput rollup** (``MXTPU_EFFICIENCY=on``), as in the JAX
package: dispatch sites drop a :func:`note_dispatch` per launch — the
megastep graph's replay (kind ``megastep``), ``SPMDTrainer.run_steps``'s
K-step graph (``spmd``), each grouped optimizer bucket and the
finiteness reduction (``optimizer``), and a hybridized block's
``CachedOp`` programs, its forward and its backward per signature
(``cached_op``). ``fit.FitLoop`` brackets
each step with :func:`begin_step` / :func:`end_step`; the step's FLOP and
byte sums divide by the wall and the device peak table
(:func:`device_peak`, ``MXTPU_DEVICE_PEAK=flops=F,bw=B``) into MFU,
achieved FLOP/s and bytes/s, the roofline verdict and samples/s goodput.
Surfaces: ``FitResult.efficiency``, the ``mxtpu_mfu`` /
``mxtpu_goodput_samples`` gauges, Perfetto ``"C"`` counters (category
``efficiency``). An un-hybridized net's ops are not attributed (the JAX
package's coverage contract): MFU is then a lower bound. The plane is
numerically inert: a counted run is a real run of the same ops.

**Peaks**: ``MXTPU_DEVICE_PEAK`` wins (strict parse, ``estimate``
False); otherwise the per-backend placeholders below apply and every
result is marked ``estimate``.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

from ..base import MXNetError, env

__all__ = ["CostCounter", "counting", "program_stats",
           "compiled_program_stats", "report_kernel", "observe",
           "pend_backward", "block_signature", "run_backward",
           "program_scope", "in_program", "notes_on", "COST_FIELDS",
           "MEMORY_FIELDS", "spec", "enabled", "device_peak", "note_dispatch",
           "begin_step", "end_step", "reset_run", "summary", "rollup",
           "cost_report", "EfficiencyRollup"]

#: the cost fields of :func:`program_stats`
COST_FIELDS = ("flops", "bytes_accessed")
#: its memory fields (the JAX package's ``memory_analysis`` layout)
MEMORY_FIELDS = ("argument_bytes", "output_bytes", "temp_bytes",
                 "alias_bytes", "generated_code_bytes")

#: per-step efficiency records retained (the FitResult window)
RECENT = 64


# ---------------------------------------------------------------------------
# Counting: one observed execution per program
# ---------------------------------------------------------------------------

#: counters open anywhere in the process (the wrappers' one flag check)
OPEN = [0]
_tls = threading.local()
#: ops that move no data: allocation without a write
_NO_TRAFFIC = frozenset(("empty", "empty_strided", "empty_like",
                         "new_empty", "new_empty_strided", "detach",
                         "lift_fresh", "_local_scalar_dense"))


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def _tensors(tree) -> List[torch.Tensor]:
    leaves, _ = tree_flatten(tree)
    seen, out = set(), []
    for x in leaves:
        if isinstance(x, torch.Tensor) and id(x) not in seen:
            seen.add(id(x))
            out.append(x)
    return out


class CostCounter(TorchDispatchMode):
    """A counting scope: every aten op run inside it adds its FLOPs (the
    ``flop_counter`` formulas) and its input and output bytes; a
    hand-written kernel launched inside it adds what its wrapper reports
    (:func:`report_kernel`). ``device`` is where the counted program runs
    (the allocator's peak is read there on a card)."""

    def __init__(self, device=None):
        super().__init__()
        dev = torch.device(device) if device is not None else None
        self._cuda = dev is not None and dev.type == "cuda"
        self._dev = dev
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.alias_bytes = 0
        self.ops = 0
        self.kernels = 0
        self.by_kernel: Dict[str, List[float]] = {}
        self._live = 0
        self._peak = 0
        self._start = 0
        self._end = None

    # -- the scope --------------------------------------------------------
    def __enter__(self):
        if self._cuda:
            self._start = int(torch.cuda.memory_allocated(self._dev))
            self._peak = self._start
        OPEN[0] += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            OPEN[0] -= 1
            self._end = int(torch.cuda.memory_allocated(self._dev)) \
                if self._cuda else self._live

    # -- per op -----------------------------------------------------------
    def _release(self, n: int) -> None:
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        formula = _flop_registry().get(packet)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        name = packet.__name__
        if name in _NO_TRAFFIC:
            return out
        schema = func._schema
        written = []
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = kwargs.get(a.name, args[i] if i < len(args) else None)
                written += _tensors(v)
        if not written and any(r.alias_info is not None
                               for r in schema.returns):
            return out                  # a view: no data moves
        ins = _tensors((args, kwargs))
        fresh = [t for t in _tensors(out)
                 if not any(t is w for w in written)] \
            if not any(r.alias_info is not None for r in schema.returns) \
            else []
        nw = sum(_nbytes(t) for t in written)
        self.bytes_accessed += sum(_nbytes(t) for t in ins) + nw + \
            sum(_nbytes(t) for t in fresh)
        self.alias_bytes += nw
        if self._cuda:
            self._peak = max(self._peak, int(
                torch.cuda.memory_allocated(self._dev)))
        else:
            for t in fresh:
                n = _nbytes(t)
                self._live += n
                try:
                    weakref.finalize(t, self._release, n)
                except TypeError:
                    self._live -= n
            self._peak = max(self._peak, self._live)
        return out

    def add_kernel(self, flops: float, nbytes: float,
                   name: str = "kernel") -> None:
        self.flops += float(flops)
        self.bytes_accessed += float(nbytes)
        self.kernels += 1
        row = self.by_kernel.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += float(flops)
        row[2] += float(nbytes)

    # -- the result -------------------------------------------------------
    def stats(self, arguments=(), outputs=()) -> Dict[str, Any]:
        """The counted run in :data:`COST_FIELDS` + :data:`MEMORY_FIELDS`
        (FLOPs and bytes as floats, memory fields as ints), and under
        ``kernels`` what each hand-written kernel reported (launches,
        flops, bytes) when one ran; ``held_bytes`` is what the run left
        allocated (its outputs and, for a forward under autograd, the
        activations saved for the backward)."""
        end = self._end if self._end is not None else (
            int(torch.cuda.memory_allocated(self._dev)) if self._cuda
            else self._live)
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "argument_bytes": sum(_nbytes(t)
                                      for t in _tensors(arguments)),
                "output_bytes": sum(_nbytes(t) for t in _tensors(outputs)),
                "temp_bytes": max(0, self._peak - max(self._start, end)),
                "alias_bytes": int(self.alias_bytes),
                "generated_code_bytes": 0,
                "held_bytes": max(0, end - self._start),
                **({"kernels": {k: {"launches": v[0], "flops": v[1],
                                    "bytes": v[2]}
                                for k, v in self.by_kernel.items()}}
                   if self.by_kernel else {})}


@contextlib.contextmanager
def counting(device=None):
    """Count what runs inside: ``with counting(dev) as c: ...`` then
    :func:`program_stats`. Scopes nest; every open scope counts."""
    c = CostCounter(device)
    with c:
        yield c


def program_stats(counter: Optional[CostCounter], arguments=(),
                  outputs=()) -> Optional[Dict[str, Any]]:
    """The port's ``compiled_program_stats``: one counted execution as
    the JAX package's plain dict (:data:`COST_FIELDS` as floats,
    :data:`MEMORY_FIELDS` as ints); None without a counter."""
    if counter is None:
        return None
    return counter.stats(arguments, outputs)


compiled_program_stats = program_stats


def report_kernel(flops: float, nbytes: float,
                  name: str = "kernel") -> None:
    """A hand-written kernel's cost, added to every counting scope open on
    this thread (autograd's device threads included). With no scope open
    anywhere this is one flag check (callers test :data:`OPEN` first to
    skip computing the cost too)."""
    if not OPEN[0]:
        return
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, CostCounter):
            mode.add_kernel(flops, nbytes, name)


@contextlib.contextmanager
def program_scope():
    """The code inside is part of one program that is counted and noted
    as a whole (a hybridized block's call, the megastep's body, the
    K-step graph's eager steps): nothing inside is noted, and no program
    inside is recorded as one of its own."""
    _tls.prog = getattr(_tls, "prog", 0) + 1
    try:
        yield
    finally:
        _tls.prog -= 1


def in_program() -> bool:
    """Whether a :func:`program_scope` is open on this thread."""
    return bool(getattr(_tls, "prog", 0))


def notes_on() -> bool:
    """Whether a dispatch site should count and note: the plane is on
    and no :func:`program_scope` is open on this thread."""
    return spec() and not in_program()


def block_signature(block) -> Tuple:
    """What sets a block's program apart from another's at equal inputs:
    each module's path, type and settings (``extra_repr``, the Gluon
    prefix left out), and each parameter's and buffer's path, shape and
    dtype. Two instances of one architecture have the same signature."""
    mods = []
    for path, m in block.named_modules():
        extra = m.extra_repr()
        if extra == f"prefix={getattr(m, '_prefix', None)!r}":
            extra = ""
        mods.append((path, type(m).__name__, extra))
    tensors = [(path, tuple(t.shape), t.dtype)
               for path, t in (*block.named_parameters(),
                               *block.named_buffers())]
    return tuple(mods), tuple(tensors)


def pend_backward(label: str) -> None:
    """A CachedOp program ``label`` ran its forward with gradients on: its
    backward (``label + ":bwd"``) is the next :func:`run_backward`'s."""
    pend = getattr(_tls, "pending", None)
    if pend is None:
        pend = _tls.pending = []
    if label not in pend:
        pend.append(label)


def run_backward(run: Callable[[], Any], device=None):
    """``run()`` (a reverse pass) as the backward program of the
    hybridized blocks whose forward ran since the last one
    (:func:`pend_backward`): noted every time; counted the first time
    when it is one block's and the CachedOp has not recorded it (on the
    CPU, where the block runs eagerly: the ops from the heads down, so a
    loss after the block is part of it)."""
    pend = getattr(_tls, "pending", None)
    if not pend:
        return run()
    _tls.pending = []
    if not notes_on():
        return run()
    labels = [lbl + ":bwd" for lbl in pend]
    if len(labels) == 1:
        return observe("cached_op", labels[0], run, device=device)
    from . import memory as _memory
    res = run()
    for lbl in labels:
        note_dispatch(("cached_op", lbl), "cached_op", lbl,
                      lambda lbl=lbl: _memory.get_program("cached_op", lbl))
    return res


def observe(kind: str, label: Union[str, Callable[[Any], str]],
            run: Callable[[], Any], device=None,
            arguments=(), outputs: Optional[Callable[[Any], Any]] = None):
    """Run ``run()`` as a dispatch of the program ``(kind, label)``: the
    first time, counted and recorded in the program registry; every time,
    noted in the step window. ``arguments`` may be a callable (evaluated
    only when counting). ``label`` may be a callable of ``run()``'s
    result, for a program keyed on what its run resolves (a block's
    deferred shapes): that run is counted. Returns ``run()``'s result.
    Call it only when :func:`notes_on`."""
    from . import memory as _memory
    lazy = callable(label)
    if lazy or _memory.get_program(kind, label) is None:
        with counting(device) as c:
            res = run()
        if lazy:
            label = label(res)
        if _memory.get_program(kind, label) is None:
            _memory.record_program(kind, label, c.stats(
                arguments() if callable(arguments) else arguments,
                outputs(res) if outputs is not None else ()))
    else:
        res = run()
    note_dispatch((kind, label), kind, label,
                  lambda: _memory.get_program(kind, label))
    return res


# ---------------------------------------------------------------------------
# MXTPU_EFFICIENCY grammar (strict, cached against the raw string)
# ---------------------------------------------------------------------------

def _parse(raw: Optional[str]) -> bool:
    s = (raw or "").strip()
    if not s:
        return False
    on = False
    for tok in s.split(","):
        tok = tok.strip()
        if not tok:
            continue
        low = tok.lower()
        if low in ("on", "1", "true", "all"):
            on = True
        elif low in ("off", "0", "false"):
            on = False
        else:
            raise MXNetError(
                f"MXTPU_EFFICIENCY: unknown token {tok!r} "
                "(known: on, off)")
    return on


_spec_lock = threading.Lock()
_spec_cached: Optional[Tuple[Optional[str], bool]] = None


def spec() -> bool:
    """True when the plane is armed. Cached against the raw env string —
    the off path is one environ lookup + a compare (the tracer
    discipline); a typo'd value raises on every call."""
    global _spec_cached
    raw = env.raw("MXTPU_EFFICIENCY")
    c = _spec_cached
    if c is not None and c[0] == raw:
        return c[1]
    parsed = _parse(raw)
    with _spec_lock:
        _spec_cached = (raw, parsed)
    return parsed


def enabled() -> bool:
    return spec()


# ---------------------------------------------------------------------------
# Device peak table (MXTPU_DEVICE_PEAK=flops=F,bw=B)
# ---------------------------------------------------------------------------

#: rough per-backend peaks used when the operator declares none:
#: placeholders, always marked estimate (measure the card and set
#: MXTPU_DEVICE_PEAK to grade against it)
_DEFAULT_PEAKS = {
    "gpu": (50.0e12, 1000.0e9),
    "cpu": (1.0e11, 5.0e10),
}


def _parse_peak(raw: Optional[str]) -> Optional[Tuple[float, float]]:
    s = (raw or "").strip()
    if not s:
        return None
    vals: Dict[str, float] = {}
    for tok in s.split(","):
        tok = tok.strip()
        if not tok:
            continue
        key, sep, val = tok.partition("=")
        key = key.strip().lower()
        if not sep or key not in ("flops", "bw"):
            raise MXNetError(
                f"MXTPU_DEVICE_PEAK: unknown token {tok!r} (grammar: "
                "flops=<FLOP/s>,bw=<bytes/s>, e.g. flops=73e12,bw=9e11)")
        try:
            vals[key] = float(val)
        except ValueError:
            raise MXNetError(
                f"MXTPU_DEVICE_PEAK: {key}={val.strip()!r} is not a "
                "number")
        if vals[key] <= 0:
            raise MXNetError(
                f"MXTPU_DEVICE_PEAK: {key} must be > 0, got {vals[key]}")
    missing = [k for k in ("flops", "bw") if k not in vals]
    if missing:
        raise MXNetError(
            f"MXTPU_DEVICE_PEAK: missing {missing} — both flops= and "
            "bw= are required (MFU against half a peak table grades "
            "against garbage)")
    return vals["flops"], vals["bw"]


_peak_lock = threading.Lock()
_peak_cached: Optional[Tuple[Optional[str],
                             Optional[Tuple[float, float]]]] = None


def device_peak() -> Dict[str, Any]:
    """The active peak table: ``{"flops", "bw", "source", "estimate"}``.
    ``MXTPU_DEVICE_PEAK`` wins (strict parse, ``estimate`` False);
    otherwise the backend default applies and results are marked
    ``estimate`` — a defaulted peak grades the trend, not the truth."""
    global _peak_cached
    raw = env.raw("MXTPU_DEVICE_PEAK")
    c = _peak_cached
    if c is not None and c[0] == raw:
        parsed = c[1]
    else:
        parsed = _parse_peak(raw)
        with _peak_lock:
            _peak_cached = (raw, parsed)
    if parsed is not None:
        return {"flops": parsed[0], "bw": parsed[1], "source": "env",
                "estimate": False}
    backend = "gpu" if torch.cuda.is_available() else "cpu"
    flops, bw = _DEFAULT_PEAKS.get(backend, _DEFAULT_PEAKS["cpu"])
    return {"flops": flops, "bw": bw, "source": f"default:{backend}",
            "estimate": True}


# ---------------------------------------------------------------------------
# The rollup
# ---------------------------------------------------------------------------

def _gauges():
    from .registry import default_registry
    reg = default_registry()
    return (
        reg.gauge("mxtpu_mfu",
                  "Model FLOP utilization of the last efficiency-plane "
                  "step: attributed program FLOPs / wall / device peak "
                  "(MXTPU_EFFICIENCY, MXTPU_DEVICE_PEAK)."),
        reg.gauge("mxtpu_goodput_samples",
                  "Useful samples/s of the last efficiency-plane step "
                  "(non-finite skipped steps produce no useful "
                  "samples)."),
    )


def _install_program_gauges() -> None:
    try:
        from . import memory as _memory
        from .registry import default_registry
        reg = default_registry()
        reg.callback_gauge(
            "mxtpu_program_flops",
            lambda: _memory.program_total("flops"),
            "Counted FLOPs over recorded programs (one execution each; "
            "the efficiency plane's cost registry).")
        reg.callback_gauge(
            "mxtpu_program_bytes_accessed",
            lambda: _memory.program_total("bytes_accessed"),
            "Counted bytes accessed over recorded programs (one "
            "execution each).")
    except Exception:
        pass


class EfficiencyRollup:
    """Per-process rollup state: the current step's dispatch notes, the
    resolved per-program cost table, run totals and the bounded recent
    window. ``reset_run`` re-arms it per fit (the
    ``reset_pressure_state`` discipline)."""

    def __init__(self):
        self._lock = threading.Lock()
        # current step: token -> [count, kind, label, resolver]
        self._notes: Dict[Any, list] = {}
        self._step_t0: Optional[float] = None
        # run-lifetime per-program table: token -> dict
        self.programs: Dict[Any, Dict[str, Any]] = {}
        self.recent: deque = deque(maxlen=RECENT)
        self.steps = 0
        self.flops_total = 0.0
        self.bytes_total = 0.0
        self.wall_total = 0.0
        self.samples_total = 0
        self.useful_samples_total = 0
        self.skipped_steps = 0
        self.unresolved_dispatches = 0

    # -- run lifecycle --------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._notes = {}
            self._step_t0 = None
            self.programs = {}
            self.recent.clear()
            self.steps = 0
            self.flops_total = 0.0
            self.bytes_total = 0.0
            self.wall_total = 0.0
            self.samples_total = 0
            self.useful_samples_total = 0
            self.skipped_steps = 0
            self.unresolved_dispatches = 0

    # -- per-step -------------------------------------------------------
    def note(self, token, kind: str, label: str,
             resolver: Callable[[], Optional[dict]]) -> None:
        with self._lock:
            if self._step_t0 is None:
                # no open step window (bare Trainer loop / serving
                # process with the plane armed): DROP the note — each
                # resolver closure pins a compiled-program cache entry,
                # so accumulating them with nothing ever closing the
                # window would defeat the LRU bound and grow without end
                return
            ent = self._notes.get(token)
            if ent is None:
                self._notes[token] = [1, kind, label, resolver]
            else:
                ent[0] += 1

    def begin_step(self) -> None:
        with self._lock:
            self._notes = {}
            self._step_t0 = time.perf_counter()

    def end_step(self, step: Optional[int] = None, samples: int = 0,
                 useful: bool = True,
                 tokens_per_sample: Optional[float] = None,
                 wall_s: Optional[float] = None) -> Optional[dict]:
        """Close the step window: resolve every noted program's cost
        (counted once per signature, when it first ran), divide by the
        wall and the peak table, publish the gauges/counters, and append
        the step record."""
        with self._lock:
            if self._step_t0 is None:
                return None
            notes = self._notes
            self._notes = {}
            t0 = self._step_t0
            self._step_t0 = None
        if wall_s is None:
            wall_s = time.perf_counter() - t0
        # resolution OUTSIDE the rollup lock: a resolver reads the
        # program registry under its own lock
        flops = byts = 0.0
        dispatches = unresolved = 0
        resolved_rows = []
        for token, (count, kind, label, resolver) in notes.items():
            dispatches += count
            stats = None
            try:
                stats = resolver()
            except Exception:
                stats = None
            if not stats or "flops" not in stats:
                unresolved += count
                continue
            f = float(stats.get("flops", 0.0))
            b = float(stats.get("bytes_accessed", 0.0))
            flops += count * f
            byts += count * b
            resolved_rows.append((token, kind, label, count, f, b))
        peak = device_peak()
        mfu = (flops / wall_s / peak["flops"]) if wall_s > 0 else 0.0
        bw_util = (byts / wall_s / peak["bw"]) if wall_s > 0 else 0.0
        sps = (samples / wall_s) if (wall_s > 0 and useful) else 0.0
        rec = {
            "step": step,
            "wall_s": wall_s,
            "flops": flops,
            "bytes_accessed": byts,
            "mfu": mfu,
            "bw_util": bw_util,
            "achieved_flops_per_s": flops / wall_s if wall_s > 0 else 0.0,
            "achieved_bytes_per_s": byts / wall_s if wall_s > 0 else 0.0,
            "samples_per_s": sps,
            "useful": bool(useful),
            "dispatches": dispatches,
            "unattributed_dispatches": unresolved,
        }
        if tokens_per_sample is not None:
            rec["tokens_per_s"] = sps * float(tokens_per_sample)
        with self._lock:
            for _token, kind, label, count, f, b in resolved_rows:
                # run-lifetime table keyed by (identity, cost), NOT the
                # per-step note token: a token built on id(entry) could
                # alias a later entry after the first is evicted and
                # collected — two indistinguishable (label, cost) rows
                # merging is fine, two different programs merging is not
                pkey = (kind, label, f, b)
                prog = self.programs.get(pkey)
                if prog is None:
                    prog = self.programs[pkey] = {
                        "kind": kind, "label": label, "flops": f,
                        "bytes_accessed": b, "dispatches": 0}
                prog["dispatches"] += count
            self.recent.append(rec)
            self.steps += 1
            self.flops_total += flops
            self.bytes_total += byts
            self.wall_total += wall_s
            self.samples_total += samples
            if useful:
                self.useful_samples_total += samples
            else:
                self.skipped_steps += 1
            self.unresolved_dispatches += unresolved
        try:
            g_mfu, g_sps = _gauges()
            g_mfu.set(mfu)
            g_sps.set(sps)
        except Exception:
            pass
        try:
            from .tracer import tracer as _tr
            if _tr.enabled:
                _tr.counter_event("mfu", mfu, category="efficiency")
                _tr.counter_event("samples_per_s", sps,
                                  category="efficiency")
        except Exception:
            pass
        return rec

    # -- aggregate ------------------------------------------------------
    def summary(self, tokens_per_sample: Optional[float] = None
                ) -> Optional[dict]:
        peak = device_peak()
        with self._lock:
            if not self.steps:
                return None
            wall = self.wall_total
            sps = (self.useful_samples_total / wall) if wall > 0 else 0.0
            mfu = (self.flops_total / wall / peak["flops"]) \
                if wall > 0 else 0.0
            bw_util = (self.bytes_total / wall / peak["bw"]) \
                if wall > 0 else 0.0
            progs = sorted(
                (dict(p) for p in self.programs.values()),
                key=lambda p: -(p["flops"] * p["dispatches"]))
            out = {
                "enabled": True,
                "steps": self.steps,
                "wall_s": round(wall, 6),
                "flops_total": self.flops_total,
                "bytes_total": self.bytes_total,
                "flops_per_step": self.flops_total / self.steps,
                "bytes_per_step": self.bytes_total / self.steps,
                "achieved_flops_per_s": self.flops_total / wall
                if wall > 0 else 0.0,
                "achieved_bytes_per_s": self.bytes_total / wall
                if wall > 0 else 0.0,
                "mfu": mfu,
                "bw_util": bw_util,
                # which ceiling the run is pressed against: whichever
                # utilization is higher; with nothing attributed (an
                # un-hybridized net) there is no verdict
                "roofline": ("compute_bound" if mfu >= bw_util
                             else "bandwidth_bound")
                if (self.flops_total > 0 or self.bytes_total > 0)
                else "unattributed",
                "samples_per_s": sps,
                "samples_total": self.samples_total,
                "useful_samples_total": self.useful_samples_total,
                "skipped_steps": self.skipped_steps,
                "unattributed_dispatches": self.unresolved_dispatches,
                "peak": dict(peak),
                "estimate": bool(peak["estimate"]),
                "per_program": progs[:20],
                "recent": [dict(r) for r in self.recent],
            }
        if tokens_per_sample is not None:
            out["tokens_per_s"] = sps * float(tokens_per_sample)
            out["tokens_per_sample"] = float(tokens_per_sample)
        return out


_ROLLUP = EfficiencyRollup()
_gauges_installed = [False]


def rollup() -> EfficiencyRollup:
    return _ROLLUP


def reset_run() -> None:
    """Re-arm the rollup for a fresh run (``fit.FitLoop`` calls this at
    fit start). Also the strict-parse checkpoint: a typo'd
    ``MXTPU_EFFICIENCY`` or ``MXTPU_DEVICE_PEAK`` raises HERE, before
    any step runs."""
    on = spec()
    if on:
        device_peak()  # strict-parse the peak table before step 0
        if not _gauges_installed[0]:
            _gauges_installed[0] = True
            _install_program_gauges()
    _ROLLUP.reset()


def note_dispatch(token, kind: str, label: str,
                  resolver: Callable[[], Optional[dict]]) -> None:
    """Record one launch of an attributable program into the current
    step window. ``token`` dedupes repeat launches of the same program
    within a step; ``resolver`` returns the program's cost dict (the
    record :func:`observe` made when it first ran). Callers gate on
    :func:`enabled` so the off path never builds the closure. Inside
    :func:`program_scope` (a program whose launch another note covers,
    such as the megastep's body) nothing is recorded."""
    if not spec() or in_program():
        return
    _ROLLUP.note(token, kind, label, resolver)


def begin_step() -> None:
    if not spec():
        return
    _tls.pending = []
    _ROLLUP.begin_step()


def end_step(step: Optional[int] = None, samples: int = 0,
             useful: bool = True,
             tokens_per_sample: Optional[float] = None,
             wall_s: Optional[float] = None) -> Optional[dict]:
    if not spec():
        return None
    return _ROLLUP.end_step(step=step, samples=samples, useful=useful,
                            tokens_per_sample=tokens_per_sample,
                            wall_s=wall_s)


def summary(tokens_per_sample: Optional[float] = None) -> Optional[dict]:
    """The ``FitResult.efficiency`` payload; None when the plane is off
    or no step closed."""
    if not spec():
        return None
    return _ROLLUP.summary(tokens_per_sample=tokens_per_sample)


def cost_report(limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Recorded programs ranked by counted FLOPs (the compute-side twin
    of ``memory.program_report``)."""
    from . import memory as _memory
    rows = [r for r in _memory.program_report(None)
            if float(r.get("flops", 0.0) or 0.0) > 0]
    rows.sort(key=lambda r: -float(r.get("flops", 0.0)))
    return rows[:limit] if limit else rows
