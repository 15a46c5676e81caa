"""Numerics observability: tensor stats, non-finite provenance,
loss-scale timeline (ref: the JAX package's ``telemetry/numerics.py``).

The finiteness sentinel (``Trainer.update_with_sentinel``) can skip a bad
step but cannot name which parameter went non-finite; the legacy
``Monitor`` is a host callback. Three layers:

**Tensor stats in the update** (``MXTPU_NUMERICS=on[,every=N]
[,stats=...][,pattern=RE]``): on a sampled step each grouped-update
bucket (``optimizer/grouped.py apply_chunk``) also computes one
``(n_params, 6)`` f32 matrix (:data:`RAW_FIELDS`: grad and weight sums of
squares, the update's sum of squares, grad abs-max, grad mean and the
count of non-finite grad elements) from the same tensors its
``torch._foreach_*`` update consumes, before the update is written. The
matrices stay on the device and ride the step's one flag+loss transfer
(``fit.FitLoop`` fetches them together), so a sampled step adds no host
sync; an unsampled step computes nothing, and with the plane off the
hook is one cached flag check. Under ``MXTPU_MEGASTEP=on`` a sampled
step replays a second captured graph whose extra outputs are these
matrices (``megastep.py``). The per-parameter update path uses
:func:`fallback_collect` (no update ratio there: the update has not been
computed).

**Non-finite provenance**: when the sentinel skips a step with the plane
armed, :func:`nonfinite_step` counts non-finite elements per bucket of
:data:`PROV_BUCKET` parameters, then per parameter inside the guilty
buckets, names the first offending parameter in an ERROR log and writes
``numerics_<pid>_<n>.json`` (tmp+rename) to ``MXTPU_MEM_DUMP_DIR`` with
the offenders, their recent stats, the loss-scale timeline and the last
trace window. The extra syncs land only on the already-lost step.

**Loss-scale timeline**: ``fit.FitLoop`` records every backoff and
regrowth through :func:`note_loss_scale`, with the plane off too
(``FitResult.numerics["loss_scale_events"]``, the ``mxtpu_loss_scale``
gauge).

Surfaces: ``FitResult.numerics``, the ``mxtpu_numerics_*`` gauges,
Perfetto ``"C"`` counters (``grad_norm`` / ``update_ratio`` /
``loss_scale``, category ``numerics``) and ``monitor.Monitor``
(``Monitor.install_numerics``). The plane is numerically inert: the
stats are extra reads of the update's inputs and outputs, so weights,
states and losses are bit for bit those of a run with the plane off.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import re
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..base import MXNetError, env

__all__ = ["NumericsSpec", "NumericsPlane", "plane", "spec", "enabled",
           "mark_step", "collect_spec", "fallback_collect", "record_step",
           "note_loss_scale", "nonfinite_step", "summary", "reset_run",
           "attach_monitor", "RAW_FIELDS", "STATS"]

#: columns of the raw per-parameter stat matrix the bucket programs emit,
#: in order — grouped.py builds rows in exactly this layout
RAW_FIELDS = ("grad_sumsq", "weight_sumsq", "update_sumsq",
              "absmax", "mean", "nonfinite")

#: publishable derived stats (the ``stats=`` grammar tokens)
STATS = ("l2", "absmax", "mean", "nonfinite", "update_ratio")

#: recent sampled-step records retained (the FitResult window)
RECENT = 64
#: per-parameter stat history depth (what a provenance dump replays)
HIST = 16
#: provenance bisect bucket width (params per stage-1 bucket)
PROV_BUCKET = 16

_dump_seq = itertools.count(1)


class NumericsSpec:
    """Parsed ``MXTPU_NUMERICS`` grammar: cadence, stat subset, name
    filter. Immutable; identity-compared by the env cache."""
    __slots__ = ("every", "stats", "pattern", "raw")

    def __init__(self, every: int, stats: Tuple[str, ...],
                 pattern: Optional["re.Pattern"], raw: str):
        self.every = every
        self.stats = stats
        self.pattern = pattern
        self.raw = raw

    def sampled(self, step: int) -> bool:
        return step % self.every == 0

    def wants(self, name: str) -> bool:
        return self.pattern is None or \
            self.pattern.match(str(name)) is not None


def _parse(raw: Optional[str]) -> Optional[NumericsSpec]:
    """Strict ``MXTPU_NUMERICS`` parse — a typo'd request to measure must
    not silently measure nothing (the MXTPU_PROFILE discipline). A spec
    made only of modifiers (``every=``, ``stats=``, ``pattern=``) implies
    ``on``. The pattern must not contain commas (they delimit tokens)."""
    s = (raw or "").strip()
    if not s:
        return None
    want_on = None
    saw_modifier = False
    every, stats, pattern = 1, tuple(STATS), None
    for tok in s.split(","):
        tok = tok.strip()
        if not tok:
            continue
        low = tok.lower()
        if low in ("on", "1", "true", "all"):
            want_on = True
        elif low in ("off", "0", "false"):
            want_on = False
        elif "=" in tok:
            saw_modifier = True
            key, _, val = tok.partition("=")
            key, val = key.strip().lower(), val.strip()
            if key == "every":
                try:
                    every = int(val)
                except ValueError:
                    raise MXNetError(
                        f"MXTPU_NUMERICS: every={val!r} is not an int")
                if every < 1:
                    raise MXNetError(
                        f"MXTPU_NUMERICS: every must be >= 1, got {every}")
            elif key == "stats":
                names = tuple(t.strip() for t in val.split("|") if t.strip())
                if not names:
                    raise MXNetError(
                        "MXTPU_NUMERICS: stats= needs at least one stat, "
                        "e.g. stats=l2|update_ratio")
                bad = [n for n in names if n not in STATS]
                if bad:
                    raise MXNetError(
                        f"MXTPU_NUMERICS: unknown stat(s) {bad} "
                        f"(known: {', '.join(STATS)})")
                stats = names
            elif key == "pattern":
                if not val:
                    raise MXNetError(
                        "MXTPU_NUMERICS: pattern= needs a regex")
                try:
                    pattern = re.compile(val)
                except re.error as e:
                    raise MXNetError(
                        f"MXTPU_NUMERICS: bad pattern {val!r}: {e}")
            else:
                raise MXNetError(
                    f"MXTPU_NUMERICS: unknown key {key!r} "
                    "(known: every, stats, pattern)")
        else:
            raise MXNetError(
                f"MXTPU_NUMERICS: unknown token {tok!r} (known: on, off, "
                "every=N, stats=a|b, pattern=RE)")
    if want_on is False or (want_on is None and not saw_modifier):
        return None
    return NumericsSpec(every, stats, pattern, s)


# raw env string -> parsed spec, cached: the off path is one environ
# lookup + a string compare per call (the collective-ledger discipline);
# strict-parse errors still raise on every call with a bad value
_cache_lock = threading.Lock()
_cached: Optional[Tuple[Optional[str], Optional[NumericsSpec]]] = None


def spec() -> Optional[NumericsSpec]:
    """The active plane spec, or None when off. Cached against the raw
    env string so tests may monkeypatch ``MXTPU_NUMERICS`` mid-process."""
    global _cached
    raw = env.raw("MXTPU_NUMERICS")
    c = _cached
    if c is not None and c[0] == raw:
        return c[1]
    parsed = _parse(raw)
    with _cache_lock:
        _cached = (raw, parsed)
    return parsed


def enabled() -> bool:
    return spec() is not None


def _grad_of(p):
    """A live parameter's gradient tensor, or None (frozen / not made)."""
    if getattr(p, "grad_req", "null") == "null" or \
            getattr(p, "tensor", None) is None:
        return None
    g = p.data()._grad
    return g._data if g is not None else None


def _log():
    from ..log import get_logger
    return get_logger("mxnet_tpu_torch.telemetry")


class NumericsPlane:
    """Per-process numerics state: the sampling clock, the recent-record
    window, per-parameter stat history, the loss-scale timeline, attached
    Monitor facades, and the provenance dump bookkeeping. ``reset_run``
    re-arms it per fit (the ``reset_pressure_state`` discipline)."""

    def __init__(self):
        self._lock = threading.RLock()
        self.records: deque = deque(maxlen=RECENT)
        self.loss_scale_events: deque = deque(maxlen=512)
        self.nonfinite_steps: List[int] = []
        self.culprits: List[str] = []
        self.dump_paths: List[str] = []
        self.samples = 0
        self._hist: Dict[str, deque] = {}
        self._monitors: List[weakref.ref] = []
        # sampling clock: FitLoop marks the real step; bare Trainer loops
        # fall back to an internal counter. Consume-once per step so a
        # fused decline + classic fallback can't double-sample one step.
        self._ext_step: Optional[int] = None
        self._ext_consumed = True
        self._auto_step = -1
        self.last_step: Optional[int] = None

    # -- clock ----------------------------------------------------------
    def mark(self, step: int) -> None:
        with self._lock:
            self._ext_step = int(step)
            self._ext_consumed = False

    def consume(self, s: NumericsSpec) -> Optional[NumericsSpec]:
        """One sampling decision per step: the first collector (the
        grouped update, or the FitLoop fallback after a decline) takes
        it; later calls within the same marked step get None."""
        with self._lock:
            if self._ext_step is not None:
                if self._ext_consumed:
                    return None
                self._ext_consumed = True
                step = self._ext_step
            else:
                self._auto_step += 1
                step = self._auto_step
            self.last_step = step
        return s if s.sampled(step) else None

    # -- listeners ------------------------------------------------------
    def attach_monitor(self, mon) -> None:
        with self._lock:
            self._monitors = [r for r in self._monitors
                              if r() is not None and r() is not mon]
            self._monitors.append(weakref.ref(mon))

    def _feed_monitors(self, per_param: Dict[str, Dict[str, Any]]) -> None:
        with self._lock:
            refs = list(self._monitors)
        for ref in refs:
            mon = ref()
            if mon is None:
                with self._lock:
                    try:
                        self._monitors.remove(ref)
                    except ValueError:
                        pass
                continue
            if not getattr(mon, "activated", False):
                continue
            try:
                for name, d in per_param.items():
                    if mon.re_prog.match(name):
                        for stat, val in d.items():
                            mon.queue.append(
                                (mon.step, f"{name}:{stat}", val))
            except Exception:
                pass  # a broken listener must not take down training

    # -- run lifecycle --------------------------------------------------
    def reset_run(self) -> None:
        with self._lock:
            self.records.clear()
            self.loss_scale_events.clear()
            self.nonfinite_steps = []
            self.culprits = []
            self.dump_paths = []
            self.samples = 0
            self._hist.clear()
            self._ext_step = None
            self._ext_consumed = True
            self._auto_step = -1
            self.last_step = None

    def history(self, name: str) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._hist.get(name, ())]


_PLANE = NumericsPlane()


def plane() -> NumericsPlane:
    return _PLANE


def reset_run() -> None:
    """Re-arm the plane for a fresh run (``fit.FitLoop`` calls this at
    fit start, like ``memory.reset_pressure_state`` /
    ``collective.reset_health``). Also the strict-parse checkpoint: a
    typo'd ``MXTPU_NUMERICS`` raises HERE, before any step runs."""
    spec()
    _PLANE.reset_run()


def mark_step(step: int) -> None:
    """Pin the plane's sampling clock to the loop owner's step counter
    (``fit.FitLoop`` calls this each step). One cached flag check when
    the plane is off."""
    if spec() is None:
        return
    _PLANE.mark(step)


def collect_spec() -> Optional[NumericsSpec]:
    """The Trainer's hook, called once per update: the active spec when
    THIS step is sampled (consume-once), else None. With the plane off
    this is one cached flag check — no clock reads, no device work."""
    s = spec()
    if s is None:
        return None
    return _PLANE.consume(s)


def attach_monitor(mon) -> None:
    """Register a :class:`~mxnet_tpu_torch.monitor.Monitor` as a plane
    listener: sampled-step per-parameter stats are pushed into its
    ``tic``/``toc`` queue (pattern- and activation-gated)."""
    _PLANE.attach_monitor(mon)


# ---------------------------------------------------------------------------
# Per-parameter fallback stats (the classic non-grouped update path)
# ---------------------------------------------------------------------------

def stats_rows(ws, gs, nws=None):
    """The :data:`RAW_FIELDS` matrix, ``(len(ws), 6)`` f32, over
    (weight, grad[, new weight]) triples: computed on the device from the
    tensors given, nothing fetched. ``update_sumsq`` is 0 without the new
    weights (the per-parameter path has not computed the update). f32
    tensors take multi-tensor norms (a few launches a bucket and one mean
    a parameter); other dtypes and empty tensors are widened to f32 one
    parameter at a time."""
    ts = list(ws) + list(gs) + list(nws or ())
    if not all(t.dtype == torch.float32 and t.numel() for t in ts):
        return _stats_rows_each(ws, gs, nws)
    gs, ws = list(gs), list(ws)

    def sumsq(tensors):
        return torch.stack(torch._foreach_norm(tensors, 2)) ** 2

    upd = sumsq(torch._foreach_sub(list(nws), ws)) if nws is not None \
        else gs[0].new_zeros((len(gs),))
    return torch.stack([
        sumsq(gs), sumsq(ws), upd,
        torch.stack(torch._foreach_norm(gs, float("inf"))),
        torch.stack([g.mean() for g in gs]),
        # g * 0 is 0 where g is finite and NaN where it is not; the 0-norm
        # counts the NaNs
        torch.stack(torch._foreach_norm(torch._foreach_mul(gs, 0.0), 0)),
    ], dim=1)


def _stats_rows_each(ws, gs, nws=None):
    rows = []
    for i, (w, g) in enumerate(zip(ws, gs)):
        gf = g.float()
        wf = w.float()
        zero = gf.new_zeros(())
        upd = zero if nws is None else \
            ((nws[i].float() - wf) ** 2).sum()
        rows.append(torch.stack([
            (gf * gf).sum(), (wf * wf).sum(), upd,
            gf.abs().max() if g.numel() else zero,
            gf.mean() if g.numel() else zero,
            (~torch.isfinite(g)).sum().float()]))
    return torch.stack(rows)


def fallback_collect(trainer) -> Optional[list]:
    """Sampled-step stats for the per-parameter update path over every
    live (weight, grad) pair, parked on ``trainer.last_numerics_stats``
    so the caller fetches the device matrix together with the flag+loss
    transfer. Returns the parked list or None (off / unsampled / nothing
    live)."""
    s = collect_spec()
    if s is None:
        return None
    names, pairs = [], []
    for p in getattr(trainer, "_params", ()):
        g = _grad_of(p)
        if g is None:
            continue
        names.append(p.name)
        pairs.append((p.tensor, g))
    if not pairs:
        return None
    with torch.no_grad():
        mat = stats_rows([w for w, _ in pairs], [g for _, g in pairs])
    out = [(tuple(names), mat)]
    trainer.last_numerics_stats = out
    return out


# ---------------------------------------------------------------------------
# Publication
# ---------------------------------------------------------------------------

def _gauges():
    from .registry import default_registry
    reg = default_registry()
    return (
        reg.gauge("mxtpu_numerics_grad_norm",
                  "Global gradient L2 norm at the last sampled numerics "
                  "step (MXTPU_NUMERICS)."),
        reg.gauge("mxtpu_numerics_update_ratio",
                  "Global update/weight L2 ratio at the last sampled "
                  "numerics step."),
    )


def _loss_scale_gauge():
    from .registry import default_registry
    return default_registry().gauge(
        "mxtpu_loss_scale",
        "Current dynamic loss scale (fit.FitLoop; every backoff/regrowth "
        "event lands in FitResult.numerics['loss_scale_events']).")


def _derive(row, stats: Sequence[str]) -> Dict[str, Any]:
    """One parameter's published stat dict from its raw matrix row."""
    g2, w2, u2, amax, mean, nf = (float(v) for v in row)
    d: Dict[str, Any] = {}
    if "l2" in stats:
        d["l2"] = math.sqrt(g2) if g2 >= 0 else float("nan")
    if "absmax" in stats:
        d["absmax"] = amax
    if "mean" in stats:
        d["mean"] = mean
    if "nonfinite" in stats:
        d["nonfinite"] = int(nf)
    if "update_ratio" in stats and u2 > 0 and w2 > 0:
        d["update_ratio"] = math.sqrt(u2 / w2)
    return d


def record_step(step: int, items, loss_scale: Optional[float] = None,
                finite: bool = True, trainer=None) -> Optional[dict]:
    """Publish one sampled step's host-fetched stats: ``items`` is a list
    of ``(param_names, matrix)`` pairs (the matrix rows follow
    ``RAW_FIELDS``; a host array or nested list). Computes the global
    grad norm / update ratio, the pattern-filtered per-parameter stat
    dicts, feeds the gauges, Perfetto counters, stat history and attached
    Monitors, and appends the record to the recent window. (The JAX
    package's cross-rank merge under a distributed ZeRO plane comes with
    the process group, ROADMAP A10.)"""
    import numpy as _np
    s = spec()
    if s is None:
        return None
    if not items:
        return None
    g2 = w2 = u2 = 0.0
    nonfinite_params = 0
    per_param: Dict[str, Dict[str, Any]] = {}
    for names, mat in items:
        mat = _np.asarray(mat, dtype=_np.float64)
        for j, name in enumerate(names):
            row = mat[j]
            g2 += float(row[0])
            w2 += float(row[1])
            u2 += float(row[2])
            if int(row[5]) > 0:
                nonfinite_params += 1
            if s.wants(name):
                per_param[str(name)] = _derive(row, s.stats)
    grad_norm = math.sqrt(g2) if g2 >= 0 else float("nan")
    # the fallback path cannot know the would-be update (it runs before
    # the per-param step): u2 == 0 there, and a fabricated 0.0 ratio
    # would read as "updates stopped" — publish None instead
    update_ratio = math.sqrt(u2 / w2) if (u2 > 0 and w2 > 0) else None
    rec = {"step": int(step), "grad_norm": grad_norm,
           "update_ratio": update_ratio, "finite": bool(finite),
           "nonfinite_params": int(nonfinite_params),
           "per_param": per_param}
    if loss_scale is not None:
        rec["loss_scale"] = float(loss_scale)
    with _PLANE._lock:
        _PLANE.records.append(rec)
        _PLANE.samples += 1
        for name, d in per_param.items():
            h = _PLANE._hist.get(name)
            if h is None:
                h = _PLANE._hist[name] = deque(maxlen=HIST)
            h.append(dict(d, step=int(step)))
    try:
        gn, ur = _gauges()
        gn.set(grad_norm if math.isfinite(grad_norm) else -1.0)
        if update_ratio is not None:
            ur.set(update_ratio)
        if loss_scale is not None:
            _loss_scale_gauge().set(float(loss_scale))
    except Exception:
        pass
    try:
        from .tracer import tracer as _tr
        if _tr.enabled and math.isfinite(grad_norm):
            _tr.counter_event("grad_norm", grad_norm, category="numerics")
            if update_ratio is not None:
                _tr.counter_event("update_ratio", update_ratio,
                                  category="numerics")
        if _tr.enabled and loss_scale is not None:
            _tr.counter_event("loss_scale", float(loss_scale),
                              category="numerics")
    except Exception:
        pass
    _PLANE._feed_monitors(per_param)
    return rec


def note_loss_scale(step: int, old: float, new: float,
                    trigger: str) -> None:
    """Record one dynamic-loss-scale transition (``fit.FitLoop`` calls on
    every backoff and regrowth). Recorded with the plane off too — the
    timeline is how a mixed-precision run is graded, and it costs one
    list append."""
    ev = {"step": int(step), "old": float(old), "new": float(new),
          "trigger": str(trigger)}
    with _PLANE._lock:
        _PLANE.loss_scale_events.append(ev)
    try:
        _loss_scale_gauge().set(float(new))
    except Exception:
        pass
    try:
        from .tracer import tracer as _tr
        # counter gated on the PLANE, not just the tracer: a plane-off
        # trace must stay byte-identical to pre-plane output (the
        # trace_report omission contract); the timeline/gauge above are
        # the plane-off surfaces
        if _tr.enabled and spec() is not None:
            _tr.counter_event("loss_scale", float(new),
                              category="numerics")
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Non-finite provenance
# ---------------------------------------------------------------------------

def _nonfinite_counts(gs) -> List[int]:
    """Non-finite element counts of each tensor, in one transfer."""
    with torch.no_grad():
        return [int(c) for c in torch.stack(
            [(~torch.isfinite(g)).sum() for g in gs]).tolist()]


def _provenance_scan(named_grads) -> Tuple[Optional[dict], List[dict],
                                           List[int]]:
    """The bisect: per-bucket counts (one transfer), then per-parameter
    counts inside each guilty bucket. Returns (culprit, offenders,
    bucket_counts) where the culprit is the first (parameter-order)
    offender."""
    if not named_grads:
        return None, [], []
    buckets = [named_grads[i:i + PROV_BUCKET]
               for i in range(0, len(named_grads), PROV_BUCKET)]
    with torch.no_grad():
        bcounts = [int(c) for c in torch.stack(
            [torch.stack([(~torch.isfinite(g)).sum()
                          for _i, _n, g in b]).sum()
             for b in buckets]).tolist()]
    offenders: List[dict] = []
    for b, bucket in enumerate(buckets):
        if bcounts[b] == 0:
            continue
        pcounts = _nonfinite_counts([g for _i, _n, g in bucket])
        for (idx, name, g), c in zip(bucket, pcounts):
            if c > 0:
                offenders.append({"index": int(idx), "name": str(name),
                                  "nonfinite": int(c),
                                  "size": int(g.numel())})
    offenders.sort(key=lambda o: o["index"])
    culprit = offenders[0] if offenders else None
    return culprit, offenders, bcounts


def _dump_path() -> str:
    d = str(env.get("MXTPU_MEM_DUMP_DIR") or "") or "."
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        d = "."
    return os.path.join(
        d, f"numerics_{os.getpid()}_{next(_dump_seq)}.json")


def nonfinite_step(step: int, trainer,
                   loss_scale: Optional[float] = None) -> Optional[str]:
    """The provenance pass for one sentinel-skipped step: localize the
    first offending parameter (per-bucket counts → per-param bisect),
    write the forensics record and name the culprit in an ERROR log.
    Returns the dump path (None when the plane is off). Runs AFTER the
    skip verdict is host-known, so its extra syncs cost nothing a clean
    step pays."""
    s = spec()
    if s is None:
        return None
    named = []
    for i, p in enumerate(getattr(trainer, "_params", ())):
        g = _grad_of(p)
        if g is None:
            continue
        named.append((i, p.name, g))
    culprit, offenders, bcounts = _provenance_scan(named)
    try:
        from .registry import default_registry
        default_registry().counter(
            "mxtpu_numerics_nonfinite_steps_total",
            "Training steps the sentinel skipped that the numerics plane "
            "ran a provenance pass on.").inc()
    except Exception:
        pass
    trace_window: List[dict] = []
    try:
        from .tracer import tracer as _tr
        trace_window = _tr.events()[-200:]
    except Exception:
        pass
    with _PLANE._lock:
        _PLANE.nonfinite_steps.append(int(step))
        if culprit is not None:
            _PLANE.culprits.append(culprit["name"])
        recent = [dict(r) for r in _PLANE.records]
        ls_events = [dict(e) for e in _PLANE.loss_scale_events]
    payload = {
        "reason": "nonfinite_gradients",
        "time_unix": time.time(),
        "pid": os.getpid(),
        "step": int(step),
        "loss_scale": loss_scale,
        "culprit": culprit,
        "offending_params": [
            dict(o, history=_PLANE.history(o["name"]))
            for o in offenders[:20]],
        "bucket_nonfinite_counts": bcounts,
        "recent_records": recent,
        "loss_scale_events": ls_events,
        "trace_window": trace_window,
    }
    path = _dump_path()
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        os.replace(tmp, path)
        with _PLANE._lock:
            _PLANE.dump_paths.append(path)
    except Exception as e:
        path = None
        try:
            _log().error("numerics: forensics dump failed (%s)", e)
        except Exception:
            pass
    try:
        if culprit is not None:
            _log().error(
                "numerics: non-finite gradients at step %d — first "
                "offending parameter %r (%d/%d non-finite elements)%s",
                step, culprit["name"], culprit["nonfinite"],
                culprit["size"],
                f" — forensics dump {path}" if path else "")
        else:
            _log().error(
                "numerics: step %d skipped as non-finite but no offending "
                "gradient found", step)
    except Exception:
        pass
    return path


# ---------------------------------------------------------------------------
# Summary (FitResult.numerics)
# ---------------------------------------------------------------------------

def summary() -> Optional[dict]:
    """The ``FitResult.numerics`` payload: recent sampled records, the
    loss-scale timeline, non-finite provenance results. None when the
    plane is off AND no loss-scale event fired (nothing to report)."""
    s = spec()
    with _PLANE._lock:
        events = [dict(e) for e in _PLANE.loss_scale_events]
        if s is None and not events:
            return None
        recent = [dict(r) for r in _PLANE.records]
        out = {
            "enabled": s is not None,
            "every": s.every if s is not None else None,
            "stats": list(s.stats) if s is not None else [],
            "samples": _PLANE.samples,
            "recent": recent,
            "loss_scale_events": events,
            "nonfinite_steps": list(_PLANE.nonfinite_steps),
            "culprits": list(_PLANE.culprits),
            "dumps": list(_PLANE.dump_paths),
        }
    if recent:
        out["grad_norm"] = recent[-1]["grad_norm"]
        out["update_ratio"] = recent[-1]["update_ratio"]
    return out
