"""Telemetry-driven knob autotuner (ref: the JAX package's
``telemetry/autotune.py``).

The perf knobs are numerically neutral: any setting gives bit-identical
updates, only the step time changes — ``MXTPU_GRAD_BUCKET_MB`` (the
gradient buckets, ``bucket_mb``), ``MXTPU_OPTIMIZER_AGGREGATION`` (the
grouped update's bucket size, ``agg``), ``DeviceStagingIter``'s prefetch
depth (``prefetch``) and ``MXTPU_COMM_OVERLAP`` (``overlap``). So they
are safe to probe on live steps: the :class:`AutoTuner` spends a few
instrumented steps per candidate at train start, scores each with the
step breakdown's records, locks the best configuration for the rest of
the run and records every decision:

- each probe step is a tracer span (category ``autotune``) and the lock
  an ``autotune`` instant event;
- chosen values and per-candidate scores land in the metrics registry
  (``mxtpu_autotune_*``);
- the protocol (candidates, scores, the locked config, the margin rule)
  is ``FitResult.tuning_report``;
- the bound detector's diagnosis gains "→ action taken: ..." through
  :meth:`~.step_breakdown.StepBreakdown.note_action`.

Grammar (``MXTPU_AUTOTUNE``, strict — typos raise), the JAX package's::

    on[,probe=N][,warmup=N][,knobs=a|b][,bucket_mb=v|v][,agg=v|v]
      [,prefetch=v|v][,overlap=0|1]

``probe`` measured steps per candidate (default 2) after ``warmup``
unmeasured steps (default 1); ``knobs`` restricts the probed knobs, the
per-knob lists override the built-in candidate values. Candidates are
one-factor-at-a-time: a baseline (the operator's settings) plus, per
knob, each alternative with every other knob at baseline; the locked
config takes, per knob, the best variant only if it beat baseline by more
than ``MIN_GAIN`` (3 %, a noise fence). ``overlap`` is the exception:
it moves the same collectives into backward, so it is adopted when the
exposed ``comm`` share drops by more than ``MIN_GAIN`` (the wall can
neither justify nor veto it at this resolution), and only toward on.
The comm knobs are probed only with a kvstore to communicate through (a
store object, or a ``dist_*`` name; a one-card store named by a string
is dropped by the Trainer, so its knobs would probe nothing), and
``bucket_mb`` not under gradient compression (the bucket layout is
part of the residuals' numerics); under ``MXTPU_ZERO=1`` they steer the
reduce-scatter / allgather round. Probing mutates process env vars and
the staging depth; the FitLoop restores both when ``fit()`` returns —
the decision persists in the report.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from ..base import MXNetError, env
from ..log import get_logger
from .tracer import tracer as _tracer

__all__ = ["AutoTuner", "requested", "parse_spec"]

_LOG = get_logger("mxnet_tpu_torch.autotune")

#: a candidate must beat baseline by this fraction of step time to be
#: locked in — below it the measurement is noise, keep the operator's value
MIN_GAIN = 0.03

#: the grammar's knobs (the JAX package's)
_KNOBS = ("bucket_mb", "agg", "prefetch", "overlap")

#: env var behind each env-backed knob
_KNOB_ENV = {"bucket_mb": "MXTPU_GRAD_BUCKET_MB",
             "agg": "MXTPU_OPTIMIZER_AGGREGATION",
             "overlap": "MXTPU_COMM_OVERLAP"}

#: step-breakdown segments each knob's lever acts on (note_action targets)
_KNOB_SEGMENTS = {"bucket_mb": ("comm", "comm_overlapped"),
                  "agg": ("optimizer",),
                  "prefetch": ("data_wait", "h2d"),
                  "overlap": ("comm", "comm_overlapped")}


def _spec() -> str:
    return str(env.get("MXTPU_AUTOTUNE") or "").strip()


def requested() -> bool:
    """True when ``MXTPU_AUTOTUNE`` asks for tuning. Malformed specs raise
    here — at fit() start — not after an hour of silently-untuned steps."""
    raw = _spec()
    if raw.lower() in ("", "off", "0", "false"):
        return False
    parsed = parse_spec(raw)  # typos raise now
    if not parsed["on"]:
        # tokens given but tuning never enabled ('probe=4' without 'on',
        # unless an explicit off token opted out): ambiguous intent —
        # raise rather than silently train untuned
        if any(t.strip().lower() in ("off", "0", "false")
               for t in raw.split(",")):
            return False
        raise MXNetError(
            f"MXTPU_AUTOTUNE={raw!r} configures tuning but never enables "
            "it — start the spec with 'on' (or set 'off' explicitly)")
    return True


def parse_spec(spec: str) -> Dict[str, object]:
    """Parse one MXTPU_AUTOTUNE spec string (module docstring grammar).
    Returns {'on', 'probe', 'warmup', 'knobs', 'values': {knob: [v,...]}}.
    Unknown tokens/keys/values raise MXNetError."""
    out: Dict[str, object] = {"on": False, "probe": 2, "warmup": 1,
                              "knobs": None, "values": {}}
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        low = tok.lower()
        if low in ("on", "1", "true"):
            out["on"] = True
            continue
        if low in ("off", "0", "false"):
            out["on"] = False
            continue
        if "=" not in tok:
            raise MXNetError(
                f"MXTPU_AUTOTUNE: unknown token {tok!r} (known: on, off, "
                "probe=N, warmup=N, knobs=a|b, bucket_mb=v|v, agg=v|v, "
                "prefetch=v|v, overlap=0|1)")
        key, _, val = tok.partition("=")
        key = key.strip().lower()
        val = val.strip()
        if key in ("probe", "warmup"):
            try:
                n = int(val)
            except ValueError:
                raise MXNetError(
                    f"MXTPU_AUTOTUNE: {key}={val!r} is not an int")
            if key == "probe" and n < 1:
                raise MXNetError("MXTPU_AUTOTUNE: probe must be >= 1")
            if n < 0:
                raise MXNetError(f"MXTPU_AUTOTUNE: {key} must be >= 0")
            out[key] = n
        elif key == "knobs":
            knobs = [k.strip() for k in val.split("|") if k.strip()]
            bad = [k for k in knobs if k not in _KNOBS]
            if bad or not knobs:
                raise MXNetError(
                    f"MXTPU_AUTOTUNE: knobs={val!r} — unknown knob(s) "
                    f"{bad or val!r} (known: {', '.join(_KNOBS)})")
            out["knobs"] = knobs
        elif key in _KNOBS:
            vals: List[float] = []
            for v in val.split("|"):
                v = v.strip()
                try:
                    vals.append(float(v) if key == "bucket_mb" else int(v))
                except ValueError:
                    raise MXNetError(
                        f"MXTPU_AUTOTUNE: {key}={val!r} — {v!r} is not "
                        "numeric")
            if key == "overlap" and any(v not in (0, 1) for v in vals):
                raise MXNetError(
                    f"MXTPU_AUTOTUNE: overlap={val!r} (only 0|1)")
            if any(v < 0 for v in vals) or \
                    (key == "prefetch" and any(v < 1 for v in vals)):
                raise MXNetError(
                    f"MXTPU_AUTOTUNE: {key}={val!r} out of range")
            out["values"][key] = vals
        else:
            raise MXNetError(
                f"MXTPU_AUTOTUNE: unknown key {key!r} (known: probe, "
                f"warmup, knobs, {', '.join(_KNOBS)})")
    return out


class _Candidate:
    __slots__ = ("label", "knob", "knobs", "walls", "segs")

    def __init__(self, label: str, knob: Optional[str], knobs: Dict):
        self.label = label
        self.knob = knob          # the ONE knob varied (None = baseline)
        self.knobs = knobs        # full knob->value config for this probe
        self.walls: List[float] = []
        self.segs: Dict[str, float] = {}

    def score(self) -> float:
        """Best (minimum) measured step wall seconds, inf until measured.
        min, not mean: with only a few probe steps a single scheduler
        hiccup in the mean would swamp the 3% decision fence, while the
        fastest observed step is the config's real floor (timeit's
        rationale)."""
        return min(self.walls) if self.walls else float("inf")

    def seg_share(self, *names: str) -> float:
        w = sum(self.walls)
        c = sum(self.segs.get(n, 0.0) for n in names)
        return (c / w) if w > 0 else 0.0

    def comm_share(self) -> float:
        """Total communication share: exposed + overlapped."""
        return self.seg_share("comm", "comm_overlapped")


class AutoTuner:
    """Probe-then-lock controller driven by the FitLoop.

    The loop calls :meth:`on_step_begin` before each trained step (the
    tuner applies the next candidate's knobs) and :meth:`on_step_end`
    with the step's breakdown record (the tuner scores it). After
    ``candidates * (warmup + probe)`` steps it locks the combined best
    config and goes quiescent; :meth:`report` is the full protocol dump.
    """

    def __init__(self, spec: Optional[str] = None, trainer=None,
                 data_iter=None, registry=None):
        parsed = parse_spec(_spec() if spec is None else spec)
        self.enabled = bool(parsed["on"])
        self.probe = int(parsed["probe"])
        self.warmup = int(parsed["warmup"])
        self._knob_filter = parsed["knobs"]
        self._value_overrides = parsed["values"]
        self._trainer = trainer
        self._data_iter = data_iter
        self._registry = registry
        self.locked = False
        self.locked_at_step: Optional[int] = None
        self.chosen: Dict[str, object] = {}
        self._cands: Optional[List[_Candidate]] = None
        self._idx = 0              # current candidate index
        self._steps_in_cand = 0    # steps taken under current candidate
        self._t0: Optional[float] = None
        self._saved_env: Dict[str, Optional[str]] = {}
        self._saved_depth: Optional[int] = None
        self._baseline: Dict[str, object] = {}
        self._probe_steps_total = 0

    # -- knob plumbing ---------------------------------------------------
    def _current(self, knob: str):
        if knob == "bucket_mb":
            try:
                return float(env.get("MXTPU_GRAD_BUCKET_MB"))
            except (TypeError, ValueError):
                return 0.0
        if knob == "overlap":
            # the Trainer's own strict parse: the tuner must not overwrite
            # a value the trainer rejects
            from ..gluon.trainer import _overlap_requested
            return 1 if _overlap_requested() else 0
        if knob == "agg":
            from ..optimizer.grouped import aggregation_size
            return aggregation_size()
        if knob == "prefetch":
            return int(getattr(self._data_iter, "depth", 1))
        raise MXNetError(f"unknown knob {knob!r}")

    def _apply(self, knob: str, value) -> None:
        if knob == "prefetch":
            set_depth = getattr(self._data_iter, "set_depth", None)
            if set_depth is not None:
                if self._saved_depth is None:
                    # like the env vars: the operator's depth is restored
                    # when fit() returns, even from a run that ended
                    # mid-probe — only the decision persists
                    self._saved_depth = int(
                        getattr(self._data_iter, "depth", 1))
                set_depth(int(value))
            return
        name = _KNOB_ENV[knob]
        if name not in self._saved_env:
            self._saved_env[name] = env.raw(name)
        if knob == "overlap":
            env.set(name, "on" if int(value) else "off")
        elif knob == "bucket_mb":
            env.set(name, repr(float(value)))
        else:
            env.set(name, str(int(value)))

    def restore_env(self) -> None:
        """Reinstate the operator's environment — env vars AND the
        staging iterator's depth (FitLoop calls this when fit() returns:
        the decision lives on in the report, the mutations must not leak
        past the run)."""
        for name, old in self._saved_env.items():
            env.set(name, old)
        self._saved_env.clear()
        if self._saved_depth is not None:
            set_depth = getattr(self._data_iter, "set_depth", None)
            if set_depth is not None:
                set_depth(self._saved_depth)
            self._saved_depth = None

    # -- candidate plan --------------------------------------------------
    @staticmethod
    def _store_compresses(t) -> bool:
        """True when the trainer's kvstore compresses gradients (read
        without creating a lazy store)."""
        if getattr(t, "_compression_params", None):
            return True
        kv = getattr(t, "_kvstore", None)
        if kv is None:
            arg = getattr(t, "_kvstore_arg", None)
            kv = arg if not isinstance(arg, str) else None
        return bool(getattr(kv, "_compressor", None) or
                    getattr(kv, "_compression_params", None))

    def _applicable_knobs(self) -> List[str]:
        knobs = list(self._knob_filter or _KNOBS)
        # prefetch needs a depth-adjustable staging iterator
        if "prefetch" in knobs and \
                getattr(self._data_iter, "set_depth", None) is None:
            knobs.remove("prefetch")
        t = self._trainer
        if t is not None:
            # the comm knobs need a kvstore to communicate through: none,
            # or a one-process store named by a string, which the Trainer
            # drops on one card (the JAX package probes them there too,
            # to no effect)
            arg = getattr(t, "_kvstore_arg", None)
            if not arg or (isinstance(arg, str) and
                           not arg.lower().startswith("dist")) or (
                    getattr(t, "_kv_initialized", False) and
                    getattr(t, "_kvstore", None) is None):
                for k in ("bucket_mb", "overlap"):
                    if k in knobs:
                        knobs.remove(k)
            elif "bucket_mb" in knobs and self._store_compresses(t):
                # the residuals are per bucket key: re-bucketing mid-run
                # would change the numerics probing assumes unchanged
                knobs.remove("bucket_mb")
        return knobs

    def _default_values(self, knob: str, cur) -> List:
        if knob == "bucket_mb":
            return [v for v in (4.0, 100.0) if v != cur]
        if knob == "overlap":
            return [1] if not cur else [0]
        if knob == "agg":
            return [v for v in (16,) if v != cur]
        if knob == "prefetch":
            return [v for v in (3,) if v != cur]
        return []

    def _build_plan(self) -> List[_Candidate]:
        self._baseline = {k: self._current(k)
                          for k in self._applicable_knobs()}
        cands = [_Candidate("baseline", None, dict(self._baseline))]
        for knob, cur in self._baseline.items():
            values = self._value_overrides.get(knob)
            values = [v for v in values if v != cur] if values is not None \
                else self._default_values(knob, cur)
            for v in values:
                knobs = dict(self._baseline)
                knobs[knob] = v
                cands.append(_Candidate(f"{knob}={v:g}" if
                                        isinstance(v, float)
                                        else f"{knob}={v}", knob, knobs))
        return cands

    # -- the FitLoop protocol --------------------------------------------
    def on_step_begin(self, step: int) -> None:
        if self.locked or not self.enabled:
            return
        if self._cands is None:
            self._cands = self._build_plan()
            if len(self._cands) <= 1:
                # nothing to vary (no kvstore, no staging iter, overrides
                # all equal to current): lock immediately on baseline
                self._lock(step)
                return
            _LOG.warning(
                "autotune: probing %d candidates x (%d warmup + %d "
                "measured) steps — knobs %s",
                len(self._cands), self.warmup, self.probe,
                sorted(self._baseline))
            self._apply_candidate(self._cands[0])
        elif self._steps_in_cand == 0:
            self._apply_candidate(self._cands[self._idx])
        self._t0 = time.perf_counter()

    def _apply_candidate(self, cand: _Candidate) -> None:
        for knob, value in cand.knobs.items():
            self._apply(knob, value)

    def on_step_end(self, step: int, rec: Dict[str, float],
                    breakdown=None) -> None:
        if self.locked or not self.enabled or self._cands is None \
                or self._t0 is None:
            return
        t1 = time.perf_counter()
        cand = self._cands[self._idx]
        self._steps_in_cand += 1
        self._probe_steps_total += 1
        measured = self._steps_in_cand > self.warmup
        if measured:
            wall = rec.get("wall") or (t1 - self._t0)
            cand.walls.append(wall)
            for name, s in rec.items():
                if name != "wall":
                    cand.segs[name] = cand.segs.get(name, 0.0) + s
        _tracer.record(f"probe:{cand.label}", "autotune", self._t0, t1,
                       {"step": step, "candidate": cand.label,
                        "measured": measured})
        self._t0 = None
        if self._steps_in_cand >= self.warmup + self.probe:
            self._idx += 1
            self._steps_in_cand = 0
            if self._idx >= len(self._cands):
                self._lock(step, breakdown)

    # -- decision --------------------------------------------------------
    def _lock(self, step: int, breakdown=None) -> None:
        self.locked = True
        self.locked_at_step = step
        cands = self._cands or []
        base = cands[0] if cands else None
        base_score = base.score() if base else float("inf")
        self.chosen = dict(self._baseline)
        changed: Dict[str, Dict[str, object]] = {}
        for knob in self._baseline:
            variants = [c for c in cands if c.knob == knob and c.walls]
            if not variants:
                continue
            best = min(variants, key=_Candidate.score)
            if knob == "overlap":
                # the same collectives, launched during backward: adopted
                # when the exposed comm share drops by more than the
                # fence, and only toward on (module docstring)
                if base is not None and best.knobs[knob] and \
                        not self._baseline[knob] and \
                        base.seg_share("comm") - best.seg_share("comm") \
                        > MIN_GAIN:
                    self.chosen[knob] = best.knobs[knob]
                    changed[knob] = {
                        "from": self._baseline[knob],
                        "to": best.knobs[knob],
                        "gain_frac": round(1.0 - best.score() / base_score,
                                           4) if base_score > 0 else None,
                        "comm_share_from": round(base.seg_share("comm"), 4),
                        "comm_share_to": round(best.seg_share("comm"), 4),
                    }
            elif base_score > 0 and \
                    best.score() < base_score * (1.0 - MIN_GAIN):
                self.chosen[knob] = best.knobs[knob]
                changed[knob] = {
                    "from": self._baseline[knob],
                    "to": best.knobs[knob],
                    "gain_frac": round(1.0 - best.score() / base_score, 4),
                }
        # apply the combined winner for the rest of the run
        for knob, value in self.chosen.items():
            self._apply(knob, value)
        summary = (", ".join(f"{k}: {c['from']}->{c['to']}"
                             for k, c in sorted(changed.items()))
                   or "kept operator settings")
        _LOG.warning("autotune: locked at step %d — %s", step, summary)
        _tracer.instant(
            "autotune:lock " + json.dumps(
                {"step": step, "chosen": self.chosen, "changed": changed},
                sort_keys=True, default=str), "autotune")
        # the bound detector's diagnosis upgrades to "→ action taken" on
        # every segment a changed knob is the lever for
        if breakdown is not None and changed:
            for knob in changed:
                for seg in _KNOB_SEGMENTS.get(knob, ()):
                    breakdown.note_action(
                        seg, f"autotune locked {summary} (step {step})")
        self._export_metrics()

    def _export_metrics(self) -> None:
        try:
            if self._registry is None:
                from .registry import default_registry
                self._registry = default_registry()
            reg = self._registry
            reg.counter(
                "mxtpu_autotune_probe_steps_total",
                "Training steps spent probing autotune candidates."
            ).inc(self._probe_steps_total)
            for knob, value in self.chosen.items():
                reg.gauge(
                    f"mxtpu_autotune_chosen_{knob}",
                    f"Autotuner-locked value of the {knob} knob."
                ).set(float(value))
            for cand in (self._cands or []):
                if not cand.walls:
                    continue
                name = cand.label.replace("=", "_").replace(".", "_") \
                    .replace("-", "m")
                reg.gauge(
                    f"mxtpu_autotune_score_ms_{name}",
                    "Best probed step time (ms) for this autotune "
                    "candidate.").set(round(cand.score() * 1e3, 3))
        except Exception:
            # observability must not take down training
            _LOG.exception("autotune: metrics export failed")

    # -- the protocol dump ----------------------------------------------
    def report(self) -> Dict[str, object]:
        """The full tuning protocol (lands in FitResult.tuning_report)."""
        try:
            from ..parallel.zero import zero_requested
            zero_on = zero_requested()
        except Exception:
            zero_on = False
        cands = self._cands or []
        base = cands[0] if cands else None
        base_score = base.score() if base and base.walls else None
        out: Dict[str, object] = {
            "status": "locked" if self.locked else "probing",
            "probe_steps": self.probe,
            "warmup_steps": self.warmup,
            "min_gain_frac": MIN_GAIN,
            # which comm round the knobs steered
            "zero": zero_on,
            "locked_at_step": self.locked_at_step,
            "baseline": dict(self._baseline),
            "chosen": dict(self.chosen),
            "candidates": [
                {"label": c.label,
                 "knobs": dict(c.knobs),
                 "measured_steps": len(c.walls),
                 "best_step_s": round(c.score(), 6) if c.walls else None,
                 "comm_share": round(c.comm_share(), 4) if c.walls
                 else None,
                 "comm_exposed_share": round(c.seg_share("comm"), 4)
                 if c.walls else None,
                 "vs_baseline": round(c.score() / base_score, 4)
                 if (c.walls and base_score) else None}
                for c in cands],
        }
        return out
