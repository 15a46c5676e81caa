"""Persistent run reports: one JSON verdict per training run (ref: the
JAX package's ``telemetry/run_report.py``).

``fit.FitLoop`` calls :func:`write_run_report` at fit end whenever
``MXTPU_RUN_REPORT_DIR`` is set. The artifact (``run_<pid>_<ts>.json``,
tmp+rename so a file that exists parses) carries the JAX package's keys:

- a **fingerprint**: every declared env knob whose value differs from
  its default, plus the identity of the run (``torch`` and its version,
  the backend ``cuda`` or ``cpu``, the device count and the world size),
  so a diff can tell "slower" from "configured differently";
- the **step-time distribution** (p50 / p95 / max over the step
  breakdown's recent window, plus the full-run mean);
- a **loss-trajectory digest** (endpoints, extrema, tail and a hash of
  the rounded trajectory: two bitwise-identical runs hash equal);
- **per-axis summaries**: breakdown shares, memory peaks, numerics
  globals and the efficiency rollup when those planes ran.

``tools/run_compare.py`` diffs two reports (of either package) into
per-metric regression verdicts with CI exit codes. The report directory
keeps a shared ``fault.write_manifest`` SHA-256 manifest over its files.
The serving-mode report (``build_serving_payload`` /
``write_serving_report``) comes with serving (ROADMAP A12) and raises.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

from ..base import env
from ..ops.registry import NotPortedError

__all__ = ["REPORT_FORMAT", "write_run_report", "load_run_report",
           "build_payload", "report_dir", "build_serving_payload",
           "write_serving_report"]

#: bump when the payload layout changes incompatibly; run_compare checks it
REPORT_FORMAT = 1

_seq = itertools.count(1)


def report_dir() -> Optional[str]:
    """The configured report directory (``MXTPU_RUN_REPORT_DIR``), or
    None when run reports are off."""
    d = str(env.get("MXTPU_RUN_REPORT_DIR") or "").strip()
    return d or None


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated percentile over an ascending list."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)


def _step_time_summary(result) -> Optional[Dict[str, Any]]:
    """p50/p95/max over the per-step walls the step breakdown retained
    (bounded recent window — documented in the payload as ``window``),
    plus the full-run mean; falls back to the efficiency rollup's
    per-step walls when breakdown collection was off."""
    walls: List[float] = []
    window_src = None
    bd = getattr(result, "step_breakdown", None)
    if bd and bd.get("per_step"):
        walls = [float(r.get("wall", 0.0)) for r in bd["per_step"]
                 if r.get("wall")]
        window_src = "step_breakdown"
    if not walls:
        eff = getattr(result, "efficiency", None)
        if eff and eff.get("recent"):
            walls = [float(r.get("wall_s", 0.0)) for r in eff["recent"]
                     if r.get("wall_s")]
            window_src = "efficiency"
    if not walls:
        return None
    walls.sort()
    out = {
        "window": len(walls),
        "window_source": window_src,
        "p50_s": round(_percentile(walls, 0.50), 6),
        "p95_s": round(_percentile(walls, 0.95), 6),
        "max_s": round(walls[-1], 6),
    }
    if bd and bd.get("steps"):
        out["steps"] = int(bd["steps"])
        out["mean_s"] = float(bd.get("mean_step_s", 0.0))
    return out


def _loss_digest(losses: List[float]) -> Optional[Dict[str, Any]]:
    if not losses:
        return None
    rounded = [round(float(v), 6) for v in losses]
    # hash over a JSON-safe projection (NaN/inf -> string markers, so
    # bitwise-identical trajectories still hash equal and the digest
    # input is deterministic); the payload itself carries non-finite
    # values as None (RFC 8259 has no NaN token — _json_safe enforces
    # it for the whole report) plus an explicit count
    safe = [v if math.isfinite(v) else repr(v) for v in rounded]
    digest = hashlib.sha256(
        json.dumps(safe).encode()).hexdigest()[:16]
    finite = [v for v in rounded if math.isfinite(v)]
    return {
        "n": len(losses),
        "nonfinite": len(rounded) - len(finite),
        "first": rounded[0],
        "last": rounded[-1],
        "min": min(finite) if finite else None,
        "max": max(finite) if finite else None,
        "tail": rounded[-16:],
        "sha256_16": digest,
    }


def _json_safe(obj):
    """Replace non-finite floats with None everywhere in the payload:
    RFC 8259 JSON has no NaN/Infinity token, and the report is consumed
    by non-Python CI tooling (`jq`) that rejects the whole file on one
    bare ``NaN`` — exactly on the diverged runs the artifact exists to
    catch. Loss divergence stays visible via ``loss.nonfinite``."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def _env_fingerprint() -> Dict[str, Any]:
    """Declared env knobs whose live value differs from the declared
    default — the configuration axes that distinguish two runs. A var
    merely SET to its default is not an override, and the report
    directory itself is never one (two runs reporting into different
    directories are not configured differently)."""
    overrides: Dict[str, Any] = {}
    for name, _typ, value, _doc in env.items():
        if name == "MXTPU_RUN_REPORT_DIR":
            continue
        if env.raw(name) is not None and value != env.default_for(name):
            overrides[name] = value
    fp: Dict[str, Any] = {"env_overrides": overrides}
    try:
        import torch
        fp["torch"] = torch.__version__
        cuda = torch.cuda.is_available()
        fp["backend"] = "cuda" if cuda else "cpu"
        fp["device_count"] = torch.cuda.device_count() if cuda else 1
    except Exception:
        pass
    # topology identity: the world size this run trained at (one card and
    # no process group in the port until ROADMAP A10), so run_compare
    # flags a cross-topology comparison
    fp["world_size"] = 1
    return fp


def build_payload(result, extra: Optional[dict] = None) -> Dict[str, Any]:
    """Assemble the report payload from a :class:`~mxnet_tpu_torch.fit
    .FitResult` (any object with its attribute shape works)."""
    bd = getattr(result, "step_breakdown", None) or None
    mem = getattr(result, "memory", None) or None
    ch = getattr(result, "comm_health", None) or None
    num = getattr(result, "numerics", None) or None
    eff = getattr(result, "efficiency", None) or None
    payload: Dict[str, Any] = {
        "format": REPORT_FORMAT,
        "kind": "mxtpu_run_report",
        "time_unix": time.time(),
        "pid": os.getpid(),
        "fingerprint": _env_fingerprint(),
        "run": {
            "status": getattr(result, "status", None),
            "steps": int(getattr(result, "step", 0)),
            "epochs": int(getattr(result, "epoch", 0)),
            "resumed_from": getattr(result, "resumed_from", None),
            "skipped_steps": len(getattr(result, "skipped_steps", []) or []),
            "loss_scale": getattr(result, "loss_scale", None),
        },
        "step_time": _step_time_summary(result),
        "loss": _loss_digest(getattr(result, "losses", []) or []),
    }
    if bd:
        payload["breakdown"] = {
            "shares": bd.get("shares"),
            "accounted_frac": bd.get("accounted_frac"),
            "diagnoses": len(bd.get("diagnoses", [])),
            "actions": bd.get("actions") or {},
        }
    if mem:
        payload["memory"] = {
            "live_bytes": mem.get("live_bytes"),
            "peak_bytes": mem.get("peak_bytes"),
            "by_category": mem.get("by_category"),
        }
    if ch:
        payload["comm_health"] = {
            "max_skew_ms": ch.get("max_skew_ms"),
            "straggler_rank": ch.get("straggler_rank"),
            "desyncs": ch.get("desyncs", ch.get("desync")),
            "watchdog_fired": ch.get("watchdog_fired"),
            "ledger_dropped": ch.get("ledger_dropped"),
        }
    if num:
        payload["numerics"] = {
            "samples": num.get("samples"),
            "grad_norm": num.get("grad_norm"),
            "update_ratio": num.get("update_ratio"),
            "nonfinite_steps": len(num.get("nonfinite_steps", [])),
            "loss_scale_events": len(num.get("loss_scale_events", [])),
        }
    if eff:
        # the full rollup minus the bounded per-step window (the report
        # is a verdict, not a trace; run_compare reads the aggregates)
        payload["efficiency"] = {k: v for k, v in eff.items()
                                 if k != "recent"}
    if extra:
        payload["extra"] = dict(extra)
    return payload


def write_run_report(result, directory: Optional[str] = None,
                     extra: Optional[dict] = None) -> str:
    """Write one run report (tmp+rename) into ``directory`` (default
    ``MXTPU_RUN_REPORT_DIR``) and refresh the directory's shared
    SHA-256 manifest. Returns the report path."""
    d = directory or report_dir()
    if not d:
        raise ValueError(
            "write_run_report: no directory (set MXTPU_RUN_REPORT_DIR "
            "or pass directory=)")
    os.makedirs(d, exist_ok=True)
    payload = build_payload(result, extra=extra)
    ts = int(payload["time_unix"])
    path = os.path.join(d, f"run_{os.getpid()}_{ts}.json")
    while os.path.exists(path):
        # two fits inside one second in one process: disambiguate, never
        # overwrite an earlier run's verdict
        path = os.path.join(
            d, f"run_{os.getpid()}_{ts}_{next(_seq)}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        # allow_nan=False enforces the _json_safe contract: a stray
        # non-finite float must fail HERE (and be fixed) rather than
        # ship an artifact strict parsers reject
        json.dump(_json_safe(payload), f, indent=1, default=str,
                  allow_nan=False)
    os.replace(tmp, path)
    try:
        from ..fault import write_manifest
        write_manifest(d)
    except Exception:
        pass  # the report itself landed; the manifest is best-effort
    try:
        from .registry import default_registry
        default_registry().counter(
            "mxtpu_run_reports_total",
            "Run reports written at fit end (MXTPU_RUN_REPORT_DIR).").inc()
    except Exception:
        pass
    return path


def build_serving_payload(metrics_json: Dict[str, Any],
                          extra: Optional[dict] = None) -> Dict[str, Any]:
    raise NotPortedError("run_report.build_serving_payload: the serving "
                         "report is not ported yet (ROADMAP.md, queue A12)")


def write_serving_report(metrics_json: Dict[str, Any],
                         directory: Optional[str] = None,
                         extra: Optional[dict] = None) -> str:
    raise NotPortedError("run_report.write_serving_report: the serving "
                         "report is not ported yet (ROADMAP.md, queue A12)")


def load_run_report(path: str) -> Dict[str, Any]:
    """Load + format-check one report (the run_compare entry point)."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("kind") != "mxtpu_run_report":
        raise ValueError(f"{path}: not a run report (kind="
                         f"{payload.get('kind')!r})")
    if int(payload.get("format", -1)) > REPORT_FORMAT:
        raise ValueError(
            f"{path}: report format {payload.get('format')} is newer "
            f"than this reader ({REPORT_FORMAT})")
    return payload
