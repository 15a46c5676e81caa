"""The numerics plane, off (ref: the JAX package's
``telemetry/numerics.py``).

What ``fit.FitLoop`` calls with ``MXTPU_NUMERICS`` unset or off:
``reset_run`` (the strict parse of the flag, before any step runs),
``mark_step``, ``fallback_collect`` (nothing to collect), ``enabled``,
the dynamic loss-scale timeline (:func:`note_loss_scale`, recorded with
the plane off too) and :func:`summary`, which is ``None`` when the plane
is off and no loss-scale event fired.

Not ported: the plane itself — in-update tensor statistics, non-finite
provenance and their forensics. ``MXTPU_NUMERICS`` set on raises
``NotPortedError`` at the strict parse (ROADMAP A9); a malformed value
raises ``MXNetError`` as in the JAX package.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

from ..base import MXNetError, env
from ..ops.registry import NotPortedError

__all__ = ["enabled", "spec", "reset_run", "mark_step", "collect_spec",
           "fallback_collect", "note_loss_scale", "summary", "STATS"]

#: publishable derived stats (the ``stats=`` grammar tokens)
STATS = ("l2", "absmax", "mean", "nonfinite", "update_ratio")


def _parse(raw: Optional[str]) -> bool:
    """Strict ``MXTPU_NUMERICS`` parse, as the JAX package's: True when
    the value turns the plane on. A spec made only of modifiers
    (``every=``, ``stats=``, ``pattern=``) implies ``on``."""
    import re
    s = (raw or "").strip()
    if not s:
        return False
    want_on, saw_modifier = None, False
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
            elif key == "pattern":
                if not val:
                    raise MXNetError(
                        "MXTPU_NUMERICS: pattern= needs a regex")
                try:
                    re.compile(val)
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
    return not (want_on is False or (want_on is None and not saw_modifier))


def spec() -> None:
    """The active plane spec: always None here (the plane is off); a
    value that turns it on raises ``NotPortedError``."""
    if _parse(env.raw("MXTPU_NUMERICS")):
        raise NotPortedError("MXTPU_NUMERICS: the numerics plane is not "
                             "ported yet (ROADMAP.md, queue A9)")
    return None


def enabled() -> bool:
    return spec() is not None


_lock = threading.Lock()
_loss_scale_events: deque = deque(maxlen=512)


def reset_run() -> None:
    """Re-arm for a fresh run (``fit.FitLoop`` calls this at fit start);
    the strict-parse checkpoint, before any step runs."""
    spec()
    with _lock:
        _loss_scale_events.clear()


def mark_step(step: int) -> None:
    """The plane's sampling clock: nothing to sample with the plane off."""


def collect_spec() -> None:
    return None


def fallback_collect(trainer) -> Optional[list]:
    """Per-parameter fallback stats: nothing with the plane off."""
    return None


def note_loss_scale(step: int, old: float, new: float,
                    trigger: str) -> None:
    """Record one dynamic-loss-scale transition (``fit.FitLoop`` calls on
    every backoff and regrowth), with the plane off too."""
    with _lock:
        _loss_scale_events.append({"step": int(step), "old": float(old),
                                   "new": float(new),
                                   "trigger": str(trigger)})


def summary() -> Optional[dict]:
    """The ``FitResult.numerics`` payload: None when no loss-scale event
    fired (the plane is always off here), else the JAX package's keys
    with the plane-off values."""
    with _lock:
        events: List[dict] = [dict(e) for e in _loss_scale_events]
    if not events:
        return None
    return {"enabled": False, "every": None, "stats": [], "samples": 0,
            "recent": [], "loss_scale_events": events,
            "nonfinite_steps": [], "culprits": [], "dumps": []}
