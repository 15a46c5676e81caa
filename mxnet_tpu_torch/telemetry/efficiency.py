"""The efficiency plane, off (ref: the JAX package's
``telemetry/efficiency.py``).

What ``fit.FitLoop`` calls with ``MXTPU_EFFICIENCY`` unset or off:
``reset_run`` (the strict parse of the flag, before any step runs),
``begin_step``, ``end_step`` and :func:`summary`, which is ``None``.

Not ported: the rollup itself (per-program FLOP and byte costs of
compiled XLA programs against a device peak table). ``MXTPU_EFFICIENCY``
set on raises ``NotPortedError`` at the strict parse (ROADMAP A9); an
unknown token raises ``MXNetError`` as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

from ..base import MXNetError, env
from ..ops.registry import NotPortedError

__all__ = ["enabled", "spec", "reset_run", "begin_step", "end_step",
           "summary"]


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


def spec() -> bool:
    """False: the plane is off. A value that turns it on raises
    ``NotPortedError``."""
    if _parse(env.raw("MXTPU_EFFICIENCY")):
        raise NotPortedError("MXTPU_EFFICIENCY: the efficiency plane is "
                             "not ported yet (ROADMAP.md, queue A9)")
    return False


def enabled() -> bool:
    return spec()


def reset_run() -> None:
    """The strict-parse checkpoint at fit start, before any step runs."""
    spec()


def begin_step() -> None:
    """Open a step window: nothing to record with the plane off."""


def end_step(step: Optional[int] = None, samples: int = 0,
             useful: bool = True,
             tokens_per_sample: Optional[float] = None,
             wall_s: Optional[float] = None) -> None:
    return None


def summary(tokens_per_sample: Optional[float] = None) -> None:
    """The ``FitResult.efficiency`` payload: None, the plane is off."""
    return None
