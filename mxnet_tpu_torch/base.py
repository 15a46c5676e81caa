"""Framework error type and the CHECK() analog (ref: python/mxnet/base.py).

A copy of what the port needs from ``mxnet_tpu/base.py``: the port imports
nothing of the JAX package.
"""
from __future__ import annotations

__all__ = ["MXNetError", "check"]


class MXNetError(RuntimeError):
    """Framework-level error (ref: python/mxnet/base.py MXNetError)."""


def check(cond: bool, msg: str = "check failed") -> None:
    """CHECK() analog: raise :class:`MXNetError` when ``cond`` is false."""
    if not cond:
        raise MXNetError(msg)
