"""Top-level Executor re-export, ``mx.Executor`` (ref: the JAX package's
``executor_compat.py``; mx.executor.Executor)."""
from .symbol.executor import Executor  # noqa: F401
