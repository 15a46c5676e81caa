"""Framework error type, the CHECK() analog and the environment-variable
registry (ref: python/mxnet/base.py).

A copy of what the port needs from ``mxnet_tpu/base.py``: the port imports
nothing of the JAX package. Every environment variable the port reads goes
through :data:`env`; no other module reads ``os.environ``.
"""
from __future__ import annotations

import ast
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["MXNetError", "check", "EnvRegistry", "env", "coerce_param",
           "hashable_params", "torch_dtype", "numpy_dtype"]


class MXNetError(RuntimeError):
    """Framework-level error (ref: python/mxnet/base.py MXNetError)."""


def check(cond: bool, msg: str = "check failed") -> None:
    """CHECK() analog: raise :class:`MXNetError` when ``cond`` is false."""
    if not cond:
        raise MXNetError(msg)


class EnvRegistry:
    """Typed registry of MXNET_* environment variables (ref: the JAX
    package's ``base.EnvRegistry``; docs/faq/env_var.md): each knob is
    declared once with its type, default and doc."""

    def __init__(self) -> None:
        self._defaults: Dict[str, Tuple[type, Any, str]] = {}

    def declare(self, name: str, typ: type, default: Any,
                doc: str = "") -> None:
        self._defaults[name] = (typ, default, doc)

    def get(self, name: str, default: Any = None) -> Any:
        """The variable's value coerced to its declared type; a bool is
        false only for "0", "false", "False" and "". Unset: ``default``,
        else the declared default."""
        if name in self._defaults:
            typ, decl_default, _ = self._defaults[name]
            raw = os.environ.get(name)
            if raw is None:
                return decl_default if default is None else default
            if typ is bool:
                return raw not in ("0", "false", "False", "")
            return typ(raw)
        raw = os.environ.get(name)
        return raw if raw is not None else default

    def raw(self, name: str) -> Optional[str]:
        """Uncoerced read: the environment string, or None when unset. For
        variables that are not the framework's to declare (``CUDA_HOME``)."""
        return os.environ.get(name)

    def default_for(self, name: str) -> Any:
        """The declared default (None for an undeclared name)."""
        decl = self._defaults.get(name)
        return decl[1] if decl is not None else None

    def items(self):
        for name, (typ, default, doc) in sorted(self._defaults.items()):
            yield name, typ, self.get(name), doc


env = EnvRegistry()

# the flags the port reads, with the JAX package's types, defaults and docs
env.declare("MXNET_SAFE_ACCUMULATION", bool, False,
            "Accumulate f16/bf16 reductions (sum/mean/prod/norm) in f32.")
env.declare("MXNET_RESID_DTYPE", str, "",
            "Store backward activation residuals 8-bit (fp8|e4m3|e5m2). "
            "Conv dx stays exact (needs only weights); conv dW, BN "
            "grads/dx (via fp8 xhat) and ReLU masks see small zero-mean "
            "rounding (ops/resid8.py). Not ported yet: the port raises "
            "when it is set.")
env.declare("MXTPU_FUSED_EPILOGUE", bool, True,
            "Route the fused conv-epilogue ops (BatchNorm(+add)+ReLU) "
            "through the hand-written CUDA kernels (their plain PyTorch "
            "versions on the CPU). Set 0 to fall back to the composed "
            "unfused lowering. Read at every call; a CUDA graph keeps the "
            "value it read at capture.")


# ---------------------------------------------------------------------------
# Parameter coercion: accept python values or their string serialization, the
# way dmlc::Parameter parses kwargs (ref: mxnet_tpu/base.py coerce_param).
# ---------------------------------------------------------------------------

_BOOL_STRINGS = {"true": True, "True": True, "1": True,
                 "false": False, "False": False, "0": False}


def coerce_param(value: Any) -> Any:
    """Best-effort conversion of string-serialized op params to python values
    (``"(2, 2)"`` -> ``(2, 2)``, ``"True"`` -> ``True``); lists become
    tuples; anything else passes through."""
    if not isinstance(value, str):
        if isinstance(value, list):
            return tuple(coerce_param(v) for v in value)
        return value
    s = value.strip()
    if s in _BOOL_STRINGS:
        return _BOOL_STRINGS[s]
    if s in ("None", "none", "null"):
        return None
    try:
        v = ast.literal_eval(s)
        if isinstance(v, list):
            v = tuple(v)
        return v
    except (ValueError, SyntaxError):
        return s


def hashable_params(params: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    """An op's kwargs as a sorted, hashable tuple of (name, value)."""
    out = []
    for k in sorted(params):
        v = coerce_param(params[k])
        if isinstance(v, list):
            v = tuple(v)
        elif isinstance(v, dict):
            v = tuple(sorted(v.items()))
        out.append((k, v))
    return tuple(out)


# ---------------------------------------------------------------------------
# dtypes: MXNet spells them as numpy dtypes, python types or strings
# ---------------------------------------------------------------------------

_NP_TO_TORCH = {np.dtype(k): v for k, v in (
    ("float16", torch.float16), ("float32", torch.float32),
    ("float64", torch.float64), ("int8", torch.int8), ("uint8", torch.uint8),
    ("int16", torch.int16), ("int32", torch.int32), ("int64", torch.int64),
    ("bool", torch.bool))}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}
_PY_DTYPES = {float: torch.float32, int: torch.int32, bool: torch.bool}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for an MXNet dtype spelling; ``None`` is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype in _PY_DTYPES:
        return _PY_DTYPES[dtype]
    if str(dtype) == "bfloat16" or getattr(dtype, "__name__", "") == \
            "bfloat16":
        return torch.bfloat16
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


def numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype; bfloat16 (which numpy lacks)
    stays ``torch.bfloat16``."""
    return _TORCH_TO_NP.get(dtype, dtype)
