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

__all__ = ["MXNetError", "check", "EnvRegistry", "env", "env_switch",
           "coerce_param",
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

    def set(self, name: str, value: Optional[str]) -> None:
        """Write the environment string (None unsets it): the one writer,
        for a tuner that probes a knob and restores it."""
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = str(value)

    def default_for(self, name: str) -> Any:
        """The declared default (None for an undeclared name)."""
        decl = self._defaults.get(name)
        return decl[1] if decl is not None else None

    def items(self):
        for name, (typ, default, doc) in sorted(self._defaults.items()):
            yield name, typ, self.get(name), doc


env = EnvRegistry()

# the flags the port reads, with the JAX package's types, defaults and docs
env.declare("MXNET_ENFORCE_DETERMINISM", bool, False,
            "Restrict to deterministic algorithms.")
env.declare("MXNET_SAFE_ACCUMULATION", bool, False,
            "Accumulate f16/bf16 reductions (sum/mean/prod/norm) in f32.")
env.declare("MXNET_RESID_DTYPE", str, "",
            "Store backward activation residuals 8-bit (fp8|e4m3|e5m2). "
            "Conv dx stays exact (needs only weights); conv dW, BN "
            "grads/dx (via fp8 xhat) and ReLU masks see small zero-mean "
            "rounding (ops/resid8.py). Not ported yet: the port raises "
            "when it is set.")
env.declare("MXNET_BACKWARD_DO_MIRROR", bool, False,
            "Trade compute for memory in backward: recompute activations "
            "(torch.utils.checkpoint) instead of storing them.")
env.declare("MXNET_BACKWARD_MIRROR_POLICY", str, "full",
            "Remat policy when mirroring: full (save nothing) | dots "
            "(save matmul results, recompute elementwise ops) | convs "
            "(save convolution and matmul results).")
env.declare("MXTPU_FUSED_EPILOGUE", bool, True,
            "Route the fused conv-epilogue ops (BatchNorm(+add)+ReLU) "
            "through the hand-written CUDA kernels (their plain PyTorch "
            "versions on the CPU). Set 0 to fall back to the composed "
            "unfused lowering. Read at every call; a CUDA graph keeps the "
            "value it read at capture.")
env.declare("MXTPU_OPTIMIZER_AGGREGATION", int, 4,
            "Multi-tensor optimizer aggregation: gluon.Trainer groups dense "
            "parameters into dtype/device buckets of up to this many and "
            "steps each bucket with one multi-tensor call (ref: the "
            "reference's MXNET_OPTIMIZER_AGGREGATION_SIZE, default 4). 0 "
            "disables (per-parameter updates).")
env.declare("MXTPU_GRAD_BUCKET_MB", float, 25.0,
            "Gradient-allreduce bucketing: same-dtype dense gradients in "
            "flat buffers of at most this many MB, one push/pull each. "
            "0: one push/pull per key. Flat buckets of several gradients "
            "are not ported yet (raise); a single gradient takes its own "
            "key.")
env.declare("MXTPU_COMM_OVERLAP", str, "off",
            "Overlap gradient communication with backward ('on'/'off'). "
            "Not ported yet: 'on' raises in Trainer.overlap_scope. Unknown "
            "values raise.")
env.declare("MXTPU_MEGASTEP", str, "off",
            "One-graph training step ('on'/'off'): FitLoop runs forward, "
            "backward, sentinel and grouped update as one CUDA graph "
            "replay per input signature (megastep.py). Unknown values "
            "raise.")
env.declare("MXTPU_CACHEDOP_CACHE_SIZE", int, 256,
            "LRU bound on a per-signature cache of captured programs "
            "(cached_op.SignatureLRU; the megastep's CUDA graphs). 0 = "
            "unbounded.")
env.declare("MXTPU_ZERO", str, "off",
            "ZeRO-1 sharded optimizer state ('on'/'off'). Not ported yet: "
            "'on' raises when a gluon.Trainer is built. Unknown values "
            "raise.")
env.declare("MXTPU_NUMERICS", str, "",
            "In-graph numerics observability plane ('on[,every=N]...'). "
            "Not ported yet: a value other than empty/off raises when a "
            "gluon.Trainer is built.")
env.declare("MXNET_IS_RECOVERY", bool, False,
            "Set by the relauncher on restarted nodes; read by "
            "mx.fault.is_recovery().")
env.declare("DMLC_RANK", int, 0,
            "Launcher-assigned rank; names this worker's heartbeat file "
            "in mx.fault.")
env.declare("MXTPU_WORKER_ID", int, 0,
            "This process's rank; stamps telemetry trace events.")
env.declare("MXTPU_CHAOS", str, "",
            "Deterministic fault-injection plan for resilience testing, "
            "e.g. 'nan_grad@12,kill@40,ckpt_corrupt@latest,kv_flake:0.2' "
            "(contrib/chaos.py grammar; hooks in trainer/kvstore/fault).")
env.declare("MXTPU_CHAOS_SEED", int, 0,
            "Seed for the chaos plan's RNG (kv_flake rolls) so injected "
            "failure sequences replay identically.")
env.declare("MXNET_KV_RETRY_MAX", int, 3,
            "Bounded retries (exponential backoff) around kvstore "
            "push/pull on TransientKVError before giving up.")
env.declare("MXNET_KV_RETRY_BASE_MS", float, 50.0,
            "Backoff base for kvstore push/pull retries: attempt n sleeps "
            "base * 2**(n-1) milliseconds.")
env.declare("MXTPU_RESUMABLE_EXIT_CODE", int, 75,
            "Exit code FitLoop uses after a SIGTERM/SIGINT-triggered final "
            "checkpoint (default 75 = EX_TEMPFAIL), so the relauncher can "
            "tell 'resume me' from a real failure.")
env.declare("MXTPU_PROFILE", str, "",
            "Telemetry tracer spec, applied at import: comma-separated "
            "tokens 'on'|'off'|'ring=N'|'cat=a|b'|'file=PATH' (see "
            "telemetry.tracer). Empty = tracing off.")
env.declare("MXTPU_PROFILE_BOUND_FRAC", float, 0.4,
            "Step-breakdown detector threshold: any non-compute segment "
            "whose share of wall-clock step time reaches this fraction "
            "logs a one-line input-bound/comm-bound diagnosis. <=0 "
            "disables the detector.")
env.declare("MXTPU_MEM_BUDGET", int, 0,
            "Device-memory budget in bytes for the live-byte ledger "
            "(telemetry/memory.py). When > 0, fit.FitLoop checks the "
            "per-step ledger watermark against it and writes a ranked "
            "memory-forensics dump on the first step that exceeds it. 0 "
            "disables the budget check.")
env.declare("MXTPU_MEM_DUMP_DIR", str, "",
            "Directory memory-forensics dumps are written to "
            "(mem_forensics_<pid>_<n>.json). Empty = the current working "
            "directory.")
env.declare("MXTPU_EFFICIENCY", str, "",
            "Efficiency/goodput plane ('on'/'off'). Not ported yet: 'on' "
            "raises when FitLoop.fit starts. Unknown tokens raise.")
env.declare("MXTPU_AUTOTUNE", str, "off",
            "Telemetry-driven knob autotuner. Not ported yet: a spec that "
            "turns it on raises when FitLoop.fit starts.")
env.declare("MXTPU_RUN_REPORT_DIR", str, "",
            "Directory for FitLoop's persistent run report. Not ported "
            "yet: a non-empty value raises when FitLoop.fit starts.")
env.declare("MXTPU_COLL_HEALTH", int, 0,
            "Cross-rank comm-health cadence in steps. Not ported yet: a "
            "value > 0 raises when FitLoop.fit starts; unparseable values "
            "raise.")
env.declare("MXTPU_COLL_TIMEOUT_S", float, 0.0,
            "Hung-collective watchdog timeout in seconds. Not ported yet: "
            "a value > 0 raises when FitLoop.fit starts; unparseable values "
            "raise.")
env.declare("MXTPU_ZERO_WORLD", int, 0,
            "Simulated ZeRO-1 world size. Not ported yet: a value > 1 "
            "raises where the topology is read (parallel/elastic.py).")
env.declare("MXTPU_ELASTIC", str, "off",
            "Elastic world-size resume ('on'/'off'): a checkpoint whose "
            "recorded world differs from this process's raises "
            "elastic.TopologyMismatchError with 'off'; with 'on' the "
            "resize needs a process group, which is not ported yet "
            "(raises). Unknown values raise.")

env.declare("MXNET_HOME", str, "",
            "Root directory for datasets and model artifacts "
            "(default ~/.mxnet; ref: docs/faq/env_var.md MXNET_HOME).")


def data_dir() -> str:
    """Dataset / model root: ``$MXNET_HOME``, else ``~/.mxnet`` (ref:
    python/mxnet/base.py data_dir)."""
    return env.get("MXNET_HOME") or os.path.join(
        os.path.expanduser("~"), ".mxnet")


def env_switch(name: str) -> bool:
    """A strict on/off flag, parsed as the JAX package parses its switches
    (``MXTPU_ZERO``, ``MXTPU_MEGASTEP``, ``MXTPU_ELASTIC`` ...): unset,
    "", "0", "off", "false" are off, "1", "on", "true" on, anything else
    raises."""
    raw = str(env.get(name) or "").strip().lower()
    if raw in ("", "0", "off", "false"):
        return False
    if raw in ("1", "on", "true"):
        return True
    raise MXNetError(f"{name}: unknown value {raw!r} (known: on, off)")


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
    ("uint16", torch.uint16), ("uint32", torch.uint32), ("bool", torch.bool))}
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
