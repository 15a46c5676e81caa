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

    def snapshot(self) -> Dict[str, str]:
        """A copy of the whole environment, for a child process's."""
        return dict(os.environ)

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
            "rounding (ops/resid8.py).")
env.declare("MXNET_CONV_COMPUTE", str, "",
            "Set to 'int8' to run training convolutions int8 "
            "(static activation range + per-channel weight scales; "
            "int8 x int8 -> int32 products, exact dx against the weights; "
            "ops/resid8.py conv_int8_train).")
env.declare("MXNET_CONV_INT8_RANGE", float, 8.0,
            "Symmetric activation clip range for MXNET_CONV_COMPUTE=int8 "
            "(post-BN/ReLU activations are O(1); widen if a model clips).")
env.declare("MXNET_BACKWARD_DO_MIRROR", bool, False,
            "Trade compute for memory in backward: recompute activations "
            "(torch.utils.checkpoint) instead of storing them.")
env.declare("MXNET_BACKWARD_MIRROR_POLICY", str, "full",
            "Remat policy when mirroring: full (save nothing) | dots "
            "(save matmul results, recompute elementwise ops) | convs "
            "(save convolution and matmul results).")
env.declare("MXNET_UPDATE_ON_KVSTORE", bool, True,
            "Run optimizer update inside the kvstore when supported.")
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
            "Gradient-allreduce bucketing: Trainer.allreduce_grads "
            "concatenates same-dtype dense gradients in parameter order "
            "into flat buffers of at most this many MB and issues one "
            "kvstore push/pull (one collective) per bucket; the ZeRO "
            "plane reduce-scatters the same buckets. 0: one push/pull "
            "per key.")
env.declare("MXTPU_COMM_OVERLAP", str, "off",
            "Overlap gradient communication with backward ('on'/'off'): "
            "inside Trainer.overlap_scope() each bucket's collective is "
            "launched, on a side CUDA stream, once its gradients are "
            "final; under MXTPU_ZERO the weight allgathers follow each "
            "bucket's shard update. Unknown values raise.")
env.declare("MXTPU_MEGASTEP", str, "off",
            "One-graph training step ('on'/'off'): FitLoop runs forward, "
            "backward, sentinel and grouped update as one CUDA graph "
            "replay per input signature (megastep.py). Unknown values "
            "raise.")
env.declare("MXNET_EXEC_BULK_EXEC_INFERENCE", bool, True,
            "Run a hybridized block's inference calls through its CachedOp "
            "(one CUDA graph replay per signature on a card). 0 runs them "
            "op by op.")
env.declare("MXNET_EXEC_BULK_EXEC_TRAIN", bool, True,
            "Run a hybridized block's training calls through its CachedOp "
            "(one forward and one backward CUDA graph replay per "
            "signature on a card). 0 runs them op by op.")
env.declare("MXTPU_CACHEDOP_CACHE_SIZE", int, 256,
            "LRU bound on a per-signature cache of captured programs "
            "(cached_op.SignatureLRU: CachedOp's CUDA graphs, the "
            "megastep's). 0 = unbounded. CachedOp.cache_info() reports "
            "hits/misses/evictions.")
env.declare("MXTPU_SERVE_MAX_BATCH", int, 32,
            "serving.ModelServer: maximum coalesced batch size per "
            "dispatch; also the largest batch-padding bucket.")
env.declare("MXTPU_SERVE_MAX_LATENCY_MS", float, 5.0,
            "serving.ModelServer: maximum time a request may wait in its "
            "shape bucket before the batch is flushed partially full.")
env.declare("MXTPU_SERVE_QUEUE_DEPTH", int, 256,
            "serving.ModelServer: bounded admission-queue depth; a full "
            "queue sheds load with a typed QueueFull rejection "
            "(backpressure) instead of buffering without bound.")
env.declare("MXTPU_SERVE_REGISTRY", str, "",
            "Root directory of the versioned model registry "
            "(serving.ModelRegistry): registry/<model>/<version>/ holding "
            "exported artifacts + SHA-256 manifests + an atomic CURRENT "
            "pointer. Empty = <cwd>/registry.")
env.declare("MXTPU_COMPILE_CACHE", str, "",
            "Persistent kernel-build cache directory: "
            "serving.enable_compile_cache points the nvcc builds "
            "(ops/_build.py) at it, namespaced by the torch / CUDA / card "
            "fingerprint, so a replica restart builds nothing. '0'/'off' "
            "disables.")
env.declare("MXTPU_FLEET_MIN", int, 1,
            "serving fleet (serving/autoscale.py): lower bound on live "
            "replica processes; the autoscaler never drains below it. "
            ">= 1.")
env.declare("MXTPU_FLEET_MAX", int, 4,
            "serving fleet: upper bound on replica processes; sustained "
            "queue pressure scales up to (never past) it. >= "
            "MXTPU_FLEET_MIN.")
env.declare("MXTPU_FLEET_TARGET_QUEUE", int, 16,
            "serving fleet: per-replica queue-depth target; mean depth "
            "above it for consecutive autoscaler ticks is scale-up "
            "pressure (serving.autoscale.decide).")
env.declare("MXTPU_FLEET_HEARTBEAT_MS", float, 200.0,
            "serving fleet router: interval between metrics-heartbeat "
            "polls of each replica (queue depth / p95 / active version "
            "drive least-loaded routing and the version floor).")
env.declare("MXTPU_SERVE_REPLAY", str, "",
            "Signature-replay file: when set, ModelServer appends one "
            "JSON line per distinct dispatched (item shape, dtype, padded "
            "batch) signature; serving.warm_from_replay prewarms a "
            "cache from it.")
env.declare("MXTPU_ZERO", str, "off",
            "ZeRO-1 sharded optimizer state ('on'/'off', "
            "parallel/zero.py): the gradient buckets are reduce-scattered, "
            "each rank steps only its parameter shard (optimizer state "
            "1/N a rank) and the updated weights are allgathered. Needs a "
            "kvstore object. Unknown values raise.")
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
            "Directory for FitLoop's persistent run report "
            "(telemetry/run_report.py); every rank of a group writes its "
            "own, stamped with the group's world size.")
env.declare("MXTPU_COLL_HEALTH", int, 0,
            "Cross-rank comm-health cadence (telemetry/collective.py): "
            "when N > 0, fit.FitLoop exchanges each rank's recent "
            "collective-ledger digest over the group every N steps, "
            "diagnoses a desynced collective order "
            "(mxtpu_coll_desync_total) and attributes per-rank entry-time "
            "skew (mxtpu_coll_skew_ms / mxtpu_coll_straggler_rank, "
            "FitResult.comm_health); the ledger records every collective. "
            "The exchange is itself a collective: every rank runs the "
            "same cadence. 0 (default) = off; unparseable values raise.")
env.declare("MXTPU_COLL_TIMEOUT_S", float, 0.0,
            "Hung-collective watchdog (telemetry/collective.py): when "
            "> 0, a watchdog thread is armed at every collective entry; a "
            "collective still in flight past this many seconds dumps a "
            "flight record (the ledger ring, the hung (kind, key, seq), "
            "the peer rank the arrival handshake waits on, all-thread "
            "stacks) to MXTPU_MEM_DUMP_DIR. 0 (default) disarms; arming "
            "also turns the ledger on. Unparseable values raise.")
env.declare("MXTPU_COLL_RING", int, 4096,
            "Collective-ledger ring capacity (telemetry/collective.py): "
            "bounded per-process ring of (seq, kind, key, bytes, rank, "
            "t_enter, t_exit) records, one per collective; evictions "
            "are counted, never silent. Must be >= 1.")
env.declare("MXTPU_SUPERVISE_MAX_RESTARTS", int, 8,
            "Fleet supervisor (parallel/supervisor.py, launch "
            "--supervise) restart budget: failure-driven relaunches "
            "(shrink/resume after a crash, hang, or resumable exit) "
            "beyond this fail the job loudly with a forensic bundle. "
            "Capacity-driven grow relaunches do not count.")
env.declare("MXTPU_SUPERVISE_CRASH_WINDOW_S", float, 300.0,
            "Fleet supervisor crash-loop window: crashes of the SAME "
            "rank slot within this many seconds count toward "
            "MXTPU_SUPERVISE_CRASH_LIMIT.")
env.declare("MXTPU_SUPERVISE_CRASH_LIMIT", int, 3,
            "Fleet supervisor crash-loop threshold: this many "
            "crash/signal deaths of the same rank slot within the "
            "window exclude the slot (the fleet continues smaller) "
            "instead of another same-size relaunch.")
env.declare("MXTPU_ZERO_WORLD", int, 0,
            "Simulated ZeRO-1 world size for single-worker runs: this "
            "process plays all N ranks in turn (the same partition, "
            "collective pattern and trajectory as a real N-rank group). "
            "0/1 = no simulation; ignored when kvstore.num_workers > 1. "
            "Unparseable values raise.")
env.declare("MXTPU_ELASTIC", str, "off",
            "Elastic world-size resume ('on'/'off'): a checkpoint whose "
            "recorded world differs from this process's raises "
            "elastic.TopologyMismatchError with 'off'; with 'on' FitLoop "
            "re-forms the group (a membership roster over the group), "
            "resets the comm planes, re-splits the data position and "
            "counts the resize. Unknown values raise.")

env.declare("MXTPU_COORDINATOR", str, "",
            "host:port of rank 0's TCPStore, set per worker by "
            "mxnet_tpu_torch.launch (alias: DMLC_PS_ROOT_URI and "
            "DMLC_PS_ROOT_PORT). Empty = single-process run "
            "(kvstore_server.init_distributed is a no-op).")
env.declare("MXTPU_NUM_WORKERS", int, 1,
            "Process count of the distributed group (alias: "
            "DMLC_NUM_WORKER).")
env.declare("MXTPU_WORKER_HOSTS", str, "",
            "Comma-separated worker hostnames in rank order (the "
            "launcher's placement): each rank's command-channel endpoint "
            "and which ranks share a host. Empty = loopback.")
env.declare("MXTPU_CMD_PORT_BASE", int, 0,
            "Base TCP port of the per-worker command channel (port = "
            "base + rank). 0 = the coordinator port + 100.")
env.declare("MXTPU_CMD_TOKEN", str, "",
            "Shared job token every worker command must carry (the "
            "launcher makes one per job). Empty = command endpoints bind "
            "loopback only.")
env.declare("MXTPU_COORD_TIMEOUT_MS", int, 120000,
            "Timeout of the distributed group (TCPStore and every "
            "collective), in milliseconds: a rank whose peer died fails "
            "after this long instead of hanging. Strict parse: > 0.")
env.declare("DMLC_ROLE", str, "worker",
            "Launcher-assigned process role (reference ps-lite parity); "
            "every process of the port is a worker.")

env.declare("MXNET_HOME", str, "",
            "Root directory for datasets and model artifacts "
            "(default ~/.mxnet; ref: docs/faq/env_var.md MXNET_HOME).")

# sparse storage (ndarray/sparse.py, parallel/embedding_plane.py)
env.declare("MXNET_STORAGE_FALLBACK_LOG_VERBOSE", bool, True,
            "Warn when an op without a sparse kernel densifies its inputs "
            "(storage fallback).")
env.declare("MXTPU_SPARSE_PLANE", str, "off",
            "Sparse embedding plane (parallel/embedding_plane.py): 'on' "
            "opts a row-sparse embedding table into the row-sharded "
            "plane (deduplicated gradient rows in a fixed (max_rows, dim) "
            "bucket, per-row optimizer state only on the rank owning the "
            "row, 1/world bytes a rank). Off (default): EmbeddingPlane "
            "refuses to build. Unknown values raise.")
env.declare("MXTPU_SPARSE_MAX_ROWS", int, 4096,
            "Sparse-plane bucket ceiling: touched-row counts are padded "
            "up to the next power of two, capped at this many rows a "
            "step. A minibatch touching more unique rows than the cap "
            "raises. Must be >= 1; unparseable values raise.")


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
