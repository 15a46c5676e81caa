"""mxnet_tpu_torch.serving — the in-process inference server (ref: the
JAX package's ``serving/``).

Dynamic batching over a closed signature set, with each signature one
CUDA graph of the block's ``CachedOp`` on the card:

- :mod:`.batcher` — bucketing/padding policy + typed admission errors
  (``QueueFull``, ``DeadlineExceeded``, ``NoBucket``, ``ServerClosed``).
- :mod:`.cache` — ``SignatureCache``: warm CachedOp graphs per
  (item shape, batch bucket), LRU-bounded, counted.
- :mod:`.server` — ``ModelServer``: worker threads, bounded admission,
  deadlines, SIGTERM drain with the resumable exit code.
- :mod:`.metrics` — ``ServerMetrics``: latency/batch/queue histograms,
  Prometheus text + JSON export, profiler spans per dispatch.
- :mod:`.aot` — the runtime fingerprint and signature replay.

Quick start::

    server = serving.ModelServer(net, bucket_shapes=[(3, 224, 224)])
    server.warmup()
    fut = server.submit(image)          # -> PredictionFuture
    probs = fut.result(timeout=1.0)
    print(server.metrics_text())        # Prometheus exposition

Not ported yet, raising ``NotPortedError`` when used: the serving fleet
(``ModelRegistry``, ``FleetServer`` / ``Fleet``, ``FleetRouter`` and its
replica processes, ``Autoscaler`` / ``decide``, ``enable_compile_cache``;
ROADMAP A23, after ``symbol/``) and the embedding lookup fleet
(``LookupFleet``, ``LookupReplica``, ``publish_embedding``; ROADMAP A23
too: it publishes through ``ModelRegistry`` and ``net.export`` and loads
through ``SymbolBlock.imports``).
"""
from ..ops.registry import NotPortedError
from .aot import ReplayLog, runtime_fingerprint, warm_from_replay
from .batcher import (Batch, BucketTable, DeadlineExceeded,  # noqa: F401
                      NoBucket, PredictionFuture, QueueFull, Request,
                      ServerClosed, ServingError, batch_buckets, pad_rows)
from .cache import SignatureCache
from .metrics import ServerMetrics
from .server import ActiveModel, ModelServer

_FLEET = "the serving fleet, not ported yet (ROADMAP.md, queue A23)"
_LOOKUP = ("the sparse embedding lookup fleet, not ported yet (ROADMAP.md, "
           "queue A23)")


def _class(name: str, what: str):
    """A class that raises ``NotPortedError`` when built."""
    def __init__(self, *_args, **_kwargs):
        raise NotPortedError(f"serving.{name} is part of {what}")
    return type(name, (), {"__init__": __init__,
                           "__doc__": f"Not ported: part of {what}."})


def _function(name: str, what: str):
    """A function that raises ``NotPortedError`` when called."""
    def fn(*_args, **_kwargs):
        raise NotPortedError(f"serving.{name} is part of {what}")
    fn.__name__ = name
    fn.__doc__ = f"Not ported: part of {what}."
    return fn


ModelRegistry = _class("ModelRegistry", _FLEET)
ResolvedVersion = _class("ResolvedVersion", _FLEET)
RegistryCorruptError = _class("RegistryCorruptError", _FLEET)
FleetServer = _class("FleetServer", _FLEET)
Fleet = _class("Fleet", _FLEET)
DeployReport = _class("DeployReport", _FLEET)
FleetRouter = _class("FleetRouter", _FLEET)
ReplicaEndpoint = _class("ReplicaEndpoint", _FLEET)
ReplicaClient = _class("ReplicaClient", _FLEET)
ReplicaDead = _class("ReplicaDead", _FLEET)
RouterFuture = _class("RouterFuture", _FLEET)
Autoscaler = _class("Autoscaler", _FLEET)
replica_main = _function("replica_main", _FLEET)
decide = _function("decide", _FLEET)
enable_compile_cache = _function("enable_compile_cache", _FLEET)
LookupFleet = _class("LookupFleet", _LOOKUP)
LookupReplica = _class("LookupReplica", _LOOKUP)
publish_embedding = _function("publish_embedding", _LOOKUP)

__all__ = ["ModelServer", "SignatureCache", "ServerMetrics", "ServingError",
           "QueueFull", "DeadlineExceeded", "NoBucket", "ServerClosed",
           "PredictionFuture", "BucketTable", "batch_buckets", "pad_rows",
           "ModelRegistry", "ResolvedVersion", "RegistryCorruptError",
           "FleetServer", "Fleet", "DeployReport", "ActiveModel",
           "ReplayLog", "enable_compile_cache", "runtime_fingerprint",
           "warm_from_replay", "FleetRouter", "ReplicaEndpoint",
           "ReplicaClient", "ReplicaDead", "RouterFuture", "replica_main",
           "Autoscaler", "decide", "LookupFleet", "LookupReplica",
           "publish_embedding"]
