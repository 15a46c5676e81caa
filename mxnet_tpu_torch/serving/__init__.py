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
- :mod:`.registry` — ``ModelRegistry``: versioned on-disk artifact store
  (SHA-256 manifests, atomic CURRENT pointer, quarantine + fallback; the
  JAX package's layout file for file).
- :mod:`.fleet` — ``FleetServer``/``Fleet``: registry-driven replicas
  with atomic hot-swap deploys and rolling fleet-wide rollouts.
- :mod:`.aot` — cold start: the kernel-build cache
  (``enable_compile_cache``), the runtime fingerprint, signature replay;
  the AOT signature bundles are ``CachedOp.aot_export`` / ``aot_load``.
- :mod:`.router` — the process-level fleet: ``ReplicaEndpoint`` (socket
  front-end of one replica process), ``FleetRouter`` (least-loaded
  dispatch, retry-on-death, rolling deploy over processes).
- :mod:`.autoscale` — pure ``decide()`` scaling ladder + the
  ``Autoscaler`` executor (``MXTPU_FLEET_MIN/MAX/TARGET_QUEUE``).
- :mod:`.lookup` — the embedding lookup tier over a published
  ``EmbeddingPlane`` sidecar.
- :mod:`.serve_fleet` — ``python -m mxnet_tpu_torch.serving.serve_fleet``:
  the fleet launcher and the replica process.

Quick start::

    server = serving.ModelServer(net, bucket_shapes=[(3, 224, 224)])
    server.warmup()
    fut = server.submit(image)          # -> PredictionFuture
    probs = fut.result(timeout=1.0)
    print(server.metrics_text())        # Prometheus exposition

Fleet quick start (registry-driven, hot-swappable)::

    reg = serving.ModelRegistry()           # MXTPU_SERVE_REGISTRY
    v1 = reg.publish("resnet", net=net,
                     signature={"bucket_shapes": [[224, 224, 3]]})
    server = serving.FleetServer(reg, "resnet").start()
    ...
    v2 = reg.publish("resnet", net=new_net, signature=...)
    server.publish_aot(version=v2)          # v2 deploys with zero misses
    server.deploy(v2)                       # warm in bg, atomic flip
    server.rollback()                       # one-call escape hatch
"""
from .aot import (ReplayLog, enable_compile_cache,  # noqa: F401
                  fingerprint_token, runtime_fingerprint, warm_from_replay)
from .autoscale import Autoscaler, decide  # noqa: F401
from .batcher import (Batch, BucketTable, DeadlineExceeded,  # noqa: F401
                      NoBucket, PredictionFuture, QueueFull, Request,
                      ServerClosed, ServingError, batch_buckets, pad_rows)
from .cache import SignatureCache  # noqa: F401
from .fleet import DeployReport, Fleet, FleetServer  # noqa: F401
from .lookup import (LookupFleet, LookupReplica,  # noqa: F401
                     publish_embedding)
from .metrics import ServerMetrics  # noqa: F401
from .registry import (ModelRegistry, RegistryCorruptError,  # noqa: F401
                       ResolvedVersion)
from .router import (FleetRouter, ReplicaClient,  # noqa: F401
                     ReplicaDead, ReplicaEndpoint, RouterFuture,
                     replica_main)
from .server import ActiveModel, ModelServer  # noqa: F401

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
