"""Embedding-lookup serving: the sparse plane's registry-driven path (ref:
the JAX package's ``serving/lookup.py``).

The reference's recommender serving story is a kvstore row_sparse pull
against the server fleet (``KVStore::PullRowSparse``): inference workers
fetch only the touched rows of a server-sharded table, then run the small
dense tower locally. This module is that path on the fleet/registry
machinery: a trained :class:`~mxnet_tpu_torch.parallel.embedding_plane.
EmbeddingPlane` publishes its shard set as a SIDECAR of the dense-tower
model version (the ``registry.attach`` integrity contract — the table is
manifest-hashed and verified on resolve like every artifact), and
replicas resolve the SAME version to answer both request kinds:

- **embedding-lookup**: ``lookup(ids) -> (batch, dim)`` rows, served
  through the plane's masked gather over the PER-RANK shard tensors as
  published, on the replica's device (the replica provably serves the
  sharded table, not a densified copy);
- **dense-tower**: the published HybridBlock, loaded via
  ``SymbolBlock.imports`` exactly like :class:`~mxnet_tpu_torch.serving.
  fleet.FleetServer` replicas load theirs.

:class:`LookupFleet` is the protocol tier (the ``fleet.Fleet``
discipline): N in-process replicas behind one round-robin ``lookup()``,
each replica a full resolve-verify-load of the registry version, so a
corrupt sidecar quarantines before a replica ever serves from it. Heavy
dense-tower traffic with batching/deadlines/hot-swap rides the existing
``FleetServer`` against the same version — the lookup path adds the one
request kind dense serving had no answer for. ``metrics_json`` reports
this path's closed-loop ``lookup_qps``.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import List, Optional

import numpy as _np
import torch

from ..base import MXNetError, check
from ..context import Context, current_context
from .registry import ModelRegistry, ResolvedVersion

__all__ = ["EMBEDDING_SIDECAR", "publish_embedding", "LookupReplica",
           "LookupFleet"]

#: sidecar file name inside a version dir (manifest-verified on resolve)
EMBEDDING_SIDECAR = "embedding.npz"


def publish_embedding(registry: ModelRegistry, model: str, plane, net,
                      signature: Optional[dict] = None,
                      metadata: Optional[dict] = None,
                      input_names=("data",)) -> str:
    """Publish one (dense tower, embedding table) version: the tower via
    the normal ``registry.publish`` artifact path, the plane's shard set
    attached as the :data:`EMBEDDING_SIDECAR` sidecar — ONE version, one
    manifest, so a replica can never serve a tower against the wrong
    table generation. Returns the version name."""
    meta = dict(metadata or {})
    meta["embedding"] = plane.describe()
    version = registry.publish(model, net=net, signature=signature,
                               metadata=meta, input_names=input_names)
    fd, tmp = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        plane.save_npz(tmp)
        registry.attach(model, version, EMBEDDING_SIDECAR, tmp)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return version


class LookupReplica:
    """One resolved version serving embedding-lookup + dense-tower
    requests. Loads the sidecar's per-rank shard arrays verbatim onto
    ``ctx`` (default: the context current now) and the tower via
    ``SymbolBlock.imports`` (the FleetServer loader)."""

    def __init__(self, registry: ModelRegistry, model: str,
                 version: str = "current", name: str = "lookup-r0",
                 ctx=None):
        self.name = name
        self.ctx = Context(ctx if ctx is not None else current_context())
        self.resolved: ResolvedVersion = registry.resolve(model, version)
        path = os.path.join(self.resolved.path, EMBEDDING_SIDECAR)
        if not os.path.exists(path):
            raise MXNetError(
                f"registry {model}/{self.resolved.version} has no "
                f"{EMBEDDING_SIDECAR} sidecar — publish the table with "
                "serving.lookup.publish_embedding")
        dev = self.ctx.torch_device
        with _np.load(path) as z:
            rows, dim, world = (int(v) for v in z["meta"])
            shards = [torch.from_numpy(z[f"shard_{r}"]).to(dev)
                      for r in range(world)]
        check(len(shards) == world and
              all(s.shape == (rows // world, dim) for s in shards),
              f"embedding sidecar of {model}/{self.resolved.version} is "
              "inconsistent with its layout meta")
        self.rows, self.dim, self.world = rows, dim, world
        self._shards = tuple(shards)
        self._net = None
        self.requests = 0
        self._lock = threading.Lock()

    # -- request kinds --------------------------------------------------
    def lookup(self, ids) -> _np.ndarray:
        """Embedding-lookup request: the touched rows, gathered through
        the plane's masked gather over the published shards."""
        from ..parallel.embedding_plane import masked_gather
        with self._lock:
            self.requests += 1
        ids_np = _np.asarray(ids, _np.int64).ravel()
        check(ids_np.size == 0 or
              (int(ids_np.min()) >= 0 and int(ids_np.max()) < self.rows),
              f"lookup ids outside [0, {self.rows})")
        return masked_gather(self._shards, ids_np).cpu().numpy()

    def dense_tower(self, x):
        """Dense-tower request: forward the published HybridBlock (lazy
        first load — lookup-only replicas never pay the import)."""
        from ..ndarray import NDArray
        if self._net is None:
            from ..gluon.block import SymbolBlock
            names = self.resolved.manifest.get("input_names") or ["data"]
            self._net = SymbolBlock.imports(
                f"{self.resolved.prefix}-symbol.json", list(names),
                f"{self.resolved.prefix}-0000.params", ctx=self.ctx)
        with self._lock:
            self.requests += 1
        data = x if isinstance(x, NDArray) else NDArray(
            torch.from_numpy(_np.ascontiguousarray(x)).to(
                self.ctx.torch_device))
        return self._net(data).asnumpy()

    def recommend(self, ids) -> _np.ndarray:
        """The combined recsys request: lookup, then tower, one hop."""
        return self.dense_tower(self.lookup(ids))


class LookupFleet:
    """N lookup replicas behind one round-robin ``lookup()`` — the
    ``Fleet`` routing discipline for the read-only lookup tier (no
    queues to shed: a lookup is one masked gather, the balance knob is
    replica count)."""

    def __init__(self, registry: Optional[ModelRegistry], model: str,
                 replicas: int = 2, version: str = "current", ctx=None):
        if int(replicas) < 1:
            raise MXNetError("LookupFleet needs at least 1 replica")
        registry = registry if registry is not None else ModelRegistry()
        self.model = model
        self.replicas: List[LookupReplica] = [
            LookupReplica(registry, model, version=version,
                          name=f"{model}-lookup-r{i}", ctx=ctx)
            for i in range(int(replicas))]
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _next(self) -> LookupReplica:
        with self._rr_lock:
            r = self.replicas[self._rr % len(self.replicas)]
            self._rr += 1
        return r

    def lookup(self, ids) -> _np.ndarray:
        return self._next().lookup(ids)

    def recommend(self, ids) -> _np.ndarray:
        return self._next().recommend(ids)

    def metrics_json(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        total = sum(r.requests for r in self.replicas)
        return {"replicas": len(self.replicas),
                "requests": total,
                "lookup_qps": total / dt,
                "per_replica": {r.name: r.requests
                                for r in self.replicas}}
