"""Fleet serving: registry-driven replicas with atomic hot-swap (ref: the
JAX package's ``serving/fleet.py``).

Layered on :class:`~mxnet_tpu_torch.serving.server.ModelServer` and the
:class:`~mxnet_tpu_torch.serving.registry.ModelRegistry`: a
:class:`FleetServer` is one replica that *deploys versions* instead of
holding a model forever, and a :class:`Fleet` is N replicas behind one
``submit()`` with rolling deploys.

Hot-swap protocol (``FleetServer.deploy``), the zero-downtime contract:

1. **Resolve + verify**: the requested version is content-verified
   against its SHA-256 manifest (corrupt -> quarantine + fallback when
   following CURRENT).
2. **Load + warm in the background**: the new version's SymbolBlock and
   :class:`SignatureCache` are built while the OLD version keeps serving
   every request. Warmup is layered cheapest-first: the AOT bundle
   published with the version (its signatures installed and their CUDA
   graphs captured: zero signature-cache misses after it), then the
   replica's batch buckets, then the version's replay file; a signature
   none of them covered is captured as a miss. The kernel builds read
   the persistent cache (``enable_compile_cache``): a fresh replica runs
   no nvcc.
3. **Atomic flip**: one reference assignment under the server's admission
   lock. Every batch dispatch captures (active model, dispatch seq) under
   the same lock, so the stream of response version tags is monotone —
   no request is served by a half-warmed model, none by a mix.
4. **Drain**: the deployer waits for batches in flight against the old
   version to finish before declaring the deploy done (the old
   graphs stay alive exactly as long as a worker still uses them).

On the card a replica's cold start is restated from the JAX package's
"zero compiles": ``DeployReport["compiles"]`` keeps the JAX meaning
(signature-cache misses during the warm-up: 0 once the AOT bundle
covers the signature set), and the graph captures that a CUDA graph
cannot avoid are reported beside it (``captures``, ``capture_ms``).
Loading goes through ``SymbolBlock.imports`` on the replica's context
(its ``ctx``, by default the context current when it was built): a
replica on the card's default context with no card raises.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..log import get_logger
from .aot import ReplayLog, enable_compile_cache, warm_from_replay
from .cache import SignatureCache
from .registry import (AOT_NAME, REPLAY_NAME, ModelRegistry,
                       ResolvedVersion)
from .server import ActiveModel, ModelServer

__all__ = ["FleetServer", "Fleet", "DeployReport"]

_LOG = get_logger("mxnet_tpu_torch.serving.fleet")


def _metrics():
    from ..telemetry import default_registry
    reg = default_registry()
    return (reg.counter("mxtpu_serve_deploys_total",
                        "Completed FleetServer hot-swap deploys.",
                        label="model"),
            reg.counter("mxtpu_serve_deploy_compiles_total",
                        "Signature-cache misses paid during deploy "
                        "warmups (0 = the AOT bundle covered the whole "
                        "signature set)."),
            reg.gauge("mxtpu_serve_warm_seconds",
                      "Background load+warm wall-clock of the most "
                      "recent deploy (the old version served "
                      "throughout)."),
            reg.gauge("mxtpu_serve_swap_drain_seconds",
                      "Old-version drain wall-clock of the most recent "
                      "deploy (in-flight batches finishing after the "
                      "flip)."))


class DeployReport(dict):
    """Dict-shaped deploy summary (keys: model, version, previous,
    compiles, aot_loaded, warmed_signatures, captures, capture_ms, warm_s,
    drain_s). ``compiles`` counts signature-cache misses during the
    warm-up; ``captures`` / ``capture_ms`` the CUDA graphs captured for
    the version (the AOT bundle's at load, and the misses'), 0 on the
    CPU."""
    __getattr__ = dict.__getitem__


def _no_warm() -> Dict[str, float]:
    return {"aot_loaded": 0, "warmed_signatures": 0, "compiles": 0,
            "captures": 0, "capture_ms": 0.0}


class FleetServer(ModelServer):
    """A registry-attached serving replica with atomic hot-swap.

    ``FleetServer(registry, "resnet")`` resolves the model's CURRENT
    version, warms it (AOT bundle / replica buckets / replay) and serves
    it; ``deploy()`` later swaps any other version in with zero dropped
    and zero mixed-version requests. All ModelServer policy knobs pass
    through. ``bucket_shapes`` defaults to the published signature set.
    ``ctx`` is where every version is loaded (default: the context
    current now; the card's unless a ``with mx.cpu():`` is open).
    """

    def __init__(self, registry: Optional[ModelRegistry], model: str,
                 version: str = "current", warm: bool = True, ctx=None,
                 **kwargs):
        self.registry = registry if registry is not None else ModelRegistry()
        self.model = model
        self.ctx = Context(ctx if ctx is not None else current_context())
        if self.ctx.device_type == "gpu" and not torch.cuda.is_available():
            raise MXNetError(
                f"FleetServer({model!r}): no CUDA card for {self.ctx}; "
                "serve on the host with ctx=mx.cpu() (or inside "
                "'with mx.cpu():')")
        # the zero-build cold-start contract is automatic for fleet
        # replicas: a configured MXTPU_COMPILE_CACHE is wired before the
        # first kernel is loaded
        enable_compile_cache()
        resolved = self.registry.resolve(model, version)
        sig = resolved.signature
        if "bucket_shapes" not in kwargs:
            shapes = sig.get("bucket_shapes")
            kwargs["bucket_shapes"] = ([tuple(s) for s in shapes]
                                       if shapes else None)
        if "dtype" not in kwargs and sig.get("dtype"):
            kwargs["dtype"] = sig["dtype"]
        kwargs.setdefault("name", model)
        net = self._load_net(resolved)
        super().__init__(net, **kwargs)
        self._active.version = resolved.version
        # exposed so process-level replicas (serving/router.py) can report
        # their cold-start compile bill (the 0-compile scale-up proof)
        self.cold_start_stats: Dict[str, float] = {}
        if warm:
            t0 = time.perf_counter()
            stats = self._warm_active(self._active, resolved)
            self.cold_start_stats = dict(stats)
            _LOG.info("fleet: %s/%s cold start warmed in %.2fs (%s)",
                      model, resolved.version,
                      time.perf_counter() - t0, stats)

    # -- internals --------------------------------------------------------
    def _load_net(self, resolved: ResolvedVersion):
        from ..gluon.block import SymbolBlock
        names = resolved.manifest.get("input_names") or ["data"]
        return SymbolBlock.imports(f"{resolved.prefix}-symbol.json",
                                   list(names),
                                   f"{resolved.prefix}-0000.params",
                                   ctx=self.ctx)

    def _warm_active(self, active: ActiveModel, resolved: ResolvedVersion
                     ) -> Dict[str, float]:
        """Warm one ActiveModel from the version's artifacts: AOT bundle
        first (its graphs captured at load), then drive every published +
        replayed signature through the cache (hits when the bundle
        covered them)."""
        from .. import profiler
        stats = _no_warm()
        t0 = time.perf_counter()
        aot = resolved.aot_path
        if aot and active.cache._op is not None:
            stats["aot_loaded"] = active.cache._op.aot_load(aot)
        before = active.cache.cache_info().misses
        sig = resolved.signature
        shapes = [tuple(s) for s in sig.get("bucket_shapes") or []]
        if shapes:
            # warm the REPLICA's batch buckets, not the published
            # batch_sizes: admission pads to this table's pow2 buckets,
            # so a published subset would leave hot-path signatures cold
            # after the flip (first coalesced batch pays a live compile)
            batch_sizes = self._table.batch_sizes
            dtype = sig.get("dtype", str(self.dtype))
            stats["warmed_signatures"] += len(shapes) * len(batch_sizes)
            active.cache.warmup(shapes, batch_sizes, dtype)
        replay = resolved.replay_path
        if replay:
            replay_sigs = ReplayLog.signatures(replay)
            stats["warmed_signatures"] += len(replay_sigs)
            warm_from_replay(active.cache, replay, signatures=replay_sigs)
        stats["compiles"] = active.cache.cache_info().misses - before
        captured = active.cache.capture_ms()
        stats["captures"] = len(captured)
        stats["capture_ms"] = float(sum(captured.values()))
        profiler.record_span(
            f"deploy_warm[{self.model}]", "serving", t0,
            time.perf_counter(),
            args={"version": resolved.version or "", **stats})
        return stats

    # -- deploy / rollback ------------------------------------------------
    def deploy(self, version: str = "current", warm: bool = True,
               drain_timeout: float = 30.0) -> DeployReport:
        """Atomically swap the serving model to ``version``.

        Loads and warms the new version while the current one keeps
        serving, flips on one reference swap, then waits for in-flight
        batches against the old version to drain. Safe to call from any
        thread; concurrent deploys are serialized by last-flip-wins on
        the reference (run one deployer per replica)."""
        deploys, compile_ctr, warm_g, drain_g = _metrics()
        resolved = self.registry.resolve(self.model, version)
        old = self._active
        if resolved.version == old.version:
            _LOG.info("fleet: %s already serving %s — no-op deploy",
                      self.model, resolved.version)
            return DeployReport(model=self.model, version=resolved.version,
                                previous=old.version, **_no_warm(),
                                warm_s=0.0, drain_s=0.0)
        new_shapes = {tuple(s) for s in
                      resolved.signature.get("bucket_shapes") or []}
        if new_shapes and self._table.bucket_shapes is not None and \
                new_shapes != self._table.bucket_shapes:
            # admission policy (the bucket table) is fixed at replica
            # construction: a version that changes the shape closure
            # needs replica restarts (rolling), not a hot-swap
            _LOG.warning(
                "fleet: %s/%s publishes bucket_shapes %s but this replica "
                "admits %s — extra shapes will be warmed yet never "
                "admitted; restart replicas to change the closure",
                self.model, resolved.version, sorted(new_shapes),
                sorted(self._table.bucket_shapes))
        t0 = time.perf_counter()
        net = self._load_net(resolved)
        fresh = ActiveModel(SignatureCache(net, cache_size=self._cache_size),
                            resolved.version)
        stats = (self._warm_active(fresh, resolved) if warm
                 else _no_warm())
        warm_s = time.perf_counter() - t0
        # THE flip: one reference assignment under the admission lock —
        # the same lock every dispatch captures (active, seq) under
        with self._cond:
            self._active = fresh
        t1 = time.perf_counter()
        drained = old.drain(drain_timeout)
        drain_s = time.perf_counter() - t1
        if not drained:
            _LOG.warning("fleet: %s: old version %s still has %d batches "
                         "in flight after %.1fs drain budget", self.model,
                         old.version, old.inflight, drain_timeout)
        deploys.inc(label_value=self.model)
        compile_ctr.inc(stats["compiles"])
        warm_g.set(warm_s)
        drain_g.set(drain_s)
        from .. import profiler
        profiler.record_span(
            f"deploy_swap[{self.model}]", "serving", t1,
            time.perf_counter(),
            args={"from": old.version or "", "to": resolved.version or "",
                  "drained": bool(drained)})
        _LOG.info("fleet: %s deployed %s -> %s (warm %.2fs, %d misses, "
                  "%d captures, drain %.2fs)", self.model, old.version,
                  resolved.version, warm_s, stats["compiles"],
                  stats["captures"], drain_s)
        return DeployReport(model=self.model, version=resolved.version,
                            previous=old.version, **stats,
                            warm_s=warm_s, drain_s=drain_s)

    def rollback(self, version: Optional[str] = None) -> DeployReport:
        """Repoint the registry's CURRENT (previous version by default)
        and deploy it — the operator's one-call bad-deploy escape."""
        target = self.registry.rollback(self.model, version)
        return self.deploy(target)

    def publish_aot(self, version: Optional[str] = None) -> int:
        """Export this replica's warm signatures as the AOT bundle of
        ``version`` (default: the active version) — typically called once
        after the first replica warms, so every later replica cold-starts
        from the bundle with zero misses. Returns the number of
        signatures exported."""
        version = version or self._active.version
        if version is None:
            raise MXNetError("publish_aot: no version to attach to")
        op = self._active.cache._op
        if op is None:
            raise MXNetError("publish_aot: plain-callable models have no "
                             "captured signatures to export")
        import tempfile
        fd, tmp = tempfile.mkstemp(suffix=".aot.stage")
        os.close(fd)
        try:
            n = op.aot_export(tmp)
            self.registry.attach(self.model, version, AOT_NAME, tmp)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        return n

    def publish_replay(self, version: Optional[str] = None) -> Optional[str]:
        """Attach this replica's live replay log (``MXTPU_SERVE_REPLAY``)
        to ``version`` so new replicas prewarm from real traffic."""
        version = version or self._active.version
        if self._replay is None or version is None:
            return None
        if not os.path.exists(self._replay.path):
            return None
        self.registry.attach(self.model, version, REPLAY_NAME,
                             self._replay.path)
        return os.path.join(self.registry._version_dir(self.model, version),
                            REPLAY_NAME)


class Fleet:
    """N in-process replicas behind one ``submit()``: round-robin with
    shed-failover, rolling deploys, aggregated metrics.

    The in-process fleet is the *protocol* tier — the routing, rolling-
    deploy and drain semantics a multi-host fleet needs, testable on one
    machine. Each replica is a full :class:`FleetServer` (own batcher,
    workers, admission bound), so saturation behavior composes: a replica
    that sheds with ``QueueFull`` fails the request over to the next.
    """

    def __init__(self, registry: Optional[ModelRegistry], model: str,
                 replicas: int = 2, version: str = "current", **kwargs):
        if int(replicas) < 1:
            raise MXNetError("Fleet needs at least 1 replica")
        self.model = model
        self.registry = registry if registry is not None else ModelRegistry()
        self.replicas: List[FleetServer] = []
        for i in range(int(replicas)):
            kw = dict(kwargs)
            kw["name"] = f"{model}-r{i}"
            self.replicas.append(
                FleetServer(self.registry, model, version=version, **kw))
        self._rr = 0
        self._rr_lock = threading.Lock()

    def start(self) -> "Fleet":
        for r in self.replicas:
            r.start()
        return self

    def submit(self, x, deadline_ms: Optional[float] = None):
        """Route to the next replica (round-robin); a replica shedding
        with QueueFull fails over to the others before giving up."""
        from .batcher import QueueFull
        with self._rr_lock:
            start = self._rr
            self._rr = (self._rr + 1) % len(self.replicas)
        last_err: Optional[Exception] = None
        for i in range(len(self.replicas)):
            r = self.replicas[(start + i) % len(self.replicas)]
            try:
                return r.submit(x, deadline_ms=deadline_ms)
            except QueueFull as e:
                last_err = e
        raise last_err  # every replica saturated: shed to the client

    def predict(self, x, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None):
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    def deploy(self, version: str = "current",
               drain_timeout: float = 30.0) -> List[DeployReport]:
        """Rolling deploy: replicas swap one at a time, each finishing
        its warm+flip+drain before the next starts — at most one replica
        is warming at any moment, the rest serve at full capacity."""
        return [r.deploy(version, drain_timeout=drain_timeout)
                for r in self.replicas]

    def versions(self) -> List[Optional[str]]:
        return [r.active_version for r in self.replicas]

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        for r in self.replicas:
            r.stop(drain=drain, timeout=timeout)

    def metrics_json(self) -> dict:
        return {r.name: r.metrics_json() for r in self.replicas}
