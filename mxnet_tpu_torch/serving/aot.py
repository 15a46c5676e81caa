"""Cold start for serving replicas (ref: the JAX package's
``serving/aot.py``).

The JAX package's answer to cold start is three layers that make a new
replica compile nothing. On the card a compiled XLA executable has two
counterparts, and only one of them can be kept on disk:

1. **Persistent kernel-build cache** (:func:`enable_compile_cache`): the
   hand-written kernels are nvcc builds keyed by a hash of their source
   and flags (``ops/_build.py``); pointing the build directory at a
   shared cache directory (namespaced by :func:`fingerprint_token`) makes
   a fresh replica load what an earlier process built: zero nvcc runs.
2. **AOT signature bundles** (``CachedOp.aot_export`` / ``aot_load``): a
   CUDA graph is bound to its process and cannot be saved, so the bundle
   holds each warm inference signature (its cache key, input and output
   structure) with the runtime fingerprint and a format number.
   ``aot_load`` installs those entries and captures their graphs at load
   time, before the replica reports ready: after it, warm-up and the
   first requests make zero signature-cache misses. The captures are
   the cost that stays (counted as ``mxtpu_compile_total{kind=
   "graph_capture"}`` and timed in the ``DeployReport``).
3. **Signature replay** (:class:`ReplayLog`): production shape traffic is
   recorded (one line per distinct signature, ``MXTPU_SERVE_REPLAY``) and
   :func:`warm_from_replay` prewarms a cache from it — the signatures
   real traffic exercises, not just the configured closure.

:func:`runtime_fingerprint` names the runtime a bundle is valid within
(torch, CUDA and the card, where the JAX package names jax, jaxlib and
the backend).
"""
from __future__ import annotations

import json
import os
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from ..base import env
from ..log import get_logger

__all__ = ["enable_compile_cache", "fingerprint_token",
           "runtime_fingerprint", "ReplayLog", "warm_from_replay"]

_LOG = get_logger("mxnet_tpu_torch.serving.aot")


def runtime_fingerprint() -> dict:
    """The runtime identity captured programs are only valid within."""
    card = "none"
    if torch.cuda.is_available():
        try:
            card = torch.cuda.get_device_name(0)
        except Exception:
            pass
    return {"torch": torch.__version__,
            "cuda": torch.version.cuda or "none", "device": card}


def fingerprint_token(fp: Optional[dict] = None) -> str:
    """Filesystem-safe string form of the fingerprint (cache subdir key)."""
    fp = fp or runtime_fingerprint()
    return "-".join(str(fp.get(k, "none")).replace("/", "_").replace(" ", "_")
                    for k in ("torch", "cuda", "device"))


def enable_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Point the kernel builds (``ops/_build.py``) at a persistent cache.

    Resolution order: explicit ``cache_dir`` > ``MXTPU_COMPILE_CACHE`` env.
    Returns the effective cache directory (``cache_dir`` namespaced by
    :func:`fingerprint_token`, so another torch, CUDA or card starts a
    fresh cache instead of colliding), or None when disabled (no dir
    configured, or ``0`` / ``off``). Every nvcc library is keyed by a hash
    of its source and flags, so a process that finds it there loads it
    and builds nothing. An explicit directory is honoured on the CPU
    too, so the cold-start contract is testable there (no kernel is
    built on the CPU). NVRTC compiles user kernels of ``mx.rtc`` at run
    time and is not cached; no serving path calls it.
    """
    if cache_dir is None:
        cache_dir = env.get("MXTPU_COMPILE_CACHE")
    if not cache_dir or str(cache_dir).lower() in ("0", "off", "disabled",
                                                   "none"):
        return None
    from ..ops import _build
    effective = os.path.join(str(cache_dir), fingerprint_token())
    os.makedirs(effective, exist_ok=True)
    _build.set_build_dir(effective)
    _LOG.info("persistent kernel-build cache at %s", effective)
    return effective


class ReplayLog:
    """Append-only record of the serving signatures real traffic hit.

    One JSON line per *distinct* (item shape, dtype, padded batch)
    signature — the file is a set, not a stream, so it stays tiny and a
    prewarm replays each signature once. Thread-safe (serving workers
    record concurrently); recording an already-seen signature is one set
    lookup, no IO.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._seen: set = set()
        # resume the dedup set from an existing file so restarts append
        # only genuinely new signatures
        for shape, dtype, batch in self.signatures(path):
            self._seen.add((shape, dtype, batch))

    def record(self, item_shape: Sequence[int], dtype: str,
               batch: int) -> bool:
        """Record one dispatched signature; returns True when it was new
        (and therefore appended to the file)."""
        key = (tuple(int(s) for s in item_shape), str(dtype), int(batch))
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            try:
                os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                            exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(json.dumps({"shape": list(key[0]),
                                        "dtype": key[1],
                                        "batch": key[2]}) + "\n")
            except OSError as e:
                _LOG.warning("replay log %s unwritable: %s", self.path, e)
        return True

    @staticmethod
    def signatures(path: str) -> List[Tuple[Tuple[int, ...], str, int]]:
        """Parse a replay file into (item_shape, dtype, batch) tuples
        (deduplicated, file order). Unparseable lines are skipped — a
        torn tail write must not take down a prewarm."""
        out: List[Tuple[Tuple[int, ...], str, int]] = []
        seen = set()
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        key = (tuple(int(s) for s in rec["shape"]),
                               str(rec["dtype"]), int(rec["batch"]))
                    except (ValueError, KeyError, TypeError):
                        continue
                    if key not in seen:
                        seen.add(key)
                        out.append(key)
        except OSError:
            pass
        return out


def warm_from_replay(cache, path: str, signatures=None) -> int:
    """Prewarm a :class:`~mxnet_tpu_torch.serving.cache.SignatureCache`
    from a replay file: every recorded (shape, dtype, batch) signature is
    driven once. Returns the number of signatures built (0 when the cache
    already held the traffic's). Pass ``signatures`` when the caller
    already parsed the file."""
    import numpy as np
    before = cache.cache_info().misses
    if signatures is None:
        signatures = ReplayLog.signatures(path)
    for shape, dtype, batch in signatures:
        out = cache(cache.batch(np.zeros((batch,) + shape,
                                         np.dtype(dtype))))
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for o in outs:
            o.asnumpy()
    return cache.cache_info().misses - before
