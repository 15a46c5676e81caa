"""Signature replay for serving (ref: the JAX package's
``serving/aot.py``, the part ``ModelServer`` uses).

- :func:`runtime_fingerprint`: the runtime a captured program is valid
  within (torch, CUDA and the card, where the JAX package names jax,
  jaxlib and the backend).
- :class:`ReplayLog`: production shape traffic is recorded (one line per
  distinct signature, ``MXTPU_SERVE_REPLAY``) and :func:`warm_from_replay`
  prewarms a cache from it — the signatures real traffic exercises, not
  just the configured closure.

The AOT half (``enable_compile_cache``, ``CachedOp.aot_export`` /
``aot_load``) serves the serving fleet and is not ported yet (ROADMAP
A23).
"""
from __future__ import annotations

import json
import os
import threading
from typing import List, Sequence, Tuple

import torch

from ..log import get_logger

__all__ = ["runtime_fingerprint", "ReplayLog", "warm_from_replay"]

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
