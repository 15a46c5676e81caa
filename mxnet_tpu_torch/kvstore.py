"""KVStore on one card (ref: include/mxnet/kvstore.h; the JAX package's
``kvstore.py``).

``create("local" | "device")`` (and the reference's other one-process
names) gives an in-process store: ``init`` copies a value per key,
``push`` sums a list of values (the CommDevice merge) and either writes
the sum into the stored value or hands it to the updater, ``pull`` copies
the stored value into the given arrays, in place. ``set_optimizer``
installs an ``Updater`` (the optimizer round-trips through pickle, as it
would to reach a server), and push then updates the stored weight in
place, as ``kvstore_dist_server.h`` ApplyUpdates does.

The port runs on one card in one process: ``num_devices`` and
``num_workers`` are 1, so ``gluon.Trainer`` drops a store it creates from
a name and updates directly. Not ported, each raising
``NotPortedError``: the ``dist_*`` stores and gradient compression
(ROADMAP A10), ``row_sparse_pull`` (A11).

Each key's push or pull runs under a bounded retry: a
:class:`TransientKVError` is retried with exponential backoff
(``MXNET_KV_RETRY_MAX``, ``MXNET_KV_RETRY_BASE_MS``), anything else
propagates. An installed chaos plan (``contrib/chaos.py``) may fail an
attempt (``kv_flake``) or delay it (``kv_slow``) at that entry, before the
key's store is touched, so a retry never applies an update twice.
"""
from __future__ import annotations

import pickle
import time
from typing import Any, Dict, List

import torch

from .base import MXNetError, check, env
from .ndarray import ndarray as _nd
from .ops.registry import NotPortedError

__all__ = ["KVStore", "KVStoreBase", "KVStoreLocal", "KVStoreDevice",
           "TransientKVError", "create"]


class TransientKVError(MXNetError):
    """A push/pull failed in a way that is safe to retry (a network flake,
    a peer mid-rejoin). push/pull retry with exponential backoff up to
    ``MXNET_KV_RETRY_MAX`` attempts before giving up."""


def _retry_op(what: str, fn):
    """Bounded retry with exponential backoff around one key's push or
    pull. Only :class:`TransientKVError` is retried; the failure points
    precede that key's store mutation, so a retry never applies an
    update twice."""
    max_retries = int(env.get("MXNET_KV_RETRY_MAX"))
    base = float(env.get("MXNET_KV_RETRY_BASE_MS")) / 1000.0
    attempt = 0
    while True:
        try:
            return fn()
        except TransientKVError as e:
            attempt += 1
            # retries are rare by construction: the registry lookup is
            # off the happy path
            from .telemetry import default_registry
            default_registry().counter(
                "mxtpu_kv_retries_total",
                "kvstore push/pull retries after TransientKVError.",
                label="op").inc(label_value=what)
            if attempt > max_retries:
                raise MXNetError(
                    f"kvstore {what} still failing after {max_retries} "
                    f"retries: {e}") from e
            time.sleep(base * (2 ** (attempt - 1)))


def _chaos_kv(op: str, key) -> None:
    """The chaos plan's kvstore entry: kv_flake may raise, kv_slow
    sleeps (the flake first, so a failed attempt costs only the
    backoff)."""
    from .contrib import chaos
    plan = chaos.active()
    if plan is not None:
        plan.kv_maybe_fail(op, key)
        delay = plan.kv_delay_s()
        if delay > 0.0:
            time.sleep(delay)


def _group(keys, values):
    """Normalize (key(s), value(s)) into [(key, [vals...])]
    (ref: KVStoreLocal::GroupKVPairs)."""
    if isinstance(keys, (list, tuple)):
        check(len(keys) == len(values), "key/value count mismatch")
        out = []
        for k, v in zip(keys, values):
            out.extend(_group(k, v))
        return out
    if isinstance(values, (list, tuple)):
        return [(keys, list(values))]
    return [(keys, [values])]


def _key_int(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


class KVStoreBase:
    """Common surface (ref: include/mxnet/kvstore.h)."""

    def __init__(self):
        self._store: Dict[Any, _nd.NDArray] = {}
        self._updater = None
        self._optimizer = None

    # -- identity -------------------------------------------------------
    @property
    def type(self) -> str:
        raise NotImplementedError

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    @property
    def num_devices(self) -> int:
        return 1

    # -- core ops -------------------------------------------------------
    def init(self, key, value) -> None:
        for k, vals in _group(key, value):
            if k in self._store:
                continue
            v = vals[0]
            self._store[k] = v.copy() if isinstance(v, _nd.NDArray) \
                else _nd.array(v)

    @staticmethod
    def _merge(vals: List[_nd.NDArray]) -> _nd.NDArray:
        """Sum the pushed values on the first one's device (ref:
        CommDevice::Reduce)."""
        if len(vals) == 1:
            return vals[0]
        dev = vals[0]._data.device
        with torch.no_grad():
            total = vals[0]._data.clone()
            for v in vals[1:]:
                total.add_(v._data.to(dev))
        return _nd.NDArray(total)

    def push(self, key, value, priority: int = 0) -> None:
        for k, vals in _group(key, value):
            _retry_op("push", lambda k=k, vals=vals: self._push_one(k, vals))

    def _push_one(self, k, vals) -> None:
        _chaos_kv("push", k)
        check(k in self._store, f"kvstore key {k} not initialized")
        for v in vals:
            if getattr(v, "stype", "default") != "default":
                raise NotPortedError(
                    "row-sparse pushes are not ported yet (ROADMAP.md, "
                    "queue A11)")
        merged = self._merge(vals)
        store = self._store[k]
        if self._updater is not None:
            self._updater(_key_int(k), merged, store)
        else:
            with torch.no_grad():
                store._data.copy_(merged._data.to(store._data.device))

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse: bool = True) -> None:
        check(out is not None, "pull requires out=")
        for k, outs in _group(key, out):
            _retry_op("pull", lambda k=k, outs=outs: self._pull_one(k, outs))

    def _pull_one(self, k, outs) -> None:
        _chaos_kv("pull", k)
        check(k in self._store, f"kvstore key {k} not initialized")
        src = self._store[k]._data
        for o in outs:
            with torch.no_grad():
                o._data.copy_(src.to(o._data.device))

    def pushpull(self, key, value, out=None, priority: int = 0) -> None:
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority: int = 0,
                        row_ids=None) -> None:
        raise NotPortedError("kvstore.row_sparse_pull is not ported yet "
                             "(ROADMAP.md, queue A11)")

    # -- optimizer / updater -------------------------------------------
    def set_updater(self, updater) -> None:
        self._updater = updater

    def set_optimizer(self, optimizer) -> None:
        """Install the optimizer 'on the server' (ref: MXKVStoreSetUpdater
        and the pickled-optimizer command): here the server is this
        process, and push updates the stored weights in place."""
        from . import optimizer as opt_mod
        optimizer = pickle.loads(pickle.dumps(optimizer))
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    def set_gradient_compression(self, compression_params) -> None:
        raise NotPortedError("gradient compression is not ported yet "
                             "(ROADMAP.md, queue A10)")

    def save_optimizer_states(self, fname, dump_optimizer=False) -> None:
        check(self._updater is not None, "no optimizer set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname) -> None:
        check(self._updater is not None, "no optimizer set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self) -> None:
        """One worker: nothing to wait for."""


class KVStoreLocal(KVStoreBase):
    """In-process store (ref: src/kvstore/kvstore_local.h:69)."""

    def __init__(self, contexts=None):
        super().__init__()

    @property
    def type(self):
        return "local"


class KVStoreDevice(KVStoreLocal):
    """Device-resident merge (ref: CommDevice; the NCCL type folds in
    here)."""

    @property
    def type(self):
        return "device"


KVStore = KVStoreBase  # surface alias (ref: python/mxnet/kvstore.py KVStore)

_TYPES = {
    "local": KVStoreLocal,
    "local_update_cpu": KVStoreLocal,
    "local_allreduce_cpu": KVStoreLocal,
    "device": KVStoreDevice,
    "local_allreduce_device": KVStoreDevice,
    "nccl": KVStoreDevice,
}
_DIST = ("dist", "dist_sync", "dist_device_sync", "dist_sync_device",
         "dist_async", "dist_tpu_sync")


def create(name: str = "local") -> KVStoreBase:
    """String factory (ref: src/kvstore/kvstore.cc:40-75)."""
    check(isinstance(name, str), "kvstore name must be a string")
    key = name.lower()
    if key in _DIST:
        raise NotPortedError(
            f"kvstore {name!r}: distributed stores are not ported yet "
            "(ROADMAP.md, queue A10)")
    if key not in _TYPES:
        raise MXNetError(f"unknown KVStore type {name!r}")
    return _TYPES[key]()
