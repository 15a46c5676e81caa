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
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List

import torch

from .base import MXNetError, check
from .ndarray import ndarray as _nd
from .ops.registry import NotPortedError

__all__ = ["KVStore", "KVStoreBase", "KVStoreLocal", "KVStoreDevice",
           "create"]


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
