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

``create("dist_sync")`` (and ``dist``, ``dist_device_sync``,
``dist_sync_device``, ``dist_tpu_sync``; ``dist_async`` is the
documented synchronous emulation) gives :class:`KVStoreDistTPU`, a store
over the ``torch.distributed`` group that ``kvstore_server``
joined: ``rank`` / ``num_workers`` are the group's, ``init`` takes rank
0's value (the reference's servers hold rank 0's init), a push reduces
the merged value across the workers (``parallel/collectives.py``) before
it is stored or handed to the updater, and with gradient compression
only the packed 2-bit codes cross the wire (``gradient_compression.py``:
each worker's payload is gathered, decoded and summed in rank order). The
ZeRO-1 plane's collectives (``zero_reduce_scatter``, ``zero_allgather``,
``zero_all_finite``) and the worker command channel
(``send_command_to_servers``, ``send_profiler_command``) are its too.
Outside a group the dist store is one worker, like the local one.
Gradient compression on a one-worker store quantizes and dequantizes in
place of the wire (the numeric effect without the hop).

Row-sparse (ref: KVStore::PullRowSparse, CommCPU::ReduceRowSparse,
kvstore_dist_server.h DataHandleRowSparse): a push of row_sparse values
merges them into one compact value (the union of the rows, repeats
summed in a fixed order), which the updater applies lazily to those rows
(or, with no updater, replaces the stored value: the other rows read as
zero); no compression touches it. Across workers the merged rows ride the
dense reduce packed as ``[rows | row mask]`` (``sparse.mask_pack``), so
the reduced row set is the union over the workers, a row whose sum is
exactly zero included, as in the JAX package: ``rows x (width + 1)``
values on the wire whatever the touched rows (``last_rsp_wire_bytes``
against ``last_rsp_touched_bytes``; over gloo the pack is staged through
host memory explicitly). ``row_sparse_pull`` copies only the named rows.
One process holds one card, so the store never shards a table across
devices (the JAX package's big-array bound is not declared: it would
have nothing to split); a table sharded over a mesh of ranks is
``parallel.sharded_embedding``'s.

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

import numpy as _np
import torch

from .base import MXNetError, check, env
from .ndarray import ndarray as _nd
from .parallel import collectives as _coll
from .telemetry.tracer import tracer as _tracer

__all__ = ["KVStore", "KVStoreBase", "KVStoreLocal", "KVStoreDevice",
           "KVStoreDistTPU", "TransientKVError", "create"]


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


def _traced_retry(what: str, k, fn):
    """One key's op under retry, inside a ``kv_<op>:<key>`` comm span
    when the tracer records comm (one flag check when it does not), and
    one collective-ledger record when the comm plane is on
    (``telemetry/collective.py``): the record brackets the whole op,
    retries included, and arms the hung-collective watchdog."""
    from .telemetry import collective as _cl
    tok = _cl.enter(what, k, 0, _coll.rank()) if _cl.enabled() else None
    try:
        if _tracer.wants("comm"):
            with _tracer.span(f"kv_{what}:{k}", "comm"):
                return _retry_op(what, fn)
        return _retry_op(what, fn)
    finally:
        if tok is not None:
            _cl.exit_(tok)


def _chaos_kv(op: str, key) -> None:
    """The chaos plan's kvstore entry: kv_flake may raise, kv_slow
    sleeps (the flake first, so a failed attempt costs only the
    backoff), and ``kv_hang:<rank>@N[:MS]`` makes the named rank withhold
    its first exchange of step N for MS milliseconds (default 60 s):
    every peer then waits on it inside the collective, and their
    watchdogs name it."""
    from .contrib import chaos
    plan = chaos.active()
    if plan is not None:
        plan.kv_maybe_fail(op, key)
        delay = plan.kv_delay_s() + plan.kv_hang_delay_s(_coll.rank())
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
        self._compression_params = None
        self._compressor = None
        #: the last row_sparse push: bytes this rank put on the wire and
        #: bytes of the rows it touched
        self.last_rsp_wire_bytes = 0
        self.last_rsp_touched_bytes = 0

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
    def init(self, key, value, shard: bool = True) -> None:
        """Copy each key's value into the store. ``shard`` is the JAX
        package's big-array row-sharding opt-out; one card has nothing to
        shard across."""
        for k, vals in _group(key, value):
            if k in self._store:
                continue
            v = vals[0]
            self._store[k] = v.copy() if isinstance(v, _nd.NDArray) \
                else _nd.array(v)
            self._init_global(self._store[k])

    def _init_global(self, stored: _nd.NDArray) -> None:
        """A distributed store's init takes rank 0's value."""

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
            _traced_retry("push", k,
                          lambda k=k, vals=vals: self._push_one(k, vals))

    def _push_one(self, k, vals) -> None:
        _chaos_kv("push", k)
        check(k in self._store, f"kvstore key {k} not initialized")
        if any(getattr(v, "stype", "default") != "default" for v in vals):
            self._push_rsp(k, vals)
            return
        merged = self._merge(vals)
        if self._compressor is not None and not self._wire_compresses():
            # no wire hop (one worker): the compress / decompress round
            # trip with error feedback gives the numeric effect
            merged = _nd.NDArray(self._compressor.roundtrip(k, merged._data))
        store = self._store[k]
        if self._updater is not None:
            self._updater(_key_int(k), self._reduce_global(merged, k),
                          store)
        else:
            self._reduce_into(merged, k, store)

    def _push_rsp(self, k, vals) -> None:
        """A row_sparse push: merge, reduce across workers, then the lazy
        update of the merged rows (or a replace of the stored value)."""
        merged = self._reduce_global_rsp(self._merge_rsp(vals), k)
        store = self._store[k]
        if self._updater is not None:
            self._updater(_key_int(k), merged, store)
            return
        with torch.no_grad():
            store._data.zero_()
            store._data.index_copy_(0, merged._indices,
                                    merged._data.to(store._data.dtype))

    @staticmethod
    def _merge_rsp(vals):
        """The row_sparse sum of the pushed values (dense ones cast to
        row_sparse): the union of the rows, repeats summed."""
        from .ndarray import sparse as _sp
        vals = [v if isinstance(v, _sp.RowSparseNDArray)
                else _sp.cast_storage(v, "row_sparse") for v in vals]
        if len(vals) == 1:
            return vals[0]
        dev = vals[0]._data.device
        data = torch.cat([v._data.to(dev) for v in vals])
        if all(v._indices_np is not None for v in vals):
            ids = _np.concatenate([v._indices_np for v in vals])
        else:
            ids = torch.cat([v._indices.to(dev) for v in vals])
        return _sp.segment_sum_rows(data, ids, vals[0].shape)

    def _reduce_global_rsp(self, merged, key=None):
        """The merged row_sparse value summed across the workers (one
        worker: as it is)."""
        width = int(_np.prod(merged.shape[1:])) if len(merged.shape) > 1 \
            else 1
        self.last_rsp_touched_bytes = int(merged._data.shape[0]) * width * \
            merged._data.element_size()
        self.last_rsp_wire_bytes = 0
        return merged

    def _wire_compresses(self) -> bool:
        """True when ``_reduce_global`` itself moves the compressed
        payload (a distributed store), so the local round trip is
        skipped."""
        return False

    def _reduce_global(self, merged: _nd.NDArray, key=None) -> _nd.NDArray:
        """The merged value summed across the workers (one worker: as
        it is)."""
        return merged

    def _reduce_into(self, merged: _nd.NDArray, key, store) -> None:
        """Write the reduced ``merged`` into ``store`` in place."""
        with torch.no_grad():
            store._data.copy_(self._reduce_global(merged, key)._data
                              .to(store._data.device))

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse: bool = True) -> None:
        check(out is not None, "pull requires out=")
        for k, outs in _group(key, out):
            _traced_retry("pull", k,
                          lambda k=k, outs=outs: self._pull_one(k, outs))

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
        """Copy only the rows ``row_ids`` of the stored value (ref:
        KVStore::PullRowSparse): into a row_sparse ``out`` as its rows
        (ids as given), else into a dense ``out`` of that many rows."""
        check(out is not None and row_ids is not None,
              "row_sparse_pull requires out= and row_ids=")
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        rids = list(row_ids) if isinstance(row_ids, (list, tuple)) \
            else [row_ids] * len(outs)
        k = key[0] if isinstance(key, (list, tuple)) else key
        check(k in self._store, f"kvstore key {k} not initialized")
        src = self._store[k]._data
        for o, rid in zip(outs, rids):
            ids = rid._data if isinstance(rid, _nd.NDArray) \
                else torch.as_tensor(_np.asarray(rid))
            ids = ids.to(src.device, torch.int64).reshape(-1)
            rows = src.index_select(0, ids.clamp(0, src.shape[0] - 1))
            if getattr(o, "stype", "default") == "row_sparse":
                o._update(rows.to(o._data.device), ids.to(o._data.device))
            else:
                o._write(rows.to(o._data.device))

    def sparse_plane_exchange(self, key, ids, rows):
        """The embedding plane's gradient exchange (ref: the JAX package's
        ``sparse_plane_exchange``): the packed ``(max_rows,)`` ids and
        ``(max_rows, dim)`` deduplicated rows, under the same retry and
        chaos entry as a push. The plane plays every rank of its world in
        this process, so the local buffer already is the union and the
        exchange echoes it back (a pure read: a retried flake never
        applies twice), in every store as in the JAX package."""
        out: List = []

        def run():
            out.clear()
            _chaos_kv("push", key)
            out.extend((ids, rows))
        _traced_retry("push", key, run)
        return out[0], out[1]

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
        """(ref: mx.kv.set_gradient_compression, gradient_compression.cc)
        ``{'type': '2bit', 'threshold': t}``."""
        from .gradient_compression import GradientCompression
        params = dict(compression_params)
        self._compression_params = params
        self._compressor = GradientCompression(
            type=params.get("type", "2bit"),
            threshold=float(params.get("threshold", 0.5)))

    def save_optimizer_states(self, fname, dump_optimizer=False) -> None:
        check(self._updater is not None, "no optimizer set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname) -> None:
        check(self._updater is not None, "no optimizer set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self) -> None:
        """One worker: wait for the card's queued work."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    # -- ZeRO-1 plane ops (parallel/zero.py) ---------------------------
    # One retry scope and one chaos entry per bucket key, as push / pull
    # have: each is a pure read of its inputs (no store mutation), so a
    # retried kv_flake never applies a shard update twice.

    def zero_reduce_scatter(self, key, value, parts, all_parts=None):
        """Reduce the flat ``_gbkt`` wire buffer ``value`` across the
        workers and return the reduced ``[lo, hi)`` slices named by
        ``parts`` (this rank's segments) as NDArrays. ``all_parts``
        (every rank's segments) lets a distributed store run a true
        reduce-scatter. A one-worker store slices: its gradient already
        is the group's sum (a simulated world)."""
        out: List[_nd.NDArray] = []

        def run():
            out.clear()
            _chaos_kv("reduce_scatter", key)
            out.extend(self._zero_reduce_scatter_impl(key, value, parts,
                                                      all_parts))
        _traced_retry("reduce_scatter", key, run)
        return out

    def _zero_reduce_scatter_impl(self, key, value, parts, all_parts=None):
        data = value._data
        return [_nd.NDArray(data[lo:hi]) for lo, hi in parts]

    def zero_allgather(self, key, payloads, sizes=None):
        """Allgather one bucket's updated weight segments: ``payloads``
        maps rank -> flat NDArray (a real group gives its own rank's, a
        simulated world every rank's); ``sizes``, every rank's element
        count, saves the size exchange. Returns rank -> tensor for every
        rank (a one-worker store echoes the payloads)."""
        out: Dict[int, Any] = {}

        def run():
            out.clear()
            _chaos_kv("allgather", key)
            out.update(self._zero_allgather_impl(key, payloads, sizes))
        _traced_retry("allgather", key, run)
        return out

    def _zero_allgather_impl(self, key, payloads, sizes=None):
        return {r: v._data for r, v in payloads.items()}

    def zero_all_finite(self, ok):
        """AND of the shard-local all-finite verdict across the workers
        (one worker: as it is), before any shard applies. ``ok`` is a
        bool, or a 0-d bool tensor that stays on its device."""
        from .telemetry import collective as _cl
        tok = _cl.enter("all_finite", "_sentinel", 4, _coll.rank()) \
            if _cl.enabled() else None
        try:
            return self._zero_all_finite_impl(ok)
        finally:
            if tok is not None:
                _cl.exit_(tok)

    def _zero_all_finite_impl(self, ok):
        return ok

    def _send_command_to_servers(self, head, body) -> None:
        pass


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


class KVStoreDistTPU(KVStoreBase):
    """Synchronous data-parallel store over the ``torch.distributed``
    group (the JAX package's ``dist_tpu_sync``). Every process is a
    worker and reduction is a collective; there are no server
    processes (module docstring)."""

    def __init__(self, contexts=None):
        super().__init__()
        from .parallel import collectives as _coll
        self._nproc = _coll.world()
        self._rank = _coll.rank()
        self._last_wire_bytes = 0

    @property
    def type(self):
        return "dist_tpu_sync"

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._nproc

    def _init_global(self, stored: _nd.NDArray) -> None:
        if self._nproc > 1:
            import torch.distributed as dist
            dist.broadcast(stored._data, 0)

    def _wire_compresses(self) -> bool:
        return self._nproc > 1 and self._compressor is not None

    def _reduce_global(self, merged: _nd.NDArray, key=None) -> _nd.NDArray:
        if self._nproc <= 1:
            return merged
        from .parallel import collectives as _coll
        if self._compressor is not None:
            # the wire carries the packed 2-bit codes (n/4 bytes against
            # 4n); every worker's payload is decoded and summed in rank
            # order
            data = merged._data
            packed, nelem = self._compressor.compress_packed(key, data)
            gathered = _coll.cross_process_allgather(packed)
            self._last_wire_bytes = int(packed.numel())
            total = None
            for row in gathered:
                dec = self._compressor.decode_packed(row, nelem, data.shape,
                                                     data.dtype)
                total = dec if total is None else total + dec
            return _nd.NDArray(total)
        return _nd.NDArray(_coll.cross_process_allreduce(
            merged._data.clone()))

    def _reduce_global_rsp(self, merged, key=None):
        """Across the workers: the merged rows packed as ``[rows | row
        mask]`` (dense, ``rows x (width + 1)``), copied to host memory
        for gloo explicitly, summed, and unpacked to the union of the
        rows."""
        merged = super()._reduce_global_rsp(merged, key)
        if self._nproc <= 1:
            return merged
        from .ndarray import sparse as _sp
        packed = _sp.mask_pack(merged)._data
        dev = packed.device
        wire = packed.cpu() if (dev.type == "cuda" and
                                _coll.backend() == "gloo") else packed
        _coll.cross_process_allreduce(wire)
        self.last_rsp_wire_bytes = int(wire.numel() * wire.element_size())
        return _sp.mask_unpack(_nd.NDArray(wire.to(dev)), merged.shape)

    def _reduce_into(self, merged: _nd.NDArray, key, store) -> None:
        if self._nproc <= 1 or self._compressor is not None:
            super()._reduce_into(merged, key, store)
            return
        from .parallel import collectives as _coll
        with torch.no_grad():
            store._data.copy_(merged._data)
            _coll.cross_process_allreduce(store._data)

    def _zero_reduce_scatter_impl(self, key, value, parts, all_parts=None):
        if self._nproc <= 1:
            return super()._zero_reduce_scatter_impl(key, value, parts,
                                                     all_parts)
        from .parallel import collectives as _coll
        return [_nd.NDArray(t) for t in _coll.cross_process_reduce_scatter(
            value._data, parts, all_parts=all_parts)]

    def _zero_allgather_impl(self, key, payloads, sizes=None):
        if self._nproc <= 1:
            return super()._zero_allgather_impl(key, payloads, sizes)
        check(len(payloads) == 1,
              "distributed zero_allgather takes exactly this rank's "
              "payload")
        from .parallel import collectives as _coll
        ((_r, v),) = payloads.items()
        return dict(enumerate(_coll.cross_process_allgather_ragged(
            v._data, sizes)))

    def _zero_all_finite_impl(self, ok):
        if self._nproc <= 1:
            return ok
        from .parallel import collectives as _coll
        if isinstance(ok, torch.Tensor):
            t = ok.reshape(1).to(torch.float32)
            _coll.cross_process_allreduce(t, op="min")
            return t[0] > 0.5
        t = torch.tensor([1.0 if ok else 0.0])
        if _coll.backend() == "nccl":
            t = t.cuda()
        _coll.cross_process_allreduce(t, op="min")
        return bool(t.item() > 0.5)

    def barrier(self) -> None:
        from .parallel.collectives import barrier as _barrier
        _barrier()

    # -- worker command channel (ref: kvstore_dist.h SendCommandToServers,
    # the profiler commands of kvstore.h:49) ------------------------------
    def _send_command_to_servers(self, head, body) -> None:
        """A command to every worker's endpoint (the reference sends to
        server processes; here the workers are the servers)."""
        for r in range(self._nproc):
            self._command_rank(r, str(head), str(body))

    def _command_rank(self, r: int, head: str, body: str) -> str:
        """One command to rank r: in process for this rank, over the
        command channel for a peer."""
        from . import kvstore_server
        if r == self._rank:
            return kvstore_server._handle_command(head, body)
        return kvstore_server.send_command(r, head, body)

    def send_command_to_servers(self, head, body) -> None:
        """(ref: MXKVStoreSendCommmandToServers)"""
        self._send_command_to_servers(head, body)

    def send_profiler_command(self, cmd: str, body: str = "",
                              rank=None) -> list:
        """Remote-control the profiler of worker ``rank`` (default every
        worker): ``cmd`` in {set_config, state, pause, resume, dump,
        dumps}, the KVStoreServerProfilerCommand set. Returns the
        replies (``dump`` / ``dumps`` return the remote trace / table)."""
        check(cmd in ("set_config", "state", "pause", "resume", "dump",
                      "dumps"), f"unknown profiler command {cmd!r}")
        ranks = range(self._nproc) if rank is None else [int(rank)]
        return [self._command_rank(r, f"profiler.{cmd}", body)
                for r in ranks]


KVStore = KVStoreBase  # surface alias (ref: python/mxnet/kvstore.py KVStore)

_TYPES = {
    "local": KVStoreLocal,
    "local_update_cpu": KVStoreLocal,
    "local_allreduce_cpu": KVStoreLocal,
    "device": KVStoreDevice,
    "local_allreduce_device": KVStoreDevice,
    "nccl": KVStoreDevice,
    "dist": KVStoreDistTPU,
    "dist_sync": KVStoreDistTPU,
    "dist_device_sync": KVStoreDistTPU,
    "dist_sync_device": KVStoreDistTPU,
    "dist_async": KVStoreDistTPU,   # documented sync emulation
    "dist_tpu_sync": KVStoreDistTPU,
}


def create(name: str = "local") -> KVStoreBase:
    """String factory (ref: src/kvstore/kvstore.cc:40-75). A dist store
    registers itself as the profiler's command transport."""
    check(isinstance(name, str), "kvstore name must be a string")
    key = name.lower()
    if key not in _TYPES:
        raise MXNetError(f"unknown KVStore type {name!r}")
    kv = _TYPES[key]()
    if isinstance(kv, KVStoreDistTPU):
        from . import profiler
        profiler.set_kvstore_handle(kv)
    return kv
