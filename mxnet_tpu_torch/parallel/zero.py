"""ZeRO-1 sharded optimizer state (ref: the JAX package's
``parallel/zero.py``; Rajbhandari et al., PAPERS.md).

The optimizer state (momentum, Adam's moments, the f32 masters of
``multi_precision``) is partitioned across the data-parallel ranks, so
each rank holds about 1/N of it, with no change to the math. Each step:

1. **reduce-scatter**: ``Trainer.allreduce_grads`` flattens the dense
   gradients into the same forward-order ``_gbkt*`` buckets the
   allreduce uses and issues one ``KVStore.zero_reduce_scatter`` a bucket;
   the reduced values land only in this rank's parameters' gradients
   (copied in place). The call runs under the store's retry and chaos
   hooks and mutates nothing, so a retried ``kv_flake`` never applies a
   shard update twice.
2. **shard update**: the grouped path (``optimizer/grouped.py``) steps
   only this rank's parameters, so their state is created here alone.
   The finiteness verdict is made global first: each rank reduces its
   shard's (already reduced) gradients to one flag, the flags are
   AND-reduced across the ranks (``KVStore.zero_all_finite``, a 0-d
   tensor that stays on the device), and that one verdict guards every
   shard (``grouped_update(sentinel_flag=...)``): a NaN anywhere skips
   the step everywhere, and ``rollback_step`` stays shard-local.
3. **allgather**: each rank sends its updated weight segments a bucket
   (``KVStore.zero_allgather``) and copies every other rank's into its
   parameters, in place.

The **partition** is parameter-granular and a pure function of
(parameter order, shapes, dtypes, world size): greedy byte balance in
index order, ties to the lowest rank. Every rank and every restart
derives the same shards, which keeps checkpoints **topology-portable**:
a save gathers the shards into the ordinary unsharded state dict
(:meth:`ZeroPlane.gather_states_bytes`, a collective), a restore loads
it and keeps the local slots; a ZeRO checkpoint restores unsharded and
at any world size.

**World size**: a real group (``kvstore.num_workers > 1``) shards across
its ranks. One worker can simulate N ranks with ``MXTPU_ZERO_WORLD=N``:
the process plays every rank in turn, with the N-rank partition,
collective pattern and trajectory, so the suites run on one CPU process.

Refused, raising instead of training unsharded: gradient compression
(its per-key residuals assume the allreduce layout; checked at creation
and every round), optimizers without a grouped rule, aggregation 0,
no kvstore, and a bare ``update()`` without the reduce-scatter before it.

**Overlap** (``MXTPU_COMM_OVERLAP=on``): ``Trainer.overlap_scope``
launches each bucket's reduce-scatter when its gradients are final
(:meth:`launch_bucket_rs`, the copies into the gradients wait for the
scope's finalize), and the update launches each bucket's allgather once
that bucket's shards are updated (:meth:`launch_allgather_bucket`, on the
card on the trainer's side stream), sealed before the update returns.
Same buckets, sums and collective count; only the launch points move.

Distributed contracts: between ``allreduce_grads()`` and ``update()``
only this rank's gradients hold reduced values (code that reads the
whole gradient set in that window, such as global-norm clipping, must
run unsharded); checkpoint saves are collective, every rank saves at the
same step (``fit.FitLoop`` does).
"""
from __future__ import annotations

import functools
import pickle
from typing import Dict, List, Set

import torch

from ..base import MXNetError, check, env, env_switch

__all__ = ["zero_requested", "simulated_world", "partition", "ZeroPlane"]


def zero_requested() -> bool:
    """Strict ``MXTPU_ZERO`` parse: a typo'd request to shard must not
    silently train unsharded."""
    return env_switch("MXTPU_ZERO")


def simulated_world() -> int:
    """``MXTPU_ZERO_WORLD``: the simulated rank count of a one-worker run
    (0 / 1 = no simulation; a real group ignores it). Unparseable or
    negative values raise."""
    try:
        n = int(env.get("MXTPU_ZERO_WORLD"))
    except TypeError:
        n = 0
    except ValueError as e:
        raise MXNetError(
            f"MXTPU_ZERO_WORLD: not an integer: "
            f"{env.raw('MXTPU_ZERO_WORLD')!r}") from e
    if n < 0:
        raise MXNetError(f"MXTPU_ZERO_WORLD must be >= 0, got {n}")
    return n


def _param_bytes(p) -> int:
    n = 1
    for s in (p.shape or ()):
        n *= int(s)
    try:
        itemsize = torch.empty((), dtype=p.dtype).element_size()
    except TypeError:
        itemsize = 4
    return n * itemsize


def partition(params, world: int) -> List[int]:
    """Owner rank per parameter index: greedy byte balance in parameter
    order (each parameter goes to the currently lightest rank, ties to
    the lowest)."""
    check(world >= 1, "ZeRO world size must be >= 1")
    loads = [0] * world
    owners = []
    for p in params:
        r = min(range(world), key=lambda k: (loads[k], k))
        owners.append(r)
        loads[r] += _param_bytes(p)
    return owners


@functools.lru_cache(maxsize=1)
def _rs_counter():
    from ..telemetry import default_registry
    return default_registry().counter(
        "mxtpu_zero_reduce_scatter_collectives_total",
        "ZeRO-1 per-bucket gradient reduce-scatter collectives issued.")


@functools.lru_cache(maxsize=1)
def _ag_counter():
    from ..telemetry import default_registry
    return default_registry().counter(
        "mxtpu_zero_allgather_collectives_total",
        "ZeRO-1 per-bucket weight allgather collectives issued.")


def _grad(p):
    return p.data()._grad if p.tensor is not None and \
        p.grad_req != "null" else None


class ZeroPlane:
    """One Trainer's ZeRO-1 plane: the partition map and the
    reduce-scatter / shard update / allgather protocol. Made at the
    trainer's first use; a configuration that cannot shard raises
    here."""

    def __init__(self, trainer):
        kv = trainer._kvstore
        check(kv is not None,
              "MXTPU_ZERO=1 requires a kvstore (pass an explicit store "
              "object — the default 'device' string degrades to no store "
              "on a 1-device host); refusing to silently train unsharded")
        check(getattr(kv, "_compressor", None) is None,
              "MXTPU_ZERO=1 does not compose with gradient compression: "
              "per-key error-feedback residuals assume the allreduce "
              "wire layout, not reduce-scatter slices")
        from ..optimizer import grouped as _grouped
        check(_grouped.aggregation_size() > 0,
              "MXTPU_ZERO=1 requires MXTPU_OPTIMIZER_AGGREGATION > 0: the "
              "shard update IS the grouped donated-buffer path")
        updater = trainer._updaters[0]
        check(_grouped._rule_for(updater.optimizer) is not None,
              f"MXTPU_ZERO=1: optimizer "
              f"{type(updater.optimizer).__name__} has no grouped-update "
              "rule (ZeRO-1 shards state through the grouped path)")
        for p in trainer._params:
            check(p.stype == "default" and p.grad_stype == "default",
                  f"MXTPU_ZERO=1 requires dense parameters/gradients; "
                  f"{p.name!r} is sparse. Sparse tables shard through "
                  "the row-wise embedding plane instead "
                  "(MXTPU_SPARSE_PLANE=on + parallel.embedding_plane."
                  "EmbeddingPlane, state co-located with each rank's "
                  "rows): keep the table OUT of the Trainer and the two "
                  "planes compose in one loop — dense params ZeRO-"
                  "sharded, embedding rows plane-sharded")
        self._kv = kv
        nw = int(kv.num_workers)
        if nw > 1:
            self.world, self.my_ranks = nw, (int(kv.rank),)
            self.distributed = True
        else:
            self.world = simulated_world() or 1
            self.my_ranks = tuple(range(self.world))
            self.distributed = False
        self.owners = partition(trainer._params, self.world)
        self._my_set: Set[int] = {i for i, r in enumerate(self.owners)
                                  if r in set(self.my_ranks)}
        # the (key, bucket) layout of this comm round, made once by the
        # reduce-scatter and consumed by the allgather: the halves never
        # disagree
        self._step_layout = None
        # overlapped allgathers' completions still owed (flush_pending)
        self._pending_ag: List = []
        # shard-aware ledger owners ('state:zr<r>/<N>:<param>')
        updater._zero_shard = {i: f"{r}/{self.world}"
                               for i, r in enumerate(self.owners)}
        try:
            from ..telemetry import default_registry
            reg = default_registry()
            reg.gauge("mxtpu_zero_world_size",
                      "ZeRO-1 world size (ranks the optimizer state is "
                      "sharded across; 0 = ZeRO off).").set(self.world)
            reg.gauge("mxtpu_zero_shard_params",
                      "Parameters owned by this rank's ZeRO-1 shard "
                      "(rank my_ranks[0]).").set(
                sum(1 for r in self.owners if r == self.my_ranks[0]))
        except Exception:
            pass

    # -- membership ------------------------------------------------------
    def owner(self, index: int) -> int:
        return self.owners[index]

    def local_indices(self) -> Set[int]:
        """Indices whose optimizer state lives in this process (one
        rank's when distributed, every rank's in a simulation)."""
        return self._my_set

    def describe(self) -> Dict:
        return {"world": self.world, "ranks": list(self.my_ranks),
                "distributed": self.distributed,
                "params": len(self.owners),
                "shard_params": len(self._my_set)}

    def _bucket_layout(self, trainer):
        """The round's (key, bucket) list: the allreduce path's
        forward-order ``_gbkt*`` layout (``MXTPU_GRAD_BUCKET_MB=0``: one
        parameter a bucket)."""
        items = [(i, _grad(p)) for i, p in enumerate(trainer._params)
                 if _grad(p) is not None]
        bucket_mb = trainer._bucket_mb()
        if bucket_mb > 0:
            buckets = trainer._grad_buckets(items, bucket_mb)
        else:
            buckets = [[it] for it in items]
        return [(trainer._bucket_sig_key(bid, b)[1], b)
                for bid, b in enumerate(buckets)]

    def check_comm_round(self) -> None:
        """Compression may be turned on after the plane came up: the
        round refuses then."""
        check(getattr(self._kv, "_compressor", None) is None,
              "MXTPU_ZERO=1 does not compose with gradient compression "
              "(enabled after the first step): per-key error-feedback "
              "residuals assume the allreduce wire layout")

    def overlap_active(self, trainer) -> bool:
        """Whether this step's comm overlaps compute (read every step, as
        the autotuner probes the knob)."""
        from ..gluon.trainer import _overlap_requested
        return _overlap_requested() and bool(trainer._kvstore_arg)

    def take_step_layout(self, trainer):
        """The layout the round's reduce-scatter made (made again if
        none)."""
        layout, self._step_layout = self._step_layout, None
        return layout if layout is not None else \
            self._bucket_layout(trainer)

    # -- 1) the gradient reduce-scatter ------------------------------------
    def _bucket_parts(self, bucket):
        """``(parts, all_parts)`` of one bucket: the local ``(i, grad, lo,
        hi)`` segments, and every rank's ``[lo, hi)`` list in bucket order
        (the same on every rank)."""
        segs, off = [], 0
        for i, g in bucket:
            n = int(g.size)
            segs.append((i, g, off, off + n))
            off += n
        parts = [s for s in segs if s[0] in self._my_set]
        all_parts = [[(lo, hi) for i, _g, lo, hi in segs
                      if self.owners[i] == r] for r in range(self.world)]
        return parts, all_parts

    def launch_bucket_rs(self, trainer, key, bucket):
        """Flatten one bucket and issue its reduce-scatter; returns
        ``(parts, slices)`` for :meth:`finish_bucket_rs` (the overlap
        scope launches it from the backward thread, where the gradients
        must not be written yet)."""
        flat_nd = trainer._bucket_wire(key, bucket)
        parts, all_parts = self._bucket_parts(bucket)
        slices = self._kv.zero_reduce_scatter(
            key, flat_nd, [(lo, hi) for _, _, lo, hi in parts],
            all_parts=all_parts)
        return parts, slices

    @staticmethod
    def finish_bucket_rs(parts, slices) -> None:
        """Copy the reduced slices into the local gradients, in place."""
        with torch.no_grad():
            for (i, g, _lo, _hi), arr in zip(parts, slices):
                g._data.copy_(arr._data.view(g._data.shape))

    def reduce_scatter_grads(self, trainer) -> None:
        """One ``zero_reduce_scatter`` a bucket, the reduced slices copied
        into this rank's gradients (the others' are left as they are:
        their owners update them)."""
        self.check_comm_round()
        self.flush_pending()
        layout = self._bucket_layout(trainer)
        self._step_layout = layout
        for key, bucket in layout:
            self.finish_bucket_rs(*self.launch_bucket_rs(trainer, key,
                                                         bucket))
        trainer.last_reduce_scatter_collectives = len(layout)
        if layout:
            _rs_counter().inc(len(layout))

    # -- 2) the global sentinel ------------------------------------------
    def global_finite_flag(self, live):
        """The all-finite verdict of the whole model: one reduction over
        this rank's (reduced) shard gradients, AND-reduced across the
        ranks before any shard applies. A 0-d bool tensor on the
        device."""
        from ..optimizer import grouped as _grouped
        shard = [_grad(p)._data for i, p in live
                 if i in self._my_set and _grad(p) is not None]
        if shard:
            flag = _grouped.global_finite_flag(shard)
        else:
            flag = torch.tensor(True, device=live[0][1].tensor.device)
        if self.distributed:
            flag = self._kv.zero_all_finite(flag)
        return flag

    # -- 3) the weight allgather -------------------------------------------
    def _launch_bucket_ag(self, trainer, key, bucket):
        """One bucket's allgather: this process's ranks' updated weight
        segments out, rank -> flat tensor back."""
        from ..ndarray import ndarray as _nd
        from ..gluon.trainer import _flatten
        payloads = {}
        for r in self.my_ranks:
            segs = [trainer._params[i].tensor.detach()
                    for i, _ in bucket if self.owners[i] == r]
            with torch.no_grad():
                flat = _flatten(segs) if segs else \
                    bucket[0][1]._data.new_zeros(0)
            payloads[r] = _nd.NDArray(flat)
        sizes = [sum(int(g.size) for i, g in bucket if self.owners[i] == r)
                 for r in range(self.world)]
        return self._kv.zero_allgather(key, payloads, sizes=sizes)

    def _finish_bucket_ag(self, trainer, bucket, got) -> None:
        """Copy every other rank's updated weights into this process's
        parameters (a simulation has no other rank)."""
        my = set(self.my_ranks)
        with torch.no_grad():
            for r in range(self.world):
                if r in my:
                    continue
                payload, off = got[r], 0
                for i, _g in bucket:
                    if self.owners[i] != r:
                        continue
                    w = trainer._params[i].tensor
                    n = w.numel()
                    w.copy_(payload[off:off + n].view(w.shape))
                    off += n

    def launch_allgather_bucket(self, trainer, key, bucket) -> None:
        """Overlap: one bucket's allgather, launched once its shards are
        updated (on the card on the side stream, after the updates the
        compute stream queued); the copies complete at
        :meth:`seal_allgather`."""
        from ..gluon.trainer import _on_side
        with _on_side(bucket[0][1]._data):
            got = self._launch_bucket_ag(trainer, key, bucket)
            if self.distributed:
                self._pending_ag.append(
                    lambda: self._finish_bucket_ag(trainer, bucket, got))
        trainer.last_allgather_collectives += 1

    def seal_allgather(self, trainer) -> None:
        """Close the overlapped round: make the compute stream wait for
        the side stream's allgathers, then complete the copies."""
        if trainer._params and trainer._params[0].tensor is not None:
            from ..gluon.trainer import _join_side
            _join_side(trainer._params[0].tensor)
        self.flush_pending()
        if trainer.last_allgather_collectives:
            _ag_counter().inc(trainer.last_allgather_collectives)

    def flush_pending(self) -> None:
        """Complete every owed allgather copy."""
        pend, self._pending_ag = self._pending_ag, []
        for fin in pend:
            fin()

    def allgather_weights(self, trainer) -> None:
        """One allgather a bucket of the round's layout, every other
        rank's weights copied in. A simulation's call is an identity
        echo with the N-rank collective count and fault surface."""
        layout = self.take_step_layout(trainer)
        for key, bucket in layout:
            got = self._launch_bucket_ag(trainer, key, bucket)
            self._finish_bucket_ag(trainer, bucket, got)
        trainer.last_allgather_collectives = len(layout)
        if layout:
            _ag_counter().inc(len(layout))

    # -- topology-portable checkpoints -----------------------------------
    def gather_states_bytes(self, updater) -> bytes:
        """Gather-on-save: every rank's shard state merged into the
        ordinary unsharded pickle (a simulation holds the whole dict).
        Distributed: a collective, every rank calls it at the same
        step."""
        if not self.distributed:
            return updater.get_states(dump_optimizer=False)
        from .collectives import cross_process_exchange_bytes
        from ..optimizer.optimizer import Updater
        # only this rank's slots enter the merge: a stray one must not
        # overwrite its owner's fresher state
        local = updater.get_states(dump_optimizer=False,
                                   indices=self.local_indices())
        merged: Dict = {}
        counts: Dict = {}
        num_update = 0
        for b in cross_process_exchange_bytes(local, "zsv"):
            d = pickle.loads(b)
            # each blob carries its own indices' step counters: merge
            # them like the slots, or Adam's bias correction would drift
            # on resume
            counts.update(d.pop(Updater.COUNTS_KEY, {}))
            num_update = max(num_update,
                             int(d.pop(Updater.NUM_UPDATE_KEY, 0)))
            merged.update(d)
        merged[Updater.COUNTS_KEY] = counts
        merged[Updater.NUM_UPDATE_KEY] = num_update
        return pickle.dumps(merged)
