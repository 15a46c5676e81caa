"""Gluon Trainer (ref: python/mxnet/gluon/trainer.py:27; the JAX
package's ``gluon/trainer.py``).

Applies an Optimizer to a set of Parameters after ``backward``:
``step(batch_size)`` sets ``rescale_grad = scale / batch_size``, reduces
the gradients across the workers through the kvstore and updates.
Parameters are ordered by name with numbers compared as numbers
(:func:`_natural_key`); indices, buckets and saved optimizer state follow
that order.

The update: dense parameters ride the aggregated path
(``optimizer/grouped.py``) in buckets of up to
``MXTPU_OPTIMIZER_AGGREGATION`` parameters, one multi-tensor call each;
others (an optimizer without a grouping rule, or aggregation 0) take the
per-parameter ``Updater`` loop. Both run the same update code and write
weights and states in place. ``last_update_dispatches`` counts the calls
of the last update (buckets, plus one for the sentinel's finiteness
reduction), and the metrics registry's
``mxtpu_update_dispatches_total`` their sum. On a ``MXTPU_NUMERICS``
sampled step the grouped buckets also compute their stats matrices,
parked un-fetched on ``last_numerics_stats`` for the caller's one
transfer (``fit.FitLoop``). Before any update, every live parameter's
gradient must be fresh (written by ``backward`` since the last step), or
nothing is applied and the step raises (``ignore_stale_grad=True`` skips
the stale ones). ``update_with_sentinel`` guards the update with one
on-device all-finite flag and returns it; ``rollback_step`` undoes the
host-side effects of a skipped step.

The kvstore. A store named by a string (``"device"``, the default, or
``"local"``) that serves one device and one worker is dropped (direct
updates); a dist store (``"dist_sync"``, a group of more than one
worker) or a store object is kept. With a store, ``allreduce_grads``
packs same-dtype gradients in parameter order into flat buckets of at
most ``MXTPU_GRAD_BUCKET_MB`` (the JAX package's ``_gbkt*`` keys: the
bucket's index, dtype, size, count and a digest of its shapes) and
issues one push and one pull a bucket (a lone gradient rides its own
key; 0 MB: one push / pull per key), then copies the reduced buffer back
into the gradients in place. ``last_allreduce_collectives`` counts the
collectives of the last call. A multi-worker store's initial values are
rank 0's: each trained parameter is pulled from the store when it is
created (running statistics stay each rank's own, as in MXNet).
``compression_params`` turns on the store's 2-bit compression
(``set_gradient_compression``, as the reference's Trainer does).
A parameter with a row_sparse gradient (``grad_stype``) rides no bucket:
its lazy update runs per parameter, and across workers its rows travel
as a dense ``[rows | row mask]`` push / pull of their own key, so the
reduced row set is the union over the workers.

ZeRO-1 (``MXTPU_ZERO=1``, ``parallel/zero.py``): the same buckets are
reduce-scattered instead, the grouped update steps only this rank's
parameters (their optimizer state lives on this rank alone) under the
verdict AND-reduced across the ranks, and the updated weights are
allgathered back (``last_reduce_scatter_collectives``,
``last_allgather_collectives``). ``get_states_bytes`` gathers the shards
into the unsharded format, so checkpoints restore at any world size.

Overlap (``MXTPU_COMM_OVERLAP=on``): the loop brackets ``backward`` in
:meth:`overlap_scope`, which hands every gradient to the scope as
autograd finalises it (``autograd.grad_ready_scope``); a bucket whose
gradients are all final launches its push / pull (under ZeRO its
reduce-scatter) at once, on the card on a side CUDA stream that waits
for the backward stream's event, and the next ``allreduce_grads`` only
launches the stragglers, makes the compute stream wait for the side
stream and copies the results back. Under ZeRO the update launches each
bucket's weight allgather once that bucket's shards are updated. Same
buckets, same sums, same collective count as without overlap.

An installed chaos plan (``contrib/chaos.py``, e.g. from
``MXTPU_CHAOS``) gets its step clock from ``step()`` (``_chaos_step``),
which also lets it poison a gradient (``nan_grad@N`` / ``inf_grad@N``);
``fit.FitLoop`` drives the clock itself and never calls ``step()``.

``megastep_plan`` is the host half of one megastep (``megastep.py``,
``MXTPU_MEGASTEP=on``): the bookkeeping the guarded update does between
its device calls, run outside the step's CUDA graph every step.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import re
from typing import Dict, List, Optional

import torch

from ..base import MXNetError, check, env
from ..base import env_switch as _switch
from .. import optimizer as opt_mod
from ..optimizer import grouped as _grouped
from ..telemetry import memory as _memory
from ..telemetry import numerics as _numerics
from ..telemetry.step_breakdown import segment as _bd_segment
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _overlap_requested() -> bool:
    """Strict ``MXTPU_COMM_OVERLAP`` parse: a typo'd request to overlap
    must not silently train without it."""
    return _switch("MXTPU_COMM_OVERLAP")


def _natural_key(name: str):
    """Numeric-aware sort key: ``dense9_weight`` < ``dense10_weight``, so
    structurally identical nets built at different name counters order
    their parameters alike (and restored optimizer state binds to the
    right ones)."""
    return [(1, int(t)) if t.isdigit() else (0, t)
            for t in re.split(r"(\d+)", name)]


@functools.lru_cache(maxsize=1)
def _update_dispatch_counter():
    from ..telemetry import default_registry
    return default_registry().counter(
        "mxtpu_update_dispatches_total",
        "Compiled-program launches per optimizer update "
        "(aggregated: one per dtype/device bucket).")


@functools.lru_cache(maxsize=1)
def _allreduce_counter():
    from ..telemetry import default_registry
    return default_registry().counter(
        "mxtpu_allreduce_collectives_total",
        "kvstore collectives issued by Trainer.allreduce_grads "
        "(bucketed: one per gradient bucket).")


def _flatten(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


#: the side CUDA stream of each card, for overlapped collectives
_SIDE: Dict[int, "torch.cuda.Stream"] = {}


def _side(t: torch.Tensor):
    """The side stream of ``t``'s card (made at first use), or None on
    the host."""
    if not t.is_cuda:
        return None
    s = _SIDE.get(t.device.index)
    if s is None:
        s = _SIDE[t.device.index] = torch.cuda.Stream(t.device)
    return s


@contextlib.contextmanager
def _on_side(t: torch.Tensor):
    """Run the block on the side stream, after everything the current
    stream has queued (the gradients it produced)."""
    side = _side(t)
    if side is None:
        yield
        return
    side.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(side):
        yield


def _join_side(t: torch.Tensor) -> None:
    """Make the current stream wait for the side stream's collectives."""
    side = _side(t)
    if side is not None:
        torch.cuda.current_stream(t.device).wait_stream(side)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[k] for k in sorted(params.keys(),
                                                key=_natural_key)]
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict/list of Parameter")
        _switch("MXTPU_ZERO")         # the strict parse: a typo raises
        _numerics.spec()
        self._params: List[Parameter] = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
            self._params.append(p)
        self._contains_sparse = any(p.stype != "default"
                                    for p in self._params)
        self._compression_params = compression_params
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_arg = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._chaos_step = 0  # step clock for env-driven chaos plans
        self.last_update_dispatches = 0
        self.last_allreduce_collectives = 0
        self.last_reduce_scatter_collectives = 0
        self.last_allgather_collectives = 0
        # numerics plane: the last sampled update's stats matrices,
        # [(param_names, (n, 6) device matrix)] per bucket, un-fetched
        self.last_numerics_stats = None
        # ZeRO-1 plane: None = not resolved yet, False = off, else the
        # parallel.zero.ZeroPlane; _zero_step carries it from the
        # reduce-scatter (allreduce_grads) to the update; _zero_declined
        # marks the one sanctioned unsharded fallback (a simulated world's
        # sentinel decline)
        self._zero = None
        self._zero_step = None
        self._zero_declined = False
        self._last_fused_indices: List[int] = []
        self._last_fused_created: List[int] = []
        # bucket keys already in the store (by the full key, so a layout
        # change makes a new key)
        self._bucket_keys: Dict[str, bool] = {}
        # the open overlap scope, consumed by the next allreduce_grads
        self._overlap_state: Optional["_OverlapScope"] = None

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: p for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt_mod.Optimizer):
            check(not optimizer_params,
                  "optimizer_params must be empty when an Optimizer instance "
                  "is passed")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             param_dict=param_dict,
                                             **optimizer_params)
        self._updaters = [opt_mod.get_updater(self._optimizer)]

    def _init_kvstore(self):
        """Lazy kvstore creation (ref: trainer.py:169). A store made from a
        name that serves one device and one worker is dropped; a dist
        store, or any store object, is kept."""
        if self._kvstore_arg and not isinstance(self._kvstore_arg, str):
            self._kvstore = self._kvstore_arg
        elif self._kvstore_arg:
            from .. import kvstore as kv_mod
            arg = str(self._kvstore_arg).lower()
            try:
                kv = kv_mod.create(self._kvstore_arg)
            except Exception as e:
                # only the default local / device store may give way to
                # direct updates: a dist store that fails to come up must
                # not turn a multi-worker run into one worker's
                if arg not in ("local", "device"):
                    raise MXNetError(
                        f"failed to create kvstore {self._kvstore_arg!r} "
                        "(refusing to fall back to local updates — a "
                        "misconfigured dist run would silently train "
                        f"single-device): {e}") from e
                kv = None
            self._kvstore = kv if kv is not None and (
                kv.num_devices > 1 or kv.num_workers > 1) else None
        self._kv_initialized = True
        kv = self._kvstore
        if kv is None:
            return
        if self._compression_params:
            kv.set_gradient_compression(self._compression_params)
        for i, p in enumerate(self._params):
            kv.init(i, p.data())
        if kv.num_workers > 1:
            # every worker starts from rank 0's values (the reference
            # pulls the servers' initial weights). Written through
            # ``.data``: this may run between a forward and its backward
            # (an overlap scope's first step), whose graph holds the
            # parameters
            for i, p in enumerate(self._params):
                if p.grad_req == "null":
                    continue    # running statistics stay each rank's own
                tmp = p.data().copy()
                kv.pull(i, tmp)
                with torch.no_grad():
                    p.tensor.data.copy_(tmp._data)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    @staticmethod
    def _bucket_mb() -> float:
        try:
            return float(env.get("MXTPU_GRAD_BUCKET_MB"))
        except (TypeError, ValueError):
            return 0.0

    def overlap_scope(self, chaos_step: Optional[int] = None):
        """A context for one ``backward`` that overlaps gradient
        communication with it (``MXTPU_COMM_OVERLAP=on``): each bucket's
        push / pull, or under ``MXTPU_ZERO=1`` its reduce-scatter,
        launches once its gradients are final, and the next
        :meth:`allreduce_grads` completes the round. Inactive (a no-op)
        with overlap off or no kvstore, so ``with
        trainer.overlap_scope(): loss.backward()`` runs anywhere.
        ``chaos_step``: the chaos clock of the coming step (default this
        trainer's own; ``fit.FitLoop`` passes its step counter); a step
        the plan will poison after backward gets an inactive scope."""
        # parse first: a typo raises with or without a store
        active = _overlap_requested() and bool(self._kvstore_arg)
        if active:
            from ..contrib import chaos
            plan = chaos.active()
            if plan is not None and plan.poisons_step(
                    self._chaos_step if chaos_step is None else chaos_step):
                active = False
        return _OverlapScope(self, active)

    def allreduce_grads(self):
        """Sum the gradients across the workers (ref: trainer.py:327):
        one push / pull a flat bucket (module docstring), the results
        copied back into the gradients in place. Under ZeRO-1 the
        buckets are reduce-scattered instead and the following update
        consumes the plane. After an active :meth:`overlap_scope` the
        collectives were launched during backward: this completes them."""
        st = self._overlap_state
        if st is not None:
            self._overlap_state = None
            st.finalize()
            return
        if not self._kv_initialized:
            self._init_kvstore()
        self.last_allreduce_collectives = 0
        self.last_reduce_scatter_collectives = 0
        self._zero_step = None
        # a new comm round supersedes a stale, unconsumed decline
        self._zero_declined = False
        plane = self._zero_plane()
        if plane is not None:
            plane.reduce_scatter_grads(self)
            self._zero_step = plane
            return
        if self._kvstore is None:
            return
        items = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            g = p.grad()
            if g.stype == "row_sparse":
                self._allreduce_rowsparse(i, g)
            else:
                items.append((i, g))
        bucket_mb = self._bucket_mb()
        if bucket_mb > 0:
            self._allreduce_bucketed(items, bucket_mb)
        else:
            for i, g in items:
                self._kvstore.push(i, g)
                self._kvstore.pull(i, g)
                self.last_allreduce_collectives += 1
        if self.last_allreduce_collectives:
            _allreduce_counter().inc(self.last_allreduce_collectives)

    def _allreduce_rowsparse(self, i, g):
        """Sum one row_sparse gradient across the workers (ref: the JAX
        package's ``_allreduce_rowsparse``): a dense ``[rows | row mask]``
        push / pull (``sparse.mask_pack``), so the rebuilt row set is the
        union over the workers, a row whose summed gradient is exactly
        zero included. One worker: the gradient is complete already."""
        if self._kvstore.num_workers <= 1:
            return
        from ..ndarray import sparse as _sp
        packed = _sp.mask_pack(g)
        key = f"_rspgrad{i}"        # its own key: one column wider
        self._kvstore.init(key, packed)
        self._kvstore.push(key, packed)
        self._kvstore.pull(key, packed)
        reduced = _sp.mask_unpack(packed, g.shape)
        g._update(reduced._data, reduced._indices, reduced._indices_np)
        self.last_allreduce_collectives += 1

    def _zero_plane(self):
        """The ZeRO-1 plane, or None. Resolved once: ``MXTPU_ZERO`` is
        parsed strictly, and a configuration that cannot shard (no store,
        compression, an optimizer without a grouped rule, aggregation
        off) raises at first use instead of training unsharded."""
        if self._zero is None:
            from ..parallel import zero as _zero
            if not _zero.zero_requested():
                self._zero = False
            else:
                if not self._kv_initialized:
                    self._init_kvstore()
                self._zero = _zero.ZeroPlane(self)
        return self._zero or None

    def _grad_buckets(self, items, bucket_mb):
        """Same-dtype runs in parameter order of at most ``bucket_mb``
        MB: a pure function of (order, dtypes, sizes, cap), so the store
        keys are the same every step."""
        cap = max(1, int(bucket_mb * (1 << 20)))
        buckets, cur, cur_bytes, cur_dtype = [], [], 0, None
        for i, g in items:
            nbytes = g.size * g._data.element_size()
            dt = g._data.dtype
            if cur and (dt != cur_dtype or cur_bytes + nbytes > cap):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append((i, g))
            cur_bytes += nbytes
            cur_dtype = dt
        if cur:
            buckets.append(cur)
        return buckets

    def _allreduce_bucketed(self, items, bucket_mb):
        for bid, bucket in enumerate(self._grad_buckets(items, bucket_mb)):
            flat = self._launch_bucket(bid, bucket)
            if flat is not None:
                self._split_bucket(bucket, *flat)

    def _launch_bucket(self, bid, bucket):
        """Push and pull one bucket. A flat bucket of several gradients
        returns ``(sig, flat_nd)``, its copy back left to the caller (an
        overlapped launch copies after backward); a lone gradient rides
        its own key, pulled in place, and returns None."""
        if len(bucket) == 1:
            i, g = bucket[0]
            self._kvstore.push(i, g)
            self._kvstore.pull(i, g)
            self.last_allreduce_collectives += 1
            return None
        sig, key = self._bucket_sig_key(bid, bucket)
        flat_nd = self._bucket_wire(key, bucket)
        if key not in self._bucket_keys:
            try:
                self._kvstore.init(key, flat_nd, shard=False)
            except TypeError:  # a user store without shard=
                self._kvstore.init(key, flat_nd)
            self._bucket_keys[key] = True
        self._kvstore.push(key, flat_nd)
        self._kvstore.pull(key, out=flat_nd)
        self.last_allreduce_collectives += 1
        return sig, flat_nd

    @staticmethod
    def _bucket_sig_key(bid, bucket):
        """(signature, store key) of one gradient bucket, the JAX
        package's ``_gbkt{bid}:{dtype}:{elements}:n{count}:{digest}``. The
        key carries a digest of the full shape signature, so a changed
        layout gets a new store buffer and a new compression residual.
        The allreduce and the ZeRO plane share it."""
        sig = tuple((tuple(g.shape), str(g._data.dtype).split(".")[-1])
                    for _, g in bucket)
        total = sum(int(g.size) for _, g in bucket)
        digest = hashlib.md5(repr(sig).encode()).hexdigest()[:10]
        return sig, (f"_gbkt{bid}:{sig[0][1]}:{total}"
                     f":n{len(bucket)}:{digest}")

    @staticmethod
    def _bucket_wire(key, bucket):
        """One bucket's gradients flattened into its transient wire
        buffer (ledgered under ``grad_buckets`` while it lives)."""
        from ..ndarray import ndarray as _nd
        with torch.no_grad():
            flat_nd = _nd.NDArray(_flatten([g._data for _, g in bucket]))
        _memory.track_ndarray("grad_buckets", flat_nd,
                              owner=f"{key.split(':')[0]}:wire")
        return flat_nd

    @staticmethod
    def _split_bucket(bucket, sig, flat_nd):
        """Copy the reduced flat buffer back into the gradients, in place
        (a CUDA graph holds their pointers)."""
        flat, off = flat_nd._data, 0
        with torch.no_grad():
            for _, g in bucket:
                n = int(g.size)
                g._data.copy_(flat[off:off + n].view(g._data.shape))
                off += n

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step: rescale by 1/batch_size, allreduce, update
        (ref: trainer.py:298)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        from ..contrib import chaos
        plan = chaos.active()
        if plan is not None:
            # drive the plan's step clock for classic backward + step
            # loops (FitLoop drives it itself and never calls step())
            plan.begin_step(self._chaos_step)
            self._chaos_step += 1
            if self._overlap_state is not None and \
                    plan.poisons_step(self._chaos_step - 1):
                # a plan installed after the scope opened: the collectives
                # shipped the clean gradients; drop the round so the
                # allreduce below reduces the poisoned ones
                self._overlap_state = None
            plan.poison_grads(self._params)
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def update_with_sentinel(self, batch_size, ignore_stale_grad=False):
        """The aggregated update guarded by one on-device all-finite flag
        over every live gradient: each tensor takes ``where(ok, new,
        old)``. Returns the flag (a 0-d bool tensor; on False call
        :meth:`rollback_step`), or None when the grouped path cannot cover
        the whole parameter set (aggregation off, an optimizer without a
        rule, a stale gradient): nothing is applied then, and the caller
        checks and updates the classic way."""
        self._optimizer.rescale_grad = self._scale / batch_size
        return self._update(ignore_stale_grad, sentinel=True)

    def rollback_step(self):
        """Undo the host-side effects of the last guarded step (its device
        writes were already withheld): the update counters, and the
        optimizer state that step created."""
        _grouped.rollback_counts(self._optimizer, self._last_fused_indices)
        for i in self._last_fused_created:
            self._updaters[0].states.pop(i, None)
            self._updaters[0].states_synced.pop(i, None)
            _memory.drop_optimizer_state(self._updaters[0], i)
        self._last_fused_indices = []
        self._last_fused_created = []

    def megastep_plan(self, batch_size):
        """HOST half of one megastep (``MXTPU_MEGASTEP=on``): what
        ``update_with_sentinel`` does between its device calls (rescale,
        :func:`grouped.prepare_update`'s count bumps, state creation and
        lr / wd resolution, the chunking), for every live parameter, per
        rank of a simulated ZeRO world when the plane is on, so the
        megastep runs it outside its CUDA graph every step. Arms
        ``_last_fused_indices`` / ``_last_fused_created`` so that
        :meth:`rollback_step` undoes a skipped (or refused) step.

        Returns ``(live, rank_chunks, lr_list, wd_list)``: one chunk list
        per non-empty rank, and the per-item scalars flattened in chunk
        order (the graph reads them from one device vector: Adam's
        bias-corrected lr changes every step)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.last_numerics_stats = None
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        plane = self._zero_plane()
        agg = _grouped.aggregation_size()
        if plane is not None:
            agg = max(1, agg)
            rank_sets = [[(i, p) for i, p in live if plane.owner(i) == r]
                         for r in plane.my_ranks]
        else:
            rank_sets = [live]
        rank_chunks, created, handled = [], [], []
        lr_list, wd_list = [], []
        for items in rank_sets:
            if not items:
                continue
            prepared, cr = _grouped.prepare_update(self._updaters[0], items)
            chunks = _grouped.chunk_prepared(prepared, agg)
            rank_chunks.append(chunks)
            created += cr
            for chunk in chunks:
                for e in chunk:
                    handled.append(e[0])
                    lr_list.append(e[4])
                    wd_list.append(e[5])
        self._last_fused_indices = handled
        self._last_fused_created = created
        return live, rank_chunks, lr_list, wd_list

    def _update(self, ignore_stale_grad=False, sentinel=False):
        # stale sampled stats must not outlive their step: FitLoop reads
        # this attribute right after the update call
        self.last_numerics_stats = None
        plane = self._zero_step
        self._zero_step = None
        if plane is not None:
            return self._update_zero(plane, ignore_stale_grad, sentinel)
        declined = self._zero_declined
        self._zero_declined = False
        if not declined and self._zero_plane() is not None:
            # MXTPU_ZERO=1 with no reduce-scatter before this update:
            # stepping every parameter would build the full optimizer
            # state (and, in a group, use unreduced gradients)
            raise MXNetError(
                "MXTPU_ZERO=1: update() without a preceding "
                "allreduce_grads() reduce-scatter would apply an "
                "unsharded update. Call step(), or allreduce_grads() "
                "before update(), or unset MXTPU_ZERO.")
        updater = self._updaters[0]
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if not ignore_stale_grad:
            # scan before applying anything: raising midway would leave a
            # half-stepped model behind (ref: trainer.py _fresh_grad)
            stale = [p.name for _, p in live if not p._fresh_grad]
            if stale and sentinel:
                # the classic flow checks finiteness first and skips a
                # non-finite step before this scan; decline, so the caller
                # can reproduce that order
                return None
            if stale:
                raise MXNetError(
                    f"gradient of parameter(s) {stale[:4]} is stale (not "
                    "updated by backward since the last step). This "
                    "usually means the parameter was unused in the loss, "
                    "or step() ran twice per backward. Call backward "
                    "first, or pass ignore_stale_grad=True to skip stale "
                    "parameters. No update was applied.")
        todo = [(i, p) for i, p in live if p._fresh_grad]
        self.last_update_dispatches = 0
        agg = _grouped.aggregation_size()
        if sentinel and (agg <= 0 or not todo or
                         not _grouped.eligible(updater, todo)):
            # all or nothing: the one skip decision must cover every
            # parameter, so decline without touching any
            return None
        handled, flag = set(), None
        stats_out = None
        if agg > 0 and todo:
            if sentinel:
                # numerics plane: one consume-once sampling decision per
                # step, taken only when a grouped call runs (a per-
                # parameter step leaves it to the caller's fallback)
                stats_out = [] if _numerics.collect_spec() is not None \
                    else None
                # the flag covers every live gradient, stale ones skipped
                # under ignore_stale_grad included, as the classic host
                # check does
                grads = [p.grad()._data for _, p in live]
                idxs, n, flag, created = _grouped.grouped_update(
                    updater, todo, agg, sentinel=True, sentinel_grads=grads,
                    stats_out=stats_out)
                handled = set(idxs)
                self._last_fused_indices = idxs
                self._last_fused_created = created
                self.last_update_dispatches += n + 1   # + the flag
            else:
                dense = [(i, p) for i, p in todo
                         if _grouped.eligible(updater, [(i, p)])]
                if dense:
                    # collect only when the grouped call covers every
                    # live parameter: a partial set would publish an
                    # under-counted global norm
                    if len(dense) == len(todo):
                        stats_out = [] if _numerics.collect_spec() \
                            is not None else None
                    idxs, n, _, _ = _grouped.grouped_update(
                        updater, dense, agg, stats_out=stats_out)
                    handled = set(idxs)
                    self.last_update_dispatches += n
        if stats_out:
            self.last_numerics_stats = stats_out
        for i, p in todo:
            if i not in handled:
                updater(i, p.grad(), p.data())
                self.last_update_dispatches += 1
            p._fresh_grad = False
        if self.last_update_dispatches:
            _update_dispatch_counter().inc(self.last_update_dispatches)
        return flag

    def _update_zero(self, plane, ignore_stale_grad, sentinel):
        """ZeRO-1's back half (the reduce-scatter ran in allreduce_grads):
        the shard-local grouped update guarded by the verdict of every
        rank, then each bucket's weight allgather, after all updates, or
        with ``MXTPU_COMM_OVERLAP=on`` one bucket at a time as its shards
        land. Only this rank's parameters touch optimizer state; the
        others' updated weights arrive through the allgather."""
        updater = self._updaters[0]
        self.last_update_dispatches = 0
        self.last_allgather_collectives = 0
        self._last_fused_indices = []
        self._last_fused_created = []
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        stale = [] if ignore_stale_grad else \
            [p.name for _, p in live if not p._fresh_grad]
        if stale and sentinel and not plane.distributed:
            # decline as the unsharded path does: the caller's classic
            # fallback checks the (locally complete) reduced gradients
            self._zero_declined = True
            return None
        flag = plane.global_finite_flag(live) if sentinel else None
        if stale:
            # distributed: the flag is global already; a non-finite step
            # skips silently, a finite one raises the stale error on
            # every rank
            if sentinel and not bool(flag):
                return flag
            raise MXNetError(
                f"gradient of parameter(s) {stale[:4]} is stale (not "
                "updated by backward since the last step). This "
                "usually means the parameter was unused in the loss, "
                "or step() ran twice per backward. Call backward "
                "first, or pass ignore_stale_grad=True to skip stale "
                "parameters. No update was applied.")
        todo = [(i, p) for i, p in live if p._fresh_grad]
        if not todo:
            if sentinel and not plane.distributed:
                self._zero_declined = True
                return None
            return flag
        agg = max(1, _grouped.aggregation_size())
        # numerics plane: one sampling decision covers every shard's
        # grouped call this step
        # grouped call this step; a real group merges the shard-local
        # stats over the group when they are recorded (telemetry/numerics)
        stats_out = [] if _numerics.collect_spec() is not None else None
        handled, created, n_disp = [], [], 0

        def shard_update(items):
            nonlocal n_disp
            for r in plane.my_ranks:
                mine = [(i, p) for i, p in items if plane.owner(i) == r]
                if not mine:
                    continue
                idxs, n, _f, cr = _grouped.grouped_update(
                    updater, mine, agg, sentinel=sentinel,
                    sentinel_flag=flag, stats_out=stats_out)
                handled.extend(idxs)
                created.extend(cr)
                n_disp += n

        overlap = plane.overlap_active(self)
        if overlap:
            # each bucket's allgather launches once its shards are
            # updated, while the later buckets still update; the update
            # is per parameter, so splitting the grouped calls per bucket
            # changes no bit
            layout = plane.take_step_layout(self)
            todo_idx = dict(todo)
            seen = set()
            for key, bucket in layout:
                bitems = [(i, todo_idx[i]) for i, _g in bucket
                          if i in todo_idx]
                seen.update(i for i, _p in bitems)
                shard_update(bitems)
                with _bd_segment("comm_overlapped"):
                    plane.launch_allgather_bucket(self, key, bucket)
            plane.seal_allgather(self)
            shard_update([(i, p) for i, p in todo if i not in seen])
        else:
            shard_update(todo)
        if stats_out is not None:
            self.last_numerics_stats = stats_out
        if sentinel:
            n_disp += 1  # the finiteness reduction
            self._last_fused_indices = handled
            self._last_fused_created = created
        if not overlap:
            with _bd_segment("comm"):
                plane.allgather_weights(self)
        for _i, p in todo:
            p._fresh_grad = False
        self.last_update_dispatches = n_disp
        if n_disp:
            _update_dispatch_counter().inc(n_disp)
        return flag

    def get_states_bytes(self) -> bytes:
        """The optimizer state, pickled in the unsharded format (a dict
        of index -> state, with the step counters); under ZeRO-1 the
        shards are gathered first, so the bytes restore at any world
        size. ``CheckpointManager`` saves through here."""
        plane = self._zero_plane()
        if plane is not None:
            return plane.gather_states_bytes(self._updaters[0])
        return self._updaters[0].get_states(dump_optimizer=False)

    def set_states_bytes(self, data: bytes) -> None:
        """Restore the unsharded format; a distributed ZeRO-1 rank keeps
        only its own shard's slots."""
        plane = self._zero_plane()
        keep = plane.local_indices() if plane is not None and \
            plane.distributed else None
        self._updaters[0].set_states(data, keep=keep)

    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self.get_states_bytes())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self.set_states_bytes(f.read())


class _OverlapScope:
    """One backward pass's overlapped communication.

    Entering opens an ``autograd.grad_ready_scope``; while backward runs,
    each bucket whose gradients are ALL final launches its collective at
    once (the forward-order layout of the barrier path, launched in
    order of finality: later layers' buckets first), on the card on the
    side stream. The copies back into the gradients wait for
    :meth:`finalize` (the next ``allreduce_grads``). The layout is built
    at the first gradient (deferred parameters take their shapes in the
    first forward). A backward that hands over no gradient launches
    everything at finalize: the barrier path.

    Under ``MXTPU_ZERO=1`` the scope drives the plane's reduce-scatter
    instead (``ZeroPlane.launch_bucket_rs``); finalize copies the reduced
    slices into this rank's gradients, gives the round's layout to the
    plane and arms the update.

    Each entered scope pairs with the next ``allreduce_grads`` / ``step``,
    which consumes it. A scope whose backward raised is dropped on exit;
    one left unconsumed is superseded by the next scope's entry.
    """

    def __init__(self, trainer: Trainer, active: bool):
        self._trainer = trainer
        self.active = active
        self._cm = None
        self._buckets = None        # list of [(param_idx, grad_nd), ...]
        self._owner: Dict[int, int] = {}   # id(grad) -> bucket index
        self._pending: List[int] = []
        self._launched: List = []   # per bucket: None | True | result
        self._sparse: List = []     # row_sparse (param_idx, grad)
        self._nostore = False
        self._zplane = None
        #: buckets launched from backward's hook (the rest at finalize)
        self.launched_in_backward = 0

    def __enter__(self):
        # whatever an aborted step left is superseded, by inactive entries
        # too
        self._trainer._overlap_state = None
        if not self.active:
            return self
        from .. import autograd
        self._cm = autograd.grad_ready_scope(self._on_ready)
        self._cm.__enter__()
        self._trainer._overlap_state = self
        self._trainer.last_allreduce_collectives = 0
        self._trainer.last_reduce_scatter_collectives = 0
        return self

    def __exit__(self, *exc):
        if self._cm is not None:
            self._cm.__exit__(*exc)
            self._cm = None
        if exc and exc[0] is not None and \
                self._trainer._overlap_state is self:
            # backward died mid-pass: the launched buckets hold part of a
            # step; a later allreduce_grads must not copy them back
            self._trainer._overlap_state = None
        return False

    def _ensure_ready(self) -> bool:
        """The store and the bucket layout; False when there is no store
        (overlap is then a no-op, as allreduce_grads is)."""
        if self._nostore:
            return False
        if self._buckets is not None:
            return True
        t = self._trainer
        if not t._kv_initialized:
            t._init_kvstore()
        if t._kvstore is None:
            self._nostore = True
            return False
        plane = t._zero_plane()
        if plane is not None:
            plane.check_comm_round()
            plane.flush_pending()
            self._zplane = plane
        # the barrier path's layout: the same buckets and _gbkt keys
        # whichever path runs
        items = [(i, p.grad()) for i, p in enumerate(t._params)
                 if p.grad_req != "null" and p.tensor is not None]
        # row_sparse gradients take their own reduce at finalize
        self._sparse = [(i, g) for i, g in items if g.stype != "default"]
        items = [(i, g) for i, g in items if g.stype == "default"]
        bucket_mb = t._bucket_mb()
        self._buckets = t._grad_buckets(items, bucket_mb) \
            if bucket_mb > 0 else [[it] for it in items]
        self._pending = [len(b) for b in self._buckets]
        self._launched = [None] * len(self._buckets)
        for b, bucket in enumerate(self._buckets):
            for _, g in bucket:
                self._owner[id(g)] = b
        return True

    def _on_ready(self, gbuf) -> None:
        """The grad-ready hook (on the thread running backward)."""
        if not self._ensure_ready():
            return
        b = self._owner.get(id(gbuf))
        if b is None or self._launched[b] is not None:
            return
        self._pending[b] -= 1
        if self._pending[b] > 0:
            return
        with _bd_segment("comm_overlapped"):
            self._launched[b] = self._launch(b)
        self.launched_in_backward += 1

    def _launch(self, b):
        bucket = self._buckets[b]
        t = self._trainer
        with torch.no_grad(), _on_side(bucket[0][1]._data):
            if self._zplane is not None:
                key = t._bucket_sig_key(b, bucket)[1]
                parts, slices = self._zplane.launch_bucket_rs(t, key,
                                                              bucket)
                t.last_reduce_scatter_collectives += 1
                return parts, slices
            return t._launch_bucket(b, bucket) or True

    def finalize(self) -> None:
        if not self._ensure_ready():
            from ..parallel import zero as _zero
            if self._nostore and _zero.zero_requested():
                # without a store ZeRO raises as the barrier path does
                self._trainer._zero_plane()
            return
        t = self._trainer
        # stragglers: gradients that never came through the hook
        for b in range(len(self._buckets)):
            if self._launched[b] is None:
                self._launched[b] = self._launch(b)
        if self._buckets and self._buckets[0]:
            _join_side(self._buckets[0][0][1]._data)
        if self._zplane is not None:
            self._finalize_zero()
            return
        for b, bucket in enumerate(self._buckets):
            r = self._launched[b]
            if r is not True:
                t._split_bucket(bucket, *r)
        for i, g in self._sparse:
            t._allreduce_rowsparse(i, g)
        if t.last_allreduce_collectives:
            _allreduce_counter().inc(t.last_allreduce_collectives)

    def _finalize_zero(self) -> None:
        t, plane = self._trainer, self._zplane
        t._zero_declined = False
        for parts, slices in self._launched:
            plane.finish_bucket_rs(parts, slices)
        plane._step_layout = [
            (t._bucket_sig_key(b, bucket)[1], bucket)
            for b, bucket in enumerate(self._buckets)]
        t._zero_step = plane
        if t.last_reduce_scatter_collectives:
            from ..parallel.zero import _rs_counter
            _rs_counter().inc(t.last_reduce_scatter_collectives)
