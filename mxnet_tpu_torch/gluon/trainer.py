"""Gluon Trainer on one card (ref: python/mxnet/gluon/trainer.py:27; the
JAX package's ``gluon/trainer.py``).

Applies an Optimizer to a set of Parameters after ``backward``:
``step(batch_size)`` sets ``rescale_grad = scale / batch_size``, reduces
the gradients across devices (nothing to reduce on one card) and updates.
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
reduction). Before any update, every live parameter's gradient must be
fresh (written by ``backward`` since the last step), or nothing is
applied and the step raises (``ignore_stale_grad=True`` skips the stale
ones). ``update_with_sentinel`` guards the update with one on-device
all-finite flag and returns it; ``rollback_step`` undoes the host-side
effects of a skipped step.

An installed chaos plan (``contrib/chaos.py``, e.g. from
``MXTPU_CHAOS``) gets its step clock from ``step()`` (``_chaos_step``),
which also lets it poison a gradient (``nan_grad@N`` / ``inf_grad@N``);
``fit.FitLoop`` drives the clock itself and never calls ``step()``.

A kvstore named by a string (``"device"``, the default, or ``"local"``)
is created and dropped, since one device and one worker add nothing over
direct updates (``trainer.py:240-244`` of the JAX package); a store
object passed in is kept, and ``allreduce_grads`` pushes and pulls each
gradient through it.

``megastep_plan`` is the host half of one megastep (``megastep.py``,
``MXTPU_MEGASTEP=on``): the bookkeeping the guarded update does between
its device calls, run outside the step's CUDA graph every step.

Not ported, each raising ``NotPortedError`` when asked for, by argument
or by environment flag: ``MXTPU_COMM_OVERLAP=on`` (``overlap_scope``)
and flat gradient buckets (``MXTPU_GRAD_BUCKET_MB`` with a store
object), ``compression_params``, ``MXTPU_ZERO`` (ROADMAP A10);
``MXTPU_NUMERICS`` (A9).
"""
from __future__ import annotations

import contextlib
import re
from typing import List

from ..base import MXNetError, check, env
from ..base import env_switch as _switch
from .. import optimizer as opt_mod
from ..ops.registry import NotPortedError
from ..optimizer import grouped as _grouped
from ..telemetry import memory as _memory
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _natural_key(name: str):
    """Numeric-aware sort key: ``dense9_weight`` < ``dense10_weight``, so
    structurally identical nets built at different name counters order
    their parameters alike (and restored optimizer state binds to the
    right ones)."""
    return [(1, int(t)) if t.isdigit() else (0, t)
            for t in re.split(r"(\d+)", name)]


def _not_ported(what: str, item: str) -> NotPortedError:
    return NotPortedError(f"gluon.Trainer: {what} is not ported yet "
                          f"(ROADMAP.md, queue {item})")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[k] for k in sorted(params.keys(),
                                                key=_natural_key)]
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict/list of Parameter")
        if compression_params is not None:
            raise _not_ported("gradient compression (compression_params)",
                              "A10")
        if _switch("MXTPU_ZERO"):
            raise _not_ported("ZeRO-1 sharded optimizer state (MXTPU_ZERO)",
                              "A10")
        if str(env.get("MXTPU_NUMERICS") or "").strip().lower() not in (
                "", "off", "0", "false"):
            raise _not_ported("the numerics plane (MXTPU_NUMERICS)", "A9")
        self._params: List[Parameter] = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
            self._params.append(p)
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_arg = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._chaos_step = 0  # step clock for env-driven chaos plans
        self.last_update_dispatches = 0
        self.last_allreduce_collectives = 0
        self._last_fused_indices: List[int] = []
        self._last_fused_created: List[int] = []

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
        name serves one device and one worker here, so it is dropped."""
        if self._kvstore_arg and not isinstance(self._kvstore_arg, str):
            self._kvstore = self._kvstore_arg
        elif self._kvstore_arg:
            from .. import kvstore as kv_mod
            kv = kv_mod.create(self._kvstore_arg)
            self._kvstore = kv if (kv.num_devices > 1 or
                                   kv.num_workers > 1) else None
        self._kv_initialized = True
        if self._kvstore is not None:
            for i, p in enumerate(self._params):
                self._kvstore.init(i, p.data())

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def overlap_scope(self, chaos_step=None):
        """A context for one ``backward``. With ``MXTPU_COMM_OVERLAP`` off
        it does nothing, so ``with trainer.overlap_scope():
        loss.backward()`` runs anywhere. ``chaos_step`` is the chaos
        clock the coming step runs under (``fit.FitLoop`` passes its
        step counter); it matters only to the overlapped scope, which
        goes inactive for a step the plan will poison. Overlapped
        communication is not ported."""
        if _switch("MXTPU_COMM_OVERLAP"):
            raise _not_ported("overlapping gradient communication with "
                              "backward (MXTPU_COMM_OVERLAP)", "A10")
        return contextlib.nullcontext(self)

    @staticmethod
    def _bucket_mb() -> float:
        try:
            return float(env.get("MXTPU_GRAD_BUCKET_MB"))
        except (TypeError, ValueError):
            return 0.0

    def allreduce_grads(self):
        """Sum gradients across devices (ref: trainer.py:327). One card
        and no store: nothing to do. With a store object, each gradient is
        pushed and pulled back through it under its parameter's key; a
        flat bucket of several gradients (``MXTPU_GRAD_BUCKET_MB`` > 0)
        raises ``NotPortedError``."""
        if not self._kv_initialized:
            self._init_kvstore()
        self.last_allreduce_collectives = 0
        if self._kvstore is None:
            return
        items = [(i, p.grad()) for i, p in enumerate(self._params)
                 if p.grad_req != "null"]
        # The JAX package packs runs of same-dtype gradients into buckets
        # of at most MXTPU_GRAD_BUCKET_MB: a bucket holds two or more
        # exactly when two neighbours of one dtype fit under the cap.
        bucket_mb = self._bucket_mb()
        cap = int(bucket_mb * (1 << 20))
        sizes = [(g._data.dtype, g.size * g._data.element_size())
                 for _, g in items]
        if bucket_mb > 0 and any(
                da == db and na + nb <= cap
                for (da, na), (db, nb) in zip(sizes, sizes[1:])):
            raise _not_ported("flat gradient buckets for the allreduce "
                              "(MXTPU_GRAD_BUCKET_MB > 0; set 0 for one "
                              "push/pull per key)", "A10")
        for i, g in items:
            self._kvstore.push(i, g)
            self._kvstore.pull(i, g)
            self.last_allreduce_collectives += 1

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
        lr / wd resolution, the chunking), for every live parameter, so
        the megastep runs it outside its CUDA graph every step. Arms
        ``_last_fused_indices`` / ``_last_fused_created`` so that
        :meth:`rollback_step` undoes a skipped (or refused) step.

        Returns ``(live, rank_chunks, lr_list, wd_list)``: ``rank_chunks``
        holds one chunk list (one rank: the port has no ZeRO plane, A10),
        and ``lr_list`` / ``wd_list`` flatten the per-item scalars in
        chunk order (the graph reads them from one device vector: Adam's
        bias-corrected lr changes every step)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        rank_chunks, created, handled = [], [], []
        lr_list, wd_list = [], []
        if live:
            prepared, created = _grouped.prepare_update(self._updaters[0],
                                                        live)
            chunks = _grouped.chunk_prepared(prepared,
                                             _grouped.aggregation_size())
            rank_chunks.append(chunks)
            for chunk in chunks:
                for e in chunk:
                    handled.append(e[0])
                    lr_list.append(e[4])
                    wd_list.append(e[5])
        self._last_fused_indices = handled
        self._last_fused_created = created
        return live, rank_chunks, lr_list, wd_list

    def _update(self, ignore_stale_grad=False, sentinel=False):
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
        if agg > 0 and todo:
            if sentinel:
                # the flag covers every live gradient, stale ones skipped
                # under ignore_stale_grad included, as the classic host
                # check does
                grads = [p.grad()._data for _, p in live]
                idxs, n, flag, created = _grouped.grouped_update(
                    updater, todo, agg, sentinel=True, sentinel_grads=grads)
                handled = set(idxs)
                self._last_fused_indices = idxs
                self._last_fused_created = created
                self.last_update_dispatches += n + 1   # + the flag
            else:
                dense = [(i, p) for i, p in todo
                         if _grouped.eligible(updater, [(i, p)])]
                if dense:
                    idxs, n, _, _ = _grouped.grouped_update(updater, dense,
                                                            agg)
                    handled = set(idxs)
                    self.last_update_dispatches += n
        for i, p in todo:
            if i not in handled:
                updater(i, p.grad(), p.data())
                self.last_update_dispatches += 1
            p._fresh_grad = False
        return flag

    def get_states_bytes(self) -> bytes:
        """The optimizer state, pickled (the JAX package's unsharded
        format: a dict of index -> state, with the step counters)."""
        return self._updaters[0].get_states(dump_optimizer=False)

    def set_states_bytes(self, data: bytes) -> None:
        self._updaters[0].set_states(data)

    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self.get_states_bytes())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self.set_states_bytes(f.read())
