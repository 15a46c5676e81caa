"""The whole training step as one CUDA graph (``MXTPU_MEGASTEP``; ref: the
JAX package's ``megastep.py``).

The JAX package traces one FitLoop step (forward, backward, the
finiteness sentinel and the grouped optimizer update) into ONE jitted
program per input signature, so a warm step is one dispatch. Here that
program is a CUDA graph: the first call of a signature runs the step
body eagerly on the graph's own stream (a real step of the trajectory;
it warms the BN reductions' ticket counters, cuDNN's choices and the
allocator up on that stream) and then captures the same body; every
later call copies its inputs into the entry's static buffers and replays
the graph. The body is the composed FitLoop step, literally:

- ``net(x)`` and the loss under ``autograd.record()``, then ``scaled =
  loss * lscale``, always present (a multiply by 1.0 is exact, so it
  matches the composed path's skip of the multiply at scale 1.0);
- ``backward()``: the gradient hooks copy into the parameters' own
  gradient buffers;
- the chaos poison site, ``where(poison, fill, g)`` on the first
  trainable gradient (the pick ``chaos.Plan.poison_grads`` makes; the
  identity when no event fires);
- ``grouped.global_finite_flag`` over the live gradients in live order,
  and ``grouped.apply_chunk`` per chunk guarded by it;
- the reported loss's mean, the eager op the composed path runs.

What changes every step without changing the graph is an input, read
from one static float32 vector: the lr / wd of every parameter (Adam's
bias-corrected lr moves each step, a scheduler moves lr), the gradient
rescale (``scale / batch``: a loss-scale backoff moves it), the loss
scale, the poison switch and its fill. The update rules round them as
they round Python floats (``ops/optimizer_ops.scalar``), so the megastep
is the composed path bit for bit.

The host bookkeeping the composed path does between its device calls
runs outside the graph every step, cold and warm alike: the chaos event
(``Plan.should``), ``Trainer.megastep_plan`` (count bumps, state
creation, lr / wd resolution, rollback arming), the gradients'
freshness flags and the trainer's dispatch counters. So FitLoop's skip,
rollback and backoff work unchanged.

The graph holds the pointers of every tensor it read or wrote when it
was captured, and its entry keeps those tensors alive. A parameter or a
gradient buffer found rebound at a warm call raises (write them in
place). Optimizer state may be rebound (``load_states``, the state a
rolled-back first step created again): its values are copied into the
captured tensors and the state handles rebound to them, so the one copy
that lives is the one the graph updates. Nothing falls back to the
composed path: a failed capture raises ``MXNetError`` with its cause.

On the CPU the same body runs eagerly over the same static buffers
every step; there is no graph.

Strictness (the JAX package's messages): ``skip_nonfinite`` is required,
``ignore_stale_grad``, gradient compression, an optimizer without a
grouped rule and aggregation 0 are refused at construction, and a live
parameter that gets no gradient raises at the first (eager) step, which
is then rolled back. A trainer with a sparse parameter (``stype``
row_sparse: its updates take the per-parameter path) is refused too.
``MXTPU_COMM_OVERLAP`` is superseded, as in the JAX package.

A simulated ZeRO-1 world (``MXTPU_ZERO=1`` with ``MXTPU_ZERO_WORLD=N``)
runs inside the graph: after the backward each bucket of the plane's
layout is flattened, passed through ``collectives.loopback_psum`` (the
collective site; one contribution, so the identity) and copied back into
the gradients, then the update steps each rank's chunks under the one
finiteness flag: bit for bit the composed ZeRO step. A real
multi-worker group and a distributed plane raise at the first step, with
the JAX package's words: their transport is host-side collectives, which
a CUDA graph cannot hold.

Telemetry. The eager body of the cold call runs under a counting scope
(``telemetry.efficiency``): the graph's cost and footprint are recorded
once per signature (kind ``megastep``), since a replay runs nothing the
counter can see; the capture's seconds land in the registry's compile
counters. With ``MXTPU_EFFICIENCY`` on each replay is one dispatch note.
On a ``MXTPU_NUMERICS`` sampled step the body also computes every
bucket's stats matrix into static buffers: ``collect`` is part of the
signature, so the cache holds a second graph, the stats variant, and an
unsampled step replays the stats-free one at no cost.

Randomness: a random op in the body draws from a generator the graph
advances on every replay (PyTorch registers the default CUDA generator
with every capture; a generator a block holds is registered here), so
each replay draws new numbers. Such a net matches the composed path
statistically, not bit for bit, as in the JAX package.
"""
from __future__ import annotations

import torch

from . import autograd
from .base import MXNetError, check, env
from .base import env_switch as _switch
from .cached_op import (SignatureLRU, _block_generators, capture_graph,
                        inline_scope, on_stream, trace_rw_for)
from .log import get_logger
from .ndarray.ndarray import NDArray
from .optimizer import grouped as _grouped
from .parallel import collectives as _coll
from .telemetry import efficiency as _efficiency
from .telemetry import memory as _memory
from .telemetry import numerics as _numerics
from .telemetry.registry import note_compile

__all__ = ["megastep_requested", "Megastep", "cache_info",
           "donation_supported"]

_LOG = get_logger("mxnet_tpu_torch.megastep")


def megastep_requested() -> bool:
    """Strict ``MXTPU_MEGASTEP`` parse: on/1/true | off/0/false/unset;
    anything else raises (a typo'd knob must not silently train on the
    composed path)."""
    raw = str(env.get("MXTPU_MEGASTEP") or "").strip().lower()
    if raw in ("", "0", "off", "false"):
        return False
    if raw in ("1", "on", "true"):
        return True
    raise MXNetError(
        f"MXTPU_MEGASTEP: unknown value {raw!r} (known: on, off)")


def cache_info(net):
    """Megastep signature-cache counters for ``net``
    (:class:`cached_op.CacheInfo`), or None when no megastep ran on it.
    Steps after the first of a signature are hits."""
    cache = getattr(net, "_mxtpu_megastep_cache", None)
    return cache.cache_info() if cache is not None else None


def donation_supported() -> bool:
    """Whether the step's buffers are donated. In JAX a donated input
    dies inside the program and its successor is rebound; here the step
    writes the parameters', gradients' and optimizer states' own
    storages in place, on the card and on the host, so no second copy of
    any of them is ever kept: always True."""
    return True


class _Entry:
    """One signature: static inputs and outputs, the graph and its
    stream, the tensors the graph captured, and the host ms its capture
    took."""
    __slots__ = ("ready", "x", "y", "scal", "flag", "loss", "smats",
                 "graph", "stream", "ptrs", "states", "capture_ms", "label",
                 "comm")

    def __init__(self):
        self.ready = False
        self.comm = ()
        self.graph = None
        self.stream = None
        self.capture_ms = None
        self.smats = None
        self.label = None


class Megastep:
    """The one-graph step ``FitLoop`` delegates to under
    ``MXTPU_MEGASTEP=on``. Construct once per fit (every statically
    checkable incompatibility raises here, before any step runs); call
    :meth:`run` once per step."""

    def __init__(self, net, trainer, loss_fn, skip_nonfinite: bool = True,
                 ignore_stale_grad: bool = False):
        check(skip_nonfinite,
              "MXTPU_MEGASTEP=on requires skip_nonfinite=True: the traced "
              "program guards every update behind the in-graph finiteness "
              "sentinel (where(ok, new, old)); a host check-then-raise "
              "flow cannot live inside one program")
        check(not ignore_stale_grad,
              "MXTPU_MEGASTEP=on does not compose with ignore_stale_grad: "
              "the fused program updates a FIXED parameter set per "
              "signature, it cannot drop stale members per step. Fix the "
              "unused parameter (set grad_req='null') or unset "
              "MXTPU_MEGASTEP")
        check(getattr(trainer, "_compression_params", None) is None,
              "MXTPU_MEGASTEP=on does not compose with gradient "
              "compression: per-key error-feedback residuals are "
              "host-side kvstore state that cannot be traced into the "
              "program")
        check(not trainer._contains_sparse,
              "MXTPU_MEGASTEP=on requires dense parameters/gradients "
              "(row_sparse updates take the per-parameter path)")
        rule = _grouped._rule_for(trainer._optimizer)
        check(rule is not None,
              f"MXTPU_MEGASTEP=on: optimizer "
              f"{type(trainer._optimizer).__name__} has no grouped-update "
              "rule (the fused step IS the grouped donated-buffer path)")
        check(_grouped.aggregation_size() > 0,
              "MXTPU_MEGASTEP=on requires MXTPU_OPTIMIZER_AGGREGATION > 0: "
              "the in-graph update is the grouped bucket program")
        if _switch("MXTPU_COMM_OVERLAP"):
            _LOG.info("MXTPU_COMM_OVERLAP superseded by MXTPU_MEGASTEP: "
                      "the whole step is one graph")
        self._net = net
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._rule = rule
        self._rw = trace_rw_for(net)
        cache = getattr(net, "_mxtpu_megastep_cache", None)
        if cache is None:
            cache = net._mxtpu_megastep_cache = SignatureLRU()
        self._cache = cache
        # the store and the ZeRO plane need the parameters: resolved at
        # the first run, after the deferred-init forward
        self._plane = None
        self._world = 1
        self._resolved = False

    def _resolve_runtime(self) -> None:
        if self._resolved:
            return
        tr = self._trainer
        if not tr._kv_initialized:
            tr._init_kvstore()
        kv = tr._kvstore
        if kv is not None and int(getattr(kv, "num_workers", 1) or 1) > 1:
            raise MXNetError(
                "MXTPU_MEGASTEP=on does not compose with a real "
                "multi-worker group: the kvstore transport is a host-side "
                "byte channel that cannot be traced into the program. Use "
                "a simulated group (MXTPU_ZERO_WORLD) or unset "
                "MXTPU_MEGASTEP")
        self._plane = tr._zero_plane()
        if self._plane is not None and self._plane.distributed:
            raise MXNetError(
                "MXTPU_MEGASTEP=on composes with simulated ZeRO worlds "
                "only: a distributed plane's reduce-scatter rides the "
                "host kvstore transport, which cannot be traced into the "
                "program")
        self._world = self._plane.world if self._plane is not None else 1
        self._resolved = True

    # -- signature -------------------------------------------------------
    def _signature(self, rank_chunks, x, y, collect):
        """What the graph bakes in. lr, wd, rescale, the loss scale and
        the poison are inputs, not keys; ``collect`` (the numerics stats
        variant) is a key."""
        tr = self._trainer
        psig = tuple((tuple(p.tensor.shape), p.tensor.dtype, p.grad_req)
                     for p in tr._params)
        plan_sig = tuple(
            tuple(tuple((e[0], e[3], tuple((tuple(h._data.shape),
                                            h._data.dtype) for h in e[2]))
                        for e in chunk) for chunk in chunks)
            for chunks in rank_chunks)
        xsig = (tuple(x.shape), x.dtype, x.device)
        ysig = (tuple(y.shape), y.dtype) if y is not None else None
        bucket_mb = tr._bucket_mb() if self._plane is not None else None
        return ("megastep", self._rule.name,
                self._rule.statics(tr._optimizer), self._world, bucket_mb,
                _grouped.aggregation_size(), psig, plan_sig, xsig, ysig,
                bool(env.get("MXTPU_FUSED_EPILOGUE")),
                bool(env.get("MXNET_SAFE_ACCUMULATION")), bool(collect))

    # -- the step body ---------------------------------------------------
    def _body(self, e, live, rank_chunks, n, check_stale: bool) -> None:
        """One composed FitLoop step over the entry's static buffers; its
        results land in the parameters, gradients and states in place and
        in ``e.flag`` / ``e.loss``."""
        net, tr = self._net, self._trainer
        s = e.scal
        lrs, wds = s[:n], s[n:2 * n]
        rescale, lscale, poison, fill = s[2 * n], s[2 * n + 1], \
            s[2 * n + 2] != 0, s[2 * n + 3]
        x = NDArray(e.x)
        y = NDArray(e.y) if e.y is not None else None
        # a hybridized net runs inline: the step is one program
        with autograd.record(), inline_scope():
            out = net(x)
            loss = self._loss_fn(out, y) if y is not None \
                else self._loss_fn(out)
            scaled = loss * NDArray(lscale.to(loss._data.dtype))
        scaled.backward()
        if check_stale:
            stale = [p.name for _i, p in live if not p._fresh_grad]
            if stale:
                tr.rollback_step()   # undo megastep_plan's host half
                raise MXNetError(
                    f"MXTPU_MEGASTEP=on: parameter(s) {stale[:4]} receive "
                    "no gradient from the loss (unused in the traced "
                    "step). The fused program updates every live "
                    "parameter; set grad_req='null' on unused parameters "
                    "or unset MXTPU_MEGASTEP")
        grads = [_grouped._grad_nd(p)._data for _i, p in live]
        with torch.no_grad():
            # chaos poison, in-graph: the same graph whether or not this
            # step injects
            if grads:
                g = grads[0]
                g.copy_(torch.where(poison, fill.to(g.dtype), g))
            # the simulated world's reduce-scatter, through the collective
            # site: the plane's flatten / slice walk, copied back in place
            for bucket, parts in e.comm:
                flat = _coll.loopback_psum(
                    torch.cat([gb._data.reshape(-1) for _i, gb in bucket]))
                for _i, gb, lo, hi in parts:
                    gb._data.copy_(flat[lo:hi].view(gb._data.shape))
            flag = _grouped.global_finite_flag(grads)
        updater = tr._updaters[0]
        stats = [] if e.smats is not None else None
        off = 0
        for chunks in rank_chunks:
            for chunk in chunks:
                k = len(chunk)
                _grouped.apply_chunk(updater, self._rule, chunk,
                                     lrs[off:off + k], wds[off:off + k],
                                     rescale, sentinel=True, flag=flag,
                                     stats_out=stats)
                off += k
        with torch.no_grad():
            e.flag.copy_(flag)
            e.loss.copy_(loss.mean()._data)
            for buf, (_names, mat) in zip(e.smats or (), stats or ()):
                buf.copy_(mat)

    # -- entry state -----------------------------------------------------
    def _ptrs(self, live):
        """Data pointers of every parameter and live gradient buffer."""
        return [p.tensor.data_ptr() for p in self._trainer._params] + \
            [_grouped._grad_nd(p)._data.data_ptr() for _i, p in live]

    def _adopt(self, e, live, handles) -> None:
        """Hold a warm call's tensors to the ones the entry captured:
        parameters and gradients must be the same storages; optimizer
        state rebound since is copied into the captured tensors and its
        handles rebound to them."""
        if self._ptrs(live) != e.ptrs:
            raise MXNetError(
                "megastep: a parameter or gradient tensor was rebound "
                "after the CUDA graph captured it; write parameters in "
                "place (Parameter.set_data)")
        with torch.no_grad():
            for h, want in zip(handles, e.states):
                if h._data is not want:
                    if h._data.data_ptr() != want.data_ptr():
                        want.copy_(h._data)
                    h._data = want

    # -- one step --------------------------------------------------------
    def run(self, x_nd, y_nd, bs, loss_scale: float, plan):
        """One fused training step. Returns ``(flag, loss_dev)``: the
        device finiteness verdict (0-d bool) and mean loss (0-d), static
        buffers of the signature's entry, valid until the next call; the
        caller fetches both in its one step transfer."""
        tr, net = self._trainer, self._net
        # deferred init OUTSIDE the step: the same init draws, in the same
        # order, as the composed path's first recorded forward
        if any(p.tensor is None for p in tr._params):
            with autograd.pause(), inline_scope():
                net(x_nd)
        self._resolve_runtime()
        plane = self._plane
        if plane is not None:
            plane.check_comm_round()
        # chaos: the event is consumed here (the counters Plan.poison_grads
        # bumps); the fill is applied in the graph through its inputs
        poison, fill = False, 0.0
        if plan is not None:
            if plan.should("nan_grad"):
                poison, fill = True, float("nan")
            elif plan.should("inf_grad"):
                poison, fill = True, float("inf")
        # numerics plane: one consume-once sampling decision per step; a
        # sampled step replays the stats variant of the graph
        collect = _numerics.collect_spec() is not None
        live, rank_chunks, lr_list, wd_list = tr.megastep_plan(
            bs * loss_scale)
        handles = [h for chunks in rank_chunks for chunk in chunks
                   for ent in chunk for h in ent[2]]
        n = len(lr_list)
        x = x_nd._data
        y = y_nd._data if y_nd is not None else None
        dev = tr._params[0].tensor.device
        scal = torch.tensor(
            lr_list + wd_list + [float(tr._optimizer.rescale_grad),
                                 float(loss_scale), float(poison),
                                 float(fill)], dtype=torch.float32)
        sig = self._signature(rank_chunks, x, y, collect)
        e = self._cache.get_or_insert(sig, _Entry)
        if not e.ready:
            self._rw.acquire_write()
            try:
                e.label = (f"megastep:{self._rule.name}:w{self._world}:"
                           f"{_grouped._digest(sig)}")
                if plane is not None:
                    # the layout is read on the host, once a signature
                    e.comm = [(bucket, plane._bucket_parts(bucket)[0])
                              for _key, bucket in plane._bucket_layout(tr)]
                if collect:
                    e.smats = [torch.empty((len(chunk), 6),
                                           dtype=torch.float32, device=dev)
                               for chunks in rank_chunks
                               for chunk in chunks]
                self._cold(e, live, handles, rank_chunks, n, x, y, scal,
                           dev)
            finally:
                self._rw.release_write()
        else:
            self._rw.acquire_read()
            try:
                self._adopt(e, live, handles)
                self._warm(e, live, rank_chunks, n, x, y, scal, dev)
            finally:
                self._rw.release_read()
        for _i, p in live:
            p._fresh_grad = False
        if collect:
            names = [tuple(ent[1].name for ent in chunk)
                     for chunks in rank_chunks for chunk in chunks]
            tr.last_numerics_stats = list(zip(names, e.smats))
        # one graph: its collectives are in-graph, not host collectives
        tr.last_update_dispatches = 1
        tr.last_allreduce_collectives = 0
        tr.last_reduce_scatter_collectives = 0
        tr.last_allgather_collectives = 0
        from .gluon.trainer import _update_dispatch_counter
        _update_dispatch_counter().inc(1)
        if _efficiency.notes_on():
            label = e.label
            _efficiency.note_dispatch(
                ("megastep", id(e)), "megastep", label,
                lambda: _memory.get_program("megastep", label))
        return e.flag, e.loss

    @staticmethod
    def _load(e, x, y, scal) -> None:
        e.x.copy_(x, non_blocking=True)
        if y is not None:
            e.y.copy_(y, non_blocking=True)
        e.scal.copy_(scal)

    def _cold(self, e, live, handles, rank_chunks, n, x, y, scal,
              dev) -> None:
        """Static buffers, the eager step, then (on the card) the
        capture."""
        e.x = torch.empty(x.shape, dtype=x.dtype, device=dev)
        e.y = torch.empty(y.shape, dtype=y.dtype, device=dev) \
            if y is not None else None
        e.scal = torch.empty(scal.shape, dtype=torch.float32, device=dev)
        e.flag = torch.empty((), dtype=torch.bool, device=dev)
        e.loss = torch.empty((), dtype=torch.float32, device=dev)
        self._load(e, x, y, scal)
        if dev.type != "cuda":
            self._counted_body(e, live, handles, rank_chunks, n, dev)
        else:
            e.stream = torch.cuda.Stream(dev)

            def body():
                with _efficiency.program_scope():
                    self._body(e, live, rank_chunks, n, check_stale=False)
            with on_stream(e.stream):
                self._counted_body(e, live, handles, rank_chunks, n, dev)
                e.graph, _, secs = capture_graph(
                    body, e.stream, "the megastep's training step",
                    _block_generators(self._net))
            e.capture_ms = 1e3 * secs
            note_compile("graph_capture", secs, e.label)
        e.ptrs = self._ptrs(live)
        e.states = [h._data for h in handles]
        e.ready = True

    def _counted_body(self, e, live, handles, rank_chunks, n, dev) -> None:
        """The cold call's eager body, counted: the graph's cost and
        footprint, recorded once per signature (kind ``megastep``)."""
        with _efficiency.counting(dev) as c, _efficiency.program_scope():
            self._body(e, live, rank_chunks, n, check_stale=True)
        tr = self._trainer
        args = [p.tensor for p in tr._params] + \
            [_grouped._grad_nd(p)._data for _i, p in live] + \
            [h._data for h in handles] + \
            [t for t in (e.x, e.y, e.scal) if t is not None]
        outs = [e.flag, e.loss] + list(e.smats or ())
        _memory.record_program("megastep", e.label, c.stats(args, outs))

    def _warm(self, e, live, rank_chunks, n, x, y, scal, dev) -> None:
        self._load(e, x, y, scal)
        if e.graph is None:
            with _efficiency.program_scope():
                self._body(e, live, rank_chunks, n, check_stale=False)
            return
        with on_stream(e.stream):
            e.graph.replay()
