"""CachedOp: a hybridized block's calls as one CUDA graph per signature
(ref: the JAX package's ``cached_op.py``; src/imperative/cached_op.{h,cc}
in the reference, a traced graph registered on the tape as one node with
its own backward).

The JAX package traces a hybridized block once per (input shapes and
dtypes, parameter shapes and dtypes, input structure, train mode, trace
flags) and compiles the whole graph into one XLA executable. Here the
executable is a CUDA graph, keyed the same way in a :class:`SignatureLRU`
(``MXTPU_CACHEDOP_CACHE_SIZE``; hits, misses and evictions as in JAX):

- **Inference** (gradients off): one graph of the block's forward over
  static input buffers. A call copies its inputs in, replays, and copies
  the outputs out before it lets go of the entry.
- **Training** (``autograd.record()``): the JAX CachedOp's one tape node
  with its own backward. A ``torch.autograd.Function`` whose forward
  replays a captured forward graph and whose backward replays a captured
  backward graph (``torch.autograd.grad`` of the outputs by the
  parameters, and by the inputs that require grad). The parameter
  gradients flow back through autograd into the same hooks, so they land
  in the same gradient buffers the eager path fills, by ``grad_req``.
  BatchNorm's moving statistics are written in place inside the forward
  graph, once per replay, as the eager path writes them.

A signature's graphs are built at its first call on the card: an eager
run on the entry's own stream (a warm-up: it allocates the BN
reductions' ticket counters for that stream and warms cuDNN, cuBLAS and
the allocator; the block's buffers and the random generators are put
back afterwards, so it leaves no trace), then the captures, then a
replay for the call itself. That eager run is counted
(``telemetry.efficiency``): the forward and backward programs' costs are
recorded once per signature (kind ``cached_op``), since a replay runs
nothing the counter can see; each replay is one dispatch note.

A training signature keeps a slot per forward whose backward has not
run yet: the forward graph's activations live in its memory pool until
the backward graph reads them, so a second forward of the same
signature before the first backward (two calls, then one loss) gets a
slot of its own, captured once. The backward graph is captured with the
activations kept, so it may run again on the same forward
(``retain_graph=True``, or ``backward`` and then ``autograd.grad``)
until another forward of the signature takes the slot; a backward after
that raises ``MXNetError``. The gradients it returns are copies, never
the graph's own buffers, and it is differentiable once only (a double
backward raises).

The graphs hold the pointers of every parameter and buffer, not the
tensors. A tensor rebound since (``cast``, ``reset_ctx``, a new tensor)
is found at the next call, and the signature is captured again; a stale
graph is never replayed, and each capture drops every graph whose
pointers no longer match, with its memory pool. Random ops draw from
generators the graphs advance on every replay (the default CUDA
generator, and any a block holds), so Dropout draws new masks each
call.

Runs inline (the block's plain forward): a call inside another program
(:func:`inline_scope`: the megastep's step, ``SPMDTrainer``'s steps, a
CachedOp's own run, where the nested blocks of a hybridized net run),
under CUDA-graph capture (an outer graph records the block as part of
itself, as the JAX CachedOp inlines under an outer trace), and with a
parameter that ``functional_call`` substituted. ``MXNET_EXEC_BULK_EXEC_
TRAIN`` / ``_INFERENCE`` off runs the block op by op with no cache entry.

On the CPU an entry runs the block eagerly: no graph, the same keys,
cache and counters. ``hybridize(mirror=)`` recomputes the activations in
the backward graph (``util.mirror_wrapper``; the eager path's remat).

AOT bundles (the serving fleet's cold start, :meth:`CachedOp.aot_export`
/ :meth:`CachedOp.aot_load`): a CUDA graph is bound to its process, so
where the JAX package serializes compiled executables the bundle holds
each warm inference signature (cache key, input and output structure),
the runtime fingerprint and a format number, and ``aot_load`` captures
the graphs at load time. :func:`make_scan_forward` runs K stacked batches
as one graph replay. Nothing falls back: a failed capture raises
``MXNetError`` with its cause.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import pickle
import threading
import time
import warnings
from collections import OrderedDict, namedtuple
from typing import Any, Dict, List, Optional

import torch
from torch.autograd.function import once_differentiable
from torch.utils import _pytree as pytree

from .base import MXNetError, env

__all__ = ["CachedOp", "CacheInfo", "SignatureLRU", "trace_rw_for",
           "inline_scope", "inlining", "on_stream", "capture_graph",
           "make_scan_forward", "scan_forward"]

CacheInfo = namedtuple("CacheInfo",
                       ["hits", "misses", "evictions", "currsize", "maxsize"])


# Every live SignatureLRU (CachedOp signature caches, grouped-optimizer
# program caches, serving signature caches) reports into the shared
# telemetry registry as polled gauges — zero hot-path cost: the counters
# are summed at export time, not on every lookup. Counters of DEAD caches
# are folded into a retired accumulator by a weakref.finalize, so the
# exported totals are MONOTONE: a cyclic-GC pass collecting an old
# hybridized net between two reads must never make hits/misses go down
# (the exact mechanism behind the test_env_flags+test_telemetry
# pair-order flake this replaces — the gauge used to sum live caches
# only, so a cache dying mid-test subtracted its whole history).
_all_caches: "weakref.WeakSet" = None  # type: ignore[assignment]
_retired_counts = {"hits": 0, "misses": 0, "evictions": 0}
# RLock, not Lock: the retire callback runs from weakref.finalize, which
# cyclic GC may fire synchronously on THIS thread while it already holds
# the lock (list() below allocates, allocation can trigger collection of
# a dead cycle holding a SignatureLRU) — a plain Lock would self-deadlock
_track_lock = threading.RLock()


def _retire_cache_counts(stats: dict) -> None:
    with _track_lock:
        for field in _retired_counts:
            _retired_counts[field] += stats[field]


def _tracked_cache_total(field: str) -> int:
    """Monotone process-wide total for hits/misses/evictions; live-only
    occupancy for currsize (a dead cache holds no entries)."""
    with _track_lock:
        live = list(_all_caches) if _all_caches is not None else []
        base = _retired_counts.get(field, 0)
    return base + sum(getattr(c.cache_info(), field) for c in live)


def _track_cache(cache: "SignatureLRU") -> None:
    global _all_caches
    import weakref
    with _track_lock:
        if _all_caches is None:
            _all_caches = weakref.WeakSet()
            try:
                from .telemetry import default_registry
                reg = default_registry()
                for field in ("hits", "misses", "evictions", "currsize"):
                    reg.callback_gauge(
                        f"mxtpu_cachedop_cache_{field}",
                        (lambda f=field: _tracked_cache_total(f)),
                        f"Signature-cache {field} over all compiled-"
                        "program caches (monotone: retired caches keep "
                        "their counts, except currsize which is live "
                        "occupancy).")
            except Exception:
                pass
        _all_caches.add(cache)
    weakref.finalize(cache, _retire_cache_counts, cache._stats)


class SignatureLRU:
    """Thread-safe signature-keyed LRU of captured programs, bounded by
    ``maxsize`` or, without one, ``MXTPU_CACHEDOP_CACHE_SIZE`` (0 =
    unbounded)."""

    def __init__(self, maxsize: Optional[int] = None):
        self._explicit_maxsize = maxsize
        self._cache: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0}
        _track_cache(self)

    def _bound(self) -> int:
        if self._explicit_maxsize is not None:
            return int(self._explicit_maxsize)
        return int(env.get("MXTPU_CACHEDOP_CACHE_SIZE"))

    def get_or_insert(self, key, factory):
        """Lock-held get-or-create for CHEAP factories (an entry object,
        never a capture): exactly one caller creates the value for a key,
        so concurrent cold lookups cannot race two half-initialised
        entries into existence."""
        with self._lock:
            val = self._cache.get(key)
            if val is not None:
                self._stats["hits"] += 1
                self._cache.move_to_end(key)
                return val
            self._stats["misses"] += 1
            val = factory()
            self._cache[key] = val
            self._evict_locked()
            return val

    def insert(self, key, val) -> bool:
        """Install a prebuilt value (AOT-loaded entries) without counting
        a hit or a miss; returns False when the key was already resident
        (the resident entry wins — it may already be warm)."""
        with self._lock:
            if key in self._cache:
                return False
            self._cache[key] = val
            self._evict_locked()
            return True

    def _evict_locked(self) -> None:
        bound = self._bound()
        if bound > 0:
            while len(self._cache) > bound:
                self._cache.popitem(last=False)
                self._stats["evictions"] += 1

    def cache_info(self) -> CacheInfo:
        bound = self._bound()
        return CacheInfo(self._stats["hits"], self._stats["misses"],
                         self._stats["evictions"], len(self._cache),
                         bound if bound > 0 else None)

    def snapshot_items(self):
        """(key, value) pairs at this instant."""
        with self._lock:
            return list(self._cache.items())

    def __len__(self) -> int:
        return len(self._cache)


class _RWLock:
    """Many concurrent replays, exclusive captures, with writer
    preference: back-to-back replays must not starve a cold signature's
    one-time capture."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writing = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writing or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if not self._readers:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writing or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writing = True

    def release_write(self):
        with self._cond:
            self._writing = False
            self._cond.notify_all()


def trace_rw_for(block) -> _RWLock:
    """The block's shared capture lock, created and stashed on the block
    at first use, so every capture over the same Parameters (the
    megastep's, every CachedOp's over the block) excludes the others. A
    block that refuses the attribute gets a private lock."""
    rw = getattr(block, "_mxtpu_trace_rw", None)
    if rw is None:
        rw = _RWLock()
        try:
            block._mxtpu_trace_rw = rw
        except AttributeError:
            pass
    return rw


_tls = threading.local()


@contextlib.contextmanager
def inline_scope():
    """Hybridized blocks called inside run as plain modules: the caller
    is a program of its own (the megastep's step, ``SPMDTrainer``'s
    steps, a CachedOp's run) that captures or counts them as part of
    itself."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def inlining() -> bool:
    """Whether an :func:`inline_scope` is open on this thread."""
    return bool(getattr(_tls, "depth", 0))


def _eff():
    from .telemetry import efficiency
    return efficiency


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _tensor_leaves(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _block_generators(net) -> List[torch.Generator]:
    """The CUDA generators the net's blocks hold (``Dropout(generator=)``),
    each once: a graph registers them, so each replay draws anew."""
    gens = {}
    for m in net.modules():
        g = getattr(m, "_generator", None)
        if isinstance(g, torch.Generator) and g.device.type == "cuda":
            gens[id(g)] = g
    return list(gens.values())


@contextlib.contextmanager
def on_stream(stream):
    """Run the body on ``stream`` (a graph's side stream, for its warm-up,
    its capture and its replays): the stream first waits for the current
    stream's work, and the current stream waits for the body's after
    it."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield
    cur.wait_stream(stream)


def capture_graph(run, stream, what: str, generators=(), **graph_kw):
    """``run()`` captured on ``stream`` into a new ``CUDAGraph`` that
    advances each of ``generators`` on every replay (``graph_kw`` go to
    ``torch.cuda.graph``): (the graph, ``run()``'s result, the capture's
    host seconds). The megastep, ``SPMDTrainer.run_steps`` and the
    CachedOp capture through it. A failed capture raises ``MXNetError``
    naming ``what``, with its cause; nothing falls back."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, stream=stream, **graph_kw):
            out = run()
    except Exception as err:
        raise MXNetError(
            f"CUDA graph capture of {what} failed: {err}") from err
    return graph, out, time.perf_counter() - t0


class _Slot:
    """One set of static buffers and its graphs: the forward graph (and,
    training, the backward graph in the same memory pool)."""
    __slots__ = ("ins", "outs", "fwd", "bwd", "gouts", "grads", "busy",
                 "gen", "pool_bytes")

    def __init__(self):
        self.fwd = self.bwd = None
        self.gouts = self.grads = ()
        self.busy = False
        self.gen = 0
        self.pool_bytes = 0


class _Variant:
    """The graphs of one entry for one gradient mode: inference (or a
    training-mode forward without gradients), or forward + backward with
    the given inputs requiring grad."""
    __slots__ = ("grad", "req", "stream", "ptrs", "slots",
                 "in_consts", "in_spec", "out_spec", "out_consts",
                 "diff_out", "n_params", "capture_ms", "label")

    def __init__(self, grad, req):
        self.grad = grad
        self.req = req
        self.slots: List[_Slot] = []
        self.capture_ms = 0.0


class _Entry:
    """One signature: its variants (card), whether it ran, and the bytes
    and costs it reports."""
    __slots__ = ("variants", "lock", "warm", "labels", "in_bytes",
                 "out_bytes", "mem_stats", "call_struct", "__weakref__")

    def __init__(self):
        self.variants: Dict[Any, _Variant] = {}
        self.lock = threading.RLock()
        self.warm = False
        self.labels: Dict[Any, str] = {}
        self.in_bytes = self.out_bytes = 0
        self.mem_stats = None
        #: (input spec, input constants, output spec) of the first call,
        #: what an AOT bundle needs to rebuild the call
        self.call_struct = None


class _Call:
    """One training call's hold on a slot, from its forward replay to its
    backward replay (or to the death of the autograd node that keeps
    it), and on the block's tensors the graphs read, which a rebind
    before the backward must not free."""

    def __init__(self, op, entry, var, slot, n_in, tensors):
        self.op, self.entry, self.var, self.slot = op, entry, var, slot
        self.gen = slot.gen
        self.n_in = n_in
        self.tensors = tensors

    def release(self) -> None:
        with self.entry.lock:
            if self.slot.gen == self.gen:
                self.slot.busy = False

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class _GraphFn(torch.autograd.Function):
    """The training call as one tape node: the forward graph's replay,
    and the backward graph's."""

    @staticmethod
    def forward(ctx, call, *tensors):
        ctx.call = call
        slot, var = call.slot, call.var
        ins = tensors[:call.n_in]
        for dst, src in zip(slot.ins, ins):
            dst.copy_(src)
        slot.fwd.replay()
        outs = tuple(o.clone() for o in slot.outs)
        ctx.mark_non_differentiable(*[o for i, o in enumerate(outs)
                                      if i not in var.diff_out])
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *gouts):
        call = ctx.call
        op, entry, var, slot = call.op, call.entry, call.var, call.slot
        rw = op._trace_rw
        rw.acquire_read()
        try:
            with entry.lock:
                if slot.gen != call.gen:
                    raise MXNetError(
                        "CachedOp: the saved activations of this forward "
                        "were overwritten by a later forward of the same "
                        "signature after its backward ran; run every "
                        "backward of a forward before the next forward")
                for dst, i in zip(slot.gouts, var.diff_out):
                    dst.copy_(gouts[i])
                slot.bwd.replay()
                # copies: the next replay writes the graph's buffers
                grads = [g.clone() if g is not None else None
                         for g in slot.grads]
                slot.busy = False
        finally:
            rw.release_read()
        in_grads = iter(grads[var.n_params:])
        out = [next(in_grads) if r else None for r in var.req]
        return (None, *out, *grads[:var.n_params])


class CachedOp:
    """Capture-and-replay executor for a HybridBlock (see the module
    docstring). ``op(*args)`` takes and returns NDArrays, or tensors."""

    def __init__(self, block, static_alloc: bool = False,
                 static_shape: bool = False, inline_limit: int = 2,
                 flags=(), mirror: Optional[bool] = None,
                 cache_size: Optional[int] = None):
        # static_alloc / static_shape are what a CUDA graph does anyway;
        # kept for the API (ref: CachedOpConfig, cached_op.h:32-53)
        self.block = block
        self.mirror = mirror
        if cache_size is None:
            cache_size = int(env.get("MXTPU_CACHEDOP_CACHE_SIZE"))
        self._cache = SignatureLRU(maxsize=int(cache_size))
        self._trace_rw = trace_rw_for(block)
        self._mirror_fn = None
        self._arch = None
        self._slots = None       # where the block's tensors live
        self._resolved = False   # no deferred shape left

    def cache_info(self) -> CacheInfo:
        """Hit/miss/eviction counters + occupancy of the signature cache
        (shape of :func:`functools.lru_cache`'s ``cache_info``)."""
        return self._cache.cache_info()

    # -- the block's tensors -------------------------------------------
    def _params(self):
        """Every Parameter record of the block."""
        return list(self.block.collect_params().values())

    def _tensors(self) -> List[torch.Tensor]:
        """Every tensor the block owns, each once: parameters, then
        buffers, read from the modules' slots (found once: a call reads
        the slots, not the module tree), so a tensor registered anew is
        seen at the next call."""
        if self._slots is None:
            mods = list(self.block.modules())
            self._slots = [(m._parameters, n) for m in mods
                           for n in m._parameters] + \
                [(m._buffers, n) for m in mods for n in m._buffers]
        seen, out = set(), []
        for d, n in self._slots:
            t = d.get(n)
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def _warn_sparse_grads(self) -> None:
        """Warn about parameters with row_sparse gradients (the JAX
        package's warning): this op's backward is one program of fixed
        shapes, so their gradient comes out dense (``embedding_rows``
        inside an :func:`inline_scope`) and is delivered into the
        row_sparse buffers whole, every row kept."""
        sparse = [p.name for p in self._params()
                  if getattr(p, "grad_stype", "default") != "default"]
        if sparse:
            warnings.warn(
                f"hybridize(): parameters {sparse} request row_sparse "
                "gradients, but the whole-graph backward produces dense "
                "gradients (they are still delivered correctly to the "
                "row_sparse buffers). Run the block un-hybridized to keep "
                "gradients compact.", stacklevel=4)

    def _trained(self) -> List[torch.Tensor]:
        """The parameters that take a gradient."""
        return [t for t in self._tensors() if t.requires_grad]

    # -- running the block -----------------------------------------------
    def _plain(self, *args, **kwargs):
        """The block's forward as a plain module call."""
        return torch.nn.Module.__call__(self.block, *args, **kwargs)

    def _run(self, args, kwargs):
        """The block's forward as this op's program: nested hybridized
        blocks inline, remat (``mirror``) when gradients are on."""
        if torch.is_grad_enabled():
            if self._mirror_fn is None:
                from .util import mirror_wrapper
                self._mirror_fn = mirror_wrapper(self.mirror)
            fn = self._mirror_fn(self._plain)
        else:
            fn = self._plain
        with inline_scope(), _eff().program_scope():
            return fn(*args, **kwargs)

    @staticmethod
    def _outer_capture_or_substituted(tensors) -> bool:
        """An outer CUDA graph capture records the block as part of
        itself; a parameter ``functional_call`` substituted (the trainers'
        16-bit replicas) is not the tensor the graphs hold."""
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            return True
        return any(t.requires_grad and not t.is_leaf for t in tensors)

    # -- signatures -------------------------------------------------------
    def _label(self, entry, key, vkey) -> str:
        """The efficiency plane's program label: the block's structure
        (``efficiency.block_signature``) with the signature, so two
        architectures never share a record and two instances of one
        do."""
        lbl = entry.labels.get(vkey)
        if lbl is None:
            if self._arch is None:
                self._arch = _eff().block_signature(self.block)
            lbl = entry.labels[vkey] = f"{type(self.block).__name__}:" + \
                hashlib.md5(repr((self._arch, key, vkey)).encode()
                            ).hexdigest()[:12]
        return lbl

    @staticmethod
    def _entry_digest(key) -> str:
        return hashlib.md5(repr(key).encode()).hexdigest()[:12]

    # -- the call ----------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """NDArrays in, NDArrays out; tensors in, tensors out."""
        from .gluon.block import ndarray_call
        from .ndarray.ndarray import NDArray
        if not any(isinstance(a, NDArray) for a in (*args,
                                                      *kwargs.values())):
            return self.call(args, kwargs)
        return ndarray_call(lambda *a, **k: self.call(a, k), args, kwargs)

    def call(self, args, kwargs):
        """The tensor path of :meth:`__call__`."""
        from . import autograd
        block = self.block
        if getattr(block, "_deferred", None):
            block._finish_deferred(*args, **kwargs)
        if inlining():
            return self._plain(*args, **kwargs)
        tensors = self._tensors()
        if self._outer_capture_or_substituted(tensors):
            return self._plain(*args, **kwargs)
        training = autograd.is_training()
        flag = "MXNET_EXEC_BULK_EXEC_TRAIN" if training \
            else "MXNET_EXEC_BULK_EXEC_INFERENCE"
        if not env.get(flag):
            return self._plain(*args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        ins = [x for x in leaves if isinstance(x, torch.Tensor)]
        if not self._resolved:
            self._warn_sparse_grads()
            self._resolved = all(p.tensor is not None
                                 for p in self._params())
            if not self._resolved:
                # deferred shapes resolve on this eager call (the JAX
                # CachedOp runs the block imperatively first); the
                # signature is keyed on the shapes it gave
                return self._eager(args, kwargs, ins, leaves, spec,
                                   training)
        dev = ins[0].device if ins else (tensors[0].device if tensors
                                         else torch.device("cpu"))
        sig = self._signature(ins, leaves, spec, training, tensors)
        if dev.type == "cuda":
            return self._graphed(*sig, ins, leaves, spec, training,
                                 tensors)
        return self._eager(args, kwargs, ins, leaves, spec, training, sig)

    def _signature(self, ins, leaves, spec, training, tensors):
        """(key, gradient-mode key, entry) of a call; the lookup counts a
        hit or a miss."""
        from .ops.registry import _trace_time_flags
        consts = tuple(None if isinstance(x, torch.Tensor) else repr(x)
                       for x in leaves)
        key = (tuple((tuple(t.shape), str(t.dtype), str(t.device))
                     for t in ins),
               tuple((tuple(t.shape), str(t.dtype)) for t in tensors),
               (str(spec), consts), training, _trace_time_flags())
        grad = torch.is_grad_enabled() and (
            any(t.requires_grad for t in ins) or
            any(t.requires_grad for t in tensors))
        vkey = (True, tuple(t.requires_grad for t in ins),
                tuple(t.requires_grad for t in tensors)) \
            if grad else (False,)
        return key, vkey, self._cache.get_or_insert(key, _Entry)

    # -- the CPU (eager) entry ---------------------------------------------
    def _eager(self, args, kwargs, ins, leaves, spec, training, sig=None):
        """The entry run eagerly (on the CPU, and the call that resolves
        deferred shapes): its program counted on its first run and each
        run noted (``efficiency.observe``), its bytes; with gradients on,
        its backward pending for the next ``autograd.backward``. Without
        ``sig`` the signature is looked up after the run."""
        sig = list(sig or ())

        def label(_out=None):
            if not sig:
                sig.extend(self._signature(ins, leaves, spec, training,
                                           self._tensors()))
            return self._label(sig[2], sig[0], sig[1]) + ":fwd"

        def run():
            return self._run(args, kwargs)

        eff = _eff()
        notes = eff.notes_on()
        if notes:
            out = eff.observe(
                "cached_op", label() if sig else label, run,
                ins[0].device if ins else None,
                arguments=lambda: ins + self._tensors(),
                outputs=_tensor_leaves)
        else:
            out = run()
        lbl = label()[:-len(":fwd")]
        _key, vkey, entry = sig
        if not entry.warm:
            entry.in_bytes = _nbytes(ins) + _nbytes(self._tensors())
            entry.out_bytes = _nbytes(_tensor_leaves(out))
            entry.call_struct = (spec, _consts(leaves),
                                 pytree.tree_flatten(out)[1])
            entry.warm = True
        if notes and vkey[0]:
            eff.pend_backward(lbl)
        return out

    # -- the card: graphs -----------------------------------------------------
    def _graphed(self, key, vkey, entry, ins, leaves, spec, training,
                 tensors):
        rw = self._trace_rw
        rw.acquire_read()
        mode = "read"
        try:
            var = entry.variants.get(vkey)
            ptrs = [t.data_ptr() for t in tensors]
            if var is None or var.ptrs != ptrs:
                rw.release_read()
                mode = None
                rw.acquire_write()
                mode = "write"
                var = entry.variants.get(vkey)
                tensors = self._tensors()
                ptrs = [t.data_ptr() for t in tensors]
                if var is None or var.ptrs != ptrs:
                    self._drop_stale(ptrs)
                    var = self._capture(entry, key, vkey, ins, leaves,
                                        spec, training)
                    entry.variants[vkey] = var
            if var.grad:
                out = self._train_call(entry, var, ins, rw, mode, tensors)
            else:
                with entry.lock:
                    slot = var.slots[0]
                    for dst, src in zip(slot.ins, ins):
                        dst.copy_(src)
                    slot.fwd.replay()
                    out = [o.clone() for o in slot.outs]
        finally:
            if mode == "read":
                rw.release_read()
            elif mode == "write":
                rw.release_write()
        eff = _eff()
        if eff.notes_on():
            lbl = var.label
            eff.note_dispatch(("co_fwd", id(var)), "cached_op",
                              lbl + ":fwd",
                              lambda: _memory().get_program("cached_op",
                                                            lbl + ":fwd"))
            if var.grad:
                eff.pend_backward(lbl)
        return self._unflatten(var, out)

    def _drop_stale(self, ptrs) -> None:
        """Drop every variant whose graphs hold other pointers than the
        block's tensors have now (a rebind, a cast), with its memory pool;
        a training call still waiting for its backward keeps its own
        slot. Under the block's write lock."""
        for _key, entry in self._cache.snapshot_items():
            with entry.lock:
                for vk in [vk for vk, v in entry.variants.items()
                           if v.ptrs != ptrs]:
                    del entry.variants[vk]
                    entry.mem_stats = None

    @staticmethod
    def _unflatten(var, outs):
        it = iter(outs)
        leaves = [next(it) if c is None else c for c in var.out_consts]
        return pytree.tree_unflatten(leaves, var.out_spec)

    def _train_call(self, entry, var, ins, rw, mode, tensors):
        with entry.lock:
            slot = next((s for s in var.slots if not s.busy), None)
            if slot is not None:
                slot.busy = True
                slot.gen += 1
        if slot is None:
            # every slot's forward waits for its backward: one more slot
            if mode == "read":
                rw.release_read()
                rw.acquire_write()
            try:
                slot = self._capture_slot(var, ins)
            finally:
                if mode == "read":
                    rw.release_write()
                    rw.acquire_read()
            with entry.lock:
                var.slots.append(slot)
                slot.busy = True
                slot.gen += 1
        call = _Call(self, entry, var, slot, len(ins), tensors)
        with entry.lock:
            return _GraphFn.apply(call, *ins,
                                  *[t for t in tensors if t.requires_grad])

    # -- capture ----------------------------------------------------------------
    def _capture(self, entry, key, vkey, ins, leaves, spec, training):
        """Warm-up on the variant's stream, then the captures (under the
        block's write lock)."""
        grad = vkey[0]
        var = _Variant(grad, vkey[1] if grad else ())
        var.label = self._label(entry, key, vkey)
        dev = ins[0].device if ins else self._tensors()[0].device
        var.stream = torch.cuda.Stream(dev)
        tensors = self._tensors()
        var.ptrs = [t.data_ptr() for t in tensors]
        var.n_params = len(self._trained())
        var.in_consts = _consts(leaves)
        var.in_spec = spec
        with on_stream(var.stream):
            self._warm_up(var, ins, training)
            t0 = time.perf_counter()
            slot = self._capture_slot(var, ins)
            var.capture_ms = 1e3 * (time.perf_counter() - t0)
        var.slots = [slot]
        from .telemetry.registry import note_compile
        note_compile("graph_capture", var.capture_ms / 1e3, var.label)
        entry.in_bytes = _nbytes(ins) + _nbytes(tensors)
        entry.out_bytes = _nbytes(slot.outs)
        entry.call_struct = (spec, var.in_consts, var.out_spec)
        entry.warm = True
        entry.mem_stats = None
        return var

    @staticmethod
    def _static_inputs(var, ins):
        """Copies of the call's inputs, leaves that require grad where the
        variant differentiates by them."""
        return [t.detach().clone().requires_grad_(bool(r))
                for t, r in zip(ins, var.req or [False] * len(ins))]

    @staticmethod
    def _static_args(var, static):
        it = iter(static)
        flat = [next(it) if c is None else c for c in var.in_consts]
        return pytree.tree_unflatten(flat, var.in_spec)

    def _warm_up(self, var, ins, training) -> None:
        """One eager run of the signature on the variant's stream,
        counted as the program's cost; the block's buffers and the random
        generators are restored after it."""
        from .telemetry import efficiency as eff
        mem = _memory()
        static = self._static_inputs(var, ins)
        args, kwargs = self._static_args(var, static)
        dev = var.stream.device
        bufs = list(self.block.buffers()) if training else []
        saved = [b.detach().clone() for b in bufs]
        gens = _block_generators(self.block)
        gstates = [g.get_state() for g in gens]
        rng = torch.cuda.get_rng_state(dev)
        fwd_lbl, bwd_lbl = var.label + ":fwd", var.label + ":bwd"
        with torch.enable_grad() if var.grad else torch.no_grad():
            with eff.counting(dev) as c:
                out = self._run(args, kwargs)
            flat = _tensor_leaves(out)
            if mem.get_program("cached_op", fwd_lbl) is None:
                mem.record_program("cached_op", fwd_lbl, c.stats(
                    static + self._tensors(), flat))
            diff = [o for o in flat if o.requires_grad]
            if var.grad and diff:
                wrt = self._trained() + [s for s, r in zip(static, var.req)
                                         if r]
                with eff.counting(dev) as cb, eff.program_scope():
                    grads = torch.autograd.grad(
                        diff, wrt, [torch.ones_like(o) for o in diff],
                        allow_unused=True)
                if mem.get_program("cached_op", bwd_lbl) is None:
                    mem.record_program("cached_op", bwd_lbl, cb.stats(
                        wrt + diff, [g for g in grads if g is not None]))
        del out, flat
        with torch.no_grad():
            for b, s in zip(bufs, saved):
                b.copy_(s)
        for g, st in zip(gens, gstates):
            g.set_state(st)
        torch.cuda.set_rng_state(rng, dev)

    def _capture_slot(self, var, ins):
        """The static buffers and graphs of one slot, captured on the
        variant's stream."""
        dev = var.stream.device
        slot = _Slot()
        slot.ins = self._static_inputs(var, ins)
        args, kwargs = self._static_args(var, slot.ins)
        gens = _block_generators(self.block)
        what = f"CachedOp {type(self.block).__name__}"
        # the capture empties the allocator's cache as it starts: empty it
        # first, so the reserved bytes around it are the graphs' pool
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        with on_stream(var.stream), self._leaves(var.grad) as leaves:
            with torch.enable_grad() if var.grad else torch.no_grad():
                slot.fwd, out, _ = capture_graph(
                    lambda: self._run(args, kwargs), var.stream,
                    what + "'s forward", gens,
                    capture_error_mode="thread_local")
            leaves_out, var.out_spec = pytree.tree_flatten(out)
            var.out_consts = [None if isinstance(x, torch.Tensor) else x
                              for x in leaves_out]
            outs = [x for x in leaves_out if isinstance(x, torch.Tensor)]
            var.diff_out = [i for i, o in enumerate(outs) if o.requires_grad]
            if var.grad and var.diff_out:
                slot.gouts = [torch.empty_like(outs[i])
                              for i in var.diff_out]
                wrt = leaves + [s for s, r in zip(slot.ins, var.req) if r]
                # retain_graph: the activations stay allocated through the
                # capture, so no temporary of the backward graph reuses
                # their memory and the graph can run again on them
                slot.bwd, grads, _ = capture_graph(
                    lambda: torch.autograd.grad(
                        [outs[i] for i in var.diff_out], wrt, slot.gouts,
                        retain_graph=True, allow_unused=True),
                    var.stream, what + "'s backward", gens,
                    pool=slot.fwd.pool(), capture_error_mode="thread_local")
                slot.grads = list(grads)
                outs = [o.detach() for o in outs]
            slot.outs = outs
        slot.pool_bytes = torch.cuda.memory_reserved(dev) - before
        return slot

    @contextlib.contextmanager
    def _leaves(self, on: bool):
        """With ``on``, the block's trained tensors swapped in their module
        slots for new leaves over the same storage while the body runs
        (yielded in :meth:`_trained`'s order). A capture's graphs read the
        same memory, and its backward reaches no AccumulateGrad node that
        a still-live earlier graph made on another stream: the engine
        would make that stream wait on the capture, which breaks it."""
        if not on:
            yield []
            return
        trained = self._trained()
        alias = {id(t): torch.nn.Parameter(t.detach()) for t in trained}
        swapped = []
        for d, n in self._slots:
            t = d.get(n)
            if t is not None and id(t) in alias:
                d[n] = alias[id(t)]
                swapped.append((d, n, t))
        try:
            yield [alias[id(t)] for t in trained]
        finally:
            for d, n, t in swapped:
                d[n] = t

    # -- reports ---------------------------------------------------------------
    def memory_analysis(self, refresh: bool = False) -> Dict[str, dict]:
        """Per-signature memory, keyed by the signature's digest: the
        static input bytes (inputs and the block's tensors,
        ``argument_bytes``), the outputs' (``output_bytes``), and on the
        card the graphs' memory pool (``temp_bytes``; ``graph_pool`` per
        variant and slot: ``torch.cuda.memory_reserved()`` around each
        capture). On the CPU there is no pool: ``temp_bytes`` 0,
        ``graph_pool`` {}. Each variant's forward program record in the
        telemetry program registry (kind ``cached_op``, the efficiency
        plane's label) takes the input and output bytes and its pool as
        ``graph_pool_bytes``."""
        out: Dict[str, dict] = {}
        for key, entry in self._cache.snapshot_items():
            if not entry.warm:
                continue
            digest = self._entry_digest(key)
            if entry.mem_stats is not None and not refresh:
                out[digest] = entry.mem_stats
                continue
            pools = {f"{'grad' if v.grad else 'fwd'}:{i}": s.pool_bytes
                     for v in entry.variants.values()
                     for i, s in enumerate(v.slots)}
            stats = {"argument_bytes": int(entry.in_bytes),
                     "output_bytes": int(entry.out_bytes),
                     "temp_bytes": int(sum(pools.values())),
                     "alias_bytes": 0, "graph_pool": pools,
                     "signature": digest}
            entry.mem_stats = stats
            for vkey, lbl in list(entry.labels.items()):
                var = entry.variants.get(vkey)
                _memory().merge_program("cached_op", lbl + ":fwd", {
                    "argument_bytes": stats["argument_bytes"],
                    "output_bytes": stats["output_bytes"],
                    "graph_pool_bytes": sum(
                        s.pool_bytes for s in var.slots) if var else 0})
            out[digest] = stats
        return out

    def capture_ms(self) -> Dict[str, float]:
        """Host milliseconds each signature's captures took (card)."""
        return {f"{self._entry_digest(k)}:{'grad' if v.grad else 'fwd'}":
                v.capture_ms for k, e in self._cache.snapshot_items()
                for v in e.variants.values()}

    # -- AOT signature bundles (the serving fleet's cold start) -------------
    # The JAX package serializes each warm signature's compiled executable;
    # a CUDA graph is bound to its process and cannot be saved. The bundle
    # keeps what a new process needs to rebuild the same cache entries:
    # each warm inference signature's key and its call's input and output
    # structure, under the runtime fingerprint. aot_load installs them and
    # captures their graphs before the replica reports ready, so warm-up
    # and the first requests make ZERO signature-cache misses; the captures
    # are the cost that stays (mxtpu_compile_total{kind="graph_capture"},
    # capture_ms()).
    AOT_FORMAT = 1

    def aot_export(self, path: str) -> int:
        """Write the warm inference signatures to ``path`` (a pickled
        bundle: format, fingerprint, and per signature its cache key and
        the input / output structure of its call). Returns the number of
        signatures exported. Training signatures (a backward graph) are
        not exported: AOT bundles are a serving artifact."""
        from .ops.registry import _trace_time_flags
        from .serving.aot import runtime_fingerprint
        flags = _trace_time_flags()
        records = []
        for key, entry in self._cache.snapshot_items():
            if not entry.warm or key[3] or key[4] != flags or \
                    entry.call_struct is None:
                continue  # cold, training, or another flag regime
            spec, consts, out_spec = entry.call_struct
            records.append({"key": key,
                            "in_spec": pytree.treespec_dumps(spec),
                            "in_consts": list(consts),
                            "out_spec": pytree.treespec_dumps(out_spec)})
        bundle = {"format": self.AOT_FORMAT,
                  "fingerprint": runtime_fingerprint(), "entries": records}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(bundle, f)
        os.replace(tmp, path)
        return len(records)

    def aot_load(self, path: str) -> int:
        """Install a bundle's signatures as warm cache entries (no hit or
        miss counted), capturing each one's graph now on the card; returns
        how many were installed. Zero, with a log line, when the bundle is
        unreadable or was written by another format or runtime (torch,
        CUDA, card): warm-up then captures each signature as a miss. An
        entry that cannot be decoded, or whose parameters or output
        structure differ from this block's, is skipped with a log line."""
        from .log import get_logger
        from .ops.registry import _trace_time_flags
        from .serving.aot import runtime_fingerprint
        log = get_logger("mxnet_tpu_torch.cached_op")
        try:
            with open(path, "rb") as f:
                bundle = pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError) as e:
            log.warning("aot_load: unreadable bundle %s: %s", path, e)
            return 0
        if not isinstance(bundle, dict) or \
                bundle.get("format") != self.AOT_FORMAT:
            log.warning("aot_load: bundle format %s != %s, skipping",
                        bundle.get("format") if isinstance(bundle, dict)
                        else type(bundle).__name__, self.AOT_FORMAT)
            return 0
        fp = runtime_fingerprint()
        if bundle.get("fingerprint") != fp:
            log.warning("aot_load: fingerprint mismatch (bundle %s, "
                        "runtime %s) — signatures are captured at warm-up "
                        "instead", bundle.get("fingerprint"), fp)
            return 0
        flags = _trace_time_flags()
        params = tuple((tuple(t.shape), str(t.dtype))
                       for t in self._tensors())
        loaded = 0
        for rec in bundle.get("entries", ()):
            try:
                key = rec["key"]
                spec = pytree.treespec_loads(rec["in_spec"])
                out_spec = rec["out_spec"]
                consts = list(rec["in_consts"])
                ins = [torch.zeros(tuple(shape), device=torch.device(dev),
                                   dtype=getattr(torch, dt.split(".")[-1]))
                       for shape, dt, dev in key[0]]
            except (KeyError, TypeError, ValueError, AttributeError,
                    IndexError) as e:
                log.warning("aot_load: skipping an unreadable entry: %s", e)
                continue
            if key[1] != params or key[3] or key[4] != flags:
                log.warning("aot_load: skipping entry %s: its parameters, "
                            "mode or flags differ from this block's",
                            self._entry_digest(key))
                continue
            it = iter(ins)
            leaves = [next(it) if c is None else c for c in consts]
            if self._install(key, ins, leaves, spec, out_spec, log):
                loaded += 1
        return loaded

    def _install(self, key, ins, leaves, spec, out_spec, log) -> bool:
        """One AOT entry into the cache: on the card its inference graph
        captured now (under the block's write lock), on the CPU an entry
        that runs eagerly. False when the output structure differs from
        the recorded one or the key is resident already."""
        entry = _Entry()
        if ins and ins[0].device.type == "cuda":
            rw = self._trace_rw
            rw.acquire_write()
            try:
                var = self._capture(entry, key, (False,), ins, leaves, spec,
                                    False)
            finally:
                rw.release_write()
            entry.variants[(False,)] = var
            got = pytree.treespec_dumps(var.out_spec)
        else:
            with torch.no_grad():
                out = self._run(*pytree.tree_unflatten(leaves, spec))
            entry.call_struct = (spec, _consts(leaves),
                                 pytree.tree_flatten(out)[1])
            got = pytree.treespec_dumps(entry.call_struct[2])
            entry.in_bytes = _nbytes(ins) + _nbytes(self._tensors())
            entry.out_bytes = _nbytes(_tensor_leaves(out))
            entry.warm = True
        if got != out_spec:
            log.warning("aot_load: skipping entry %s: output structure %s, "
                        "bundle %s", self._entry_digest(key), got, out_spec)
            return False
        return self._cache.insert(key, entry)


def _consts(leaves) -> list:
    """A call's leaves with each tensor replaced by None."""
    return [None if isinstance(x, torch.Tensor) else x for x in leaves]


def _first_leaf(out) -> torch.Tensor:
    return out if isinstance(out, torch.Tensor) else _tensor_leaves(out)[0]


class _ScanForward:
    """The callable :func:`make_scan_forward` returns (see there)."""

    def __init__(self, block, training: bool):
        self.block = block
        self.training = bool(training)
        self._rw = trace_rw_for(block)
        self._lock = threading.Lock()
        self._graphs: Dict[Any, tuple] = {}
        #: captures made and graph replays run (card)
        self.captures = 0
        self.replays = 0

    def _tensors(self) -> List[torch.Tensor]:
        """What the graphs read the pointers of."""
        return list(self.block.parameters()) + list(self.block.buffers())

    def _body(self, xs: torch.Tensor) -> torch.Tensor:
        """The K forwards, stacked (training mode leaves the buffers as
        they were: the JAX scan drops the forward's state)."""
        from . import autograd
        bufs = list(self.block.buffers()) if self.training else []
        saved = [b.detach().clone() for b in bufs]
        mode = autograd.train_mode() if self.training \
            else autograd.predict_mode()
        with mode, torch.no_grad(), inline_scope(), \
                _eff().program_scope():
            ys = torch.stack([_first_leaf(torch.nn.Module.__call__(
                self.block, xs[k])) for k in range(xs.shape[0])])
            for b, s in zip(bufs, saved):
                b.copy_(s)
        return ys

    def __call__(self, xs):
        from .ndarray.ndarray import NDArray
        wrap = isinstance(xs, NDArray)
        x = xs._data if wrap else xs
        if getattr(self.block, "_deferred", None):
            self.block._finish_deferred(x[0])
        y = self._graphed(x) if x.device.type == "cuda" else self._body(x)
        return NDArray(y) if wrap else y

    def _graphed(self, x: torch.Tensor) -> torch.Tensor:
        key = (tuple(x.shape), str(x.dtype), str(x.device))
        self._rw.acquire_read()
        try:
            with self._lock:
                ptrs = [t.data_ptr() for t in self._tensors()]
                g = self._graphs.get(key)
                if g is None or g[0] != ptrs:
                    self._graphs.pop(key, None)
                    g = self._graphs[key] = (ptrs, *self._capture(x))
                    self.captures += 1
                _, graph, xs_buf, ys_buf = g
                xs_buf.copy_(x)
                graph.replay()
                self.replays += 1
                return ys_buf.clone()
        finally:
            self._rw.release_read()

    def _capture(self, x: torch.Tensor):
        """Static input buffer, a warm-up on the graph's stream (cuDNN,
        the allocator; buffers and the random generators restored), then
        the capture of the K forwards."""
        stream = torch.cuda.Stream(x.device)
        xs_buf = x.detach().clone()
        gens = _block_generators(self.block)
        gstates = [g.get_state() for g in gens]
        rng = torch.cuda.get_rng_state(x.device)
        with on_stream(stream):
            self._body(xs_buf)
        for g, st in zip(gens, gstates):
            g.set_state(st)
        torch.cuda.set_rng_state(rng, x.device)
        graph, ys_buf, secs = capture_graph(
            lambda: self._body(xs_buf), stream,
            f"scan forward of {type(self.block).__name__}", gens,
            capture_error_mode="thread_local")
        from .telemetry.registry import note_compile
        note_compile("graph_capture", secs, "scan_forward")
        return graph, xs_buf, ys_buf


def make_scan_forward(block, training: bool = False):
    """Build a reusable K-batch forward for a block: returns ``fn(xs)``
    mapping (K, batch, ...) stacked inputs to (K, batch, ...) stacked
    outputs (the block's first output; NDArray in, NDArray out; a tensor
    in, a tensor out).

    The inference-side analog of ``SPMDTrainer.run_steps`` (ref: the JAX
    package's ``lax.scan`` of the compiled forward; the engine's bulk
    exec of inference graphs, MXNET_EXEC_BULK_EXEC_INFERENCE): on the card
    the K forwards are ONE CUDA graph, captured once per (K, batch, item)
    signature and replayed per call (``fn.replays`` counts them,
    ``fn.captures`` the captures; a rebound parameter captures anew). On
    the CPU it is a loop of eager forwards. ``training`` runs the
    forwards in training mode (batch statistics; the block's buffers are
    left as they were). Random ops draw from the default generators,
    which a replay advances. Build it ONCE and reuse it.
    """
    return _ScanForward(block, training)


def scan_forward(block, xs, training: bool = False):
    """One-shot convenience over :func:`make_scan_forward` (captures per
    call on the card — hot loops should build the callable once)."""
    return make_scan_forward(block, training)(xs)


def _memory():
    from .telemetry import memory
    return memory
