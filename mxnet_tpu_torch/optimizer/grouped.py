"""Aggregated (multi-tensor) optimizer updates (ref: the JAX package's
``optimizer/grouped.py``; src/operator/optimizer_op.cc:654
multi_sgd_update and ``MXNET_OPTIMIZER_AGGREGATION_SIZE``).

Dense parameters are grouped into buckets by (weight dtype, device,
multi-precision, state arity) of up to ``MXTPU_OPTIMIZER_AGGREGATION``
parameters, in parameter order, and each bucket is stepped by one call of
its optimizer's multi-tensor rule (``ops/optimizer_ops.py``:
``torch._foreach_*`` over the bucket's tensors), whose results are
written into the weights and states in place. The JAX package compiles
one program per bucket with donated buffers; here the rule is the same
code the per-parameter path runs on one tensor, so aggregation on and off
are bit-identical by construction, and only the number of calls differs
(``Trainer.last_update_dispatches``: one per bucket).

The finiteness sentinel: :func:`global_finite_flag` folds every gradient
into one 0-d bool tensor on the device, and a guarded bucket writes
``where(ok, new, old)`` into each tensor, so a non-finite step changes no
weight and no state, with no host sync inside the update. The caller
fetches the flag; :func:`rollback_counts` and the trainer's
``rollback_step`` undo the host-side counters and the state a skipped
step created.

``cache_info`` / ``clear_cache`` count the bucket kernels built per rule,
hyper-parameters, multi-precision and statefulness: a kernel is a closure
over these alone, so a change of learning rate, batch size or shapes
reuses it.

Telemetry. A bucket program (one signature: rule, hyper-parameters,
guard, stats, the tensors' shapes and dtypes) and the finiteness
reduction are counted the first time they run
(``telemetry.efficiency.CostCounter``) and recorded in the program
registry (kind ``optimizer``), which :func:`program_memory` reads; with
``MXTPU_EFFICIENCY`` on each launch is noted in the step window. With
``stats_out`` (a ``MXTPU_NUMERICS`` sampled step) a bucket also computes
its ``(n_params, 6)`` stats matrix (``telemetry.numerics.stats_rows``)
from the tensors its update reads and the new weights it computed, before
they are written. Not ported: ``sparse_rows_update`` (row-sparse tables,
A11) raises ``NotPortedError``.
"""
from __future__ import annotations

import hashlib
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from ..base import MXNetError, check, env
from ..cached_op import CacheInfo
from ..ops import optimizer_ops as _ops
from ..ops.registry import NotPortedError
from ..telemetry import efficiency as _efficiency
from ..telemetry import memory as _memory
from ..telemetry import numerics as _numerics
from .optimizer import adam_lr

__all__ = ["aggregation_size", "eligible", "grouped_update",
           "sparse_rows_update", "prepare_update", "chunk_prepared",
           "apply_chunk", "global_finite_flag", "rollback_counts",
           "cache_info", "clear_cache", "program_memory"]


def aggregation_size() -> int:
    """Bucket-size cap from ``MXTPU_OPTIMIZER_AGGREGATION`` (0 = off)."""
    try:
        return int(env.get("MXTPU_OPTIMIZER_AGGREGATION"))
    except (TypeError, ValueError):
        return 0


# ---------------------------------------------------------------------------
# Per-optimizer grouping rules: ``statics`` is every hyper-parameter the
# bucket kernel binds (part of the cache key); ``make_kernel(opt,
# has_state)`` returns the multi-tensor rule with them bound.
# ---------------------------------------------------------------------------

_RULES: Dict[str, Any] = {}


class _Rule:
    __slots__ = ("name", "statics", "make_kernel")

    def __init__(self, name, statics, make_kernel):
        self.name = name
        self.statics = statics
        self.make_kernel = make_kernel


def _rule(cls_name, statics, make_kernel):
    _RULES[cls_name] = _Rule(cls_name, statics, make_kernel)


def _clipv(cg):
    return -1.0 if cg is None else float(cg)


def _bind(fn, **statics):
    def k(ws, gs, states, lrs, wds, rescale):
        return fn(ws, gs, states, lrs, wds, rescale, **statics)
    return k


def _sgd_statics(opt):
    return (float(opt.momentum), _clipv(opt.clip_gradient))


def _sgd_kernel(opt, has_state):
    clip = _clipv(opt.clip_gradient)
    if not has_state:
        return _bind(_ops.sgd, clip=clip)
    return _bind(_ops.sgd_mom, momentum=float(opt.momentum), clip=clip)


def _nag_kernel(opt, has_state):
    clip = _clipv(opt.clip_gradient)
    if not has_state:
        # NAG without momentum is plain SGD (ref: NAG.update)
        return _bind(_ops.sgd, clip=clip)
    return _bind(_ops.nag_mom, momentum=float(opt.momentum), clip=clip)


def _adam_statics(opt):
    return (float(opt.beta1), float(opt.beta2), float(opt.epsilon),
            _clipv(opt.clip_gradient))


def _adam_kernel(opt, has_state):
    # lr arrives bias-corrected (lr_t), as the per-parameter path makes it
    return _bind(_ops.adam, beta1=float(opt.beta1), beta2=float(opt.beta2),
                 epsilon=float(opt.epsilon), clip=_clipv(opt.clip_gradient))


def _rmsprop_statics(opt):
    return (float(opt.gamma1), float(opt.gamma2), float(opt.epsilon),
            bool(opt.centered), _clipv(opt.clip_gradient),
            _clipv(opt.clip_weights))


def _rmsprop_kernel(opt, has_state):
    kw = dict(gamma1=float(opt.gamma1), epsilon=float(opt.epsilon),
              clip=_clipv(opt.clip_gradient),
              clip_weights=_clipv(opt.clip_weights))
    if not opt.centered:
        return _bind(_ops.rmsprop, **kw)
    return _bind(_ops.rmspropalex, gamma2=float(opt.gamma2), **kw)


_rule("SGD", _sgd_statics, _sgd_kernel)
_rule("NAG", _sgd_statics, _nag_kernel)
_rule("Adam", _adam_statics, _adam_kernel)
_rule("RMSProp", _rmsprop_statics, _rmsprop_kernel)


def _rule_for(opt):
    """Exact-type match only: a subclass may override ``update`` with
    other math, so it must not inherit the parent's rule (LBSGD is
    allowed: it does not override SGD.update)."""
    from . import optimizer as _opt
    t = type(opt)
    if t is _opt.SGD or t is _opt.LBSGD:
        return _RULES["SGD"]
    if t is _opt.NAG:
        return _RULES["NAG"]
    if t is _opt.Adam:
        return _RULES["Adam"]
    if t is _opt.RMSProp:
        return _RULES["RMSProp"]
    return None


# ---------------------------------------------------------------------------
# State flattening. ``create_state_multi_precision`` yields, per parameter:
#   non-mp: None | NDArray | tuple[NDArray, ...]
#   mp    : (inner_state, w32)   (active iff multi_precision and w != f32)
# ---------------------------------------------------------------------------

def _flatten_inner(inner) -> List:
    if inner is None:
        return []
    if isinstance(inner, (tuple, list)):
        return [s for s in inner if s is not None]
    return [inner]


def _state_handles(opt, p, state) -> Tuple[List, bool]:
    """NDArray handles of one parameter's state in rule order; the last is
    the f32 master weight when multi-precision is active."""
    if opt._mp_active(p.data()):
        inner, w32 = state
        return _flatten_inner(inner) + [w32], True
    return _flatten_inner(state), False


# ---------------------------------------------------------------------------
# Cache of bucket kernels
# ---------------------------------------------------------------------------

_CACHE: "OrderedDict[Tuple, Any]" = OrderedDict()
_STATS = {"hits": 0, "misses": 0}


def cache_info() -> CacheInfo:
    return CacheInfo(_STATS["hits"], _STATS["misses"], 0, len(_CACHE), None)


def clear_cache() -> None:
    _CACHE.clear()
    _STATS.update(hits=0, misses=0)


def _get_or_build(sig, build):
    fn = _CACHE.get(sig)
    if fn is None:
        _STATS["misses"] += 1
        fn = _CACHE[sig] = build()
    else:
        _STATS["hits"] += 1
    return fn


#: first tensor of a program's list -> {key: (weakref to its last tensor,
#: registry label)}
_LABELS = WeakTensorKeyDictionary()
_COUNTED: set = set()               # labels counted in this process


def _digest(sig) -> str:
    return hashlib.md5(repr(sig).encode()).hexdigest()[:12]


def _label(prefix: str, key, tensors, sig: Callable[[], Any]) -> str:
    """The registry label of the program over ``tensors``: ``prefix`` and
    the digest of ``sig()`` (the shapes and dtypes it runs on). ``sig`` is
    built only the first time: later steps pass the same persistent
    weight or gradient tensors, found by the first one's identity,
    ``key`` (which holds the list's length) and the last one's."""
    memo = _LABELS.get(tensors[0]) if tensors else None
    hit = memo.get(key) if memo is not None else None
    if hit is not None and hit[0]() is tensors[-1]:
        return hit[1]
    label = f"{prefix}:{_digest(sig())}"
    if tensors:
        if memo is None:
            memo = _LABELS[tensors[0]] = {}
        memo[key] = (weakref.ref(tensors[-1]), label)
    return label


def _run_counted(label, n_params, run, arguments, outputs, note_label):
    """``run()`` as one launch of the program ``("optimizer", label)``:
    counted and recorded the first time (never under a CUDA-graph
    capture, which executes nothing), noted in the efficiency plane's
    step window (as ``note_label``, the JAX package's) when it is on.
    Inside an enclosing program (``efficiency.program_scope``: the
    megastep) it is neither: that program counts and notes it.
    ``arguments`` is a callable, evaluated only when counting."""
    if _efficiency.in_program():
        return run()
    if label not in _COUNTED and \
            not (torch.cuda.is_available() and
                 torch.cuda.is_current_stream_capturing()):
        _COUNTED.add(label)
        args = arguments()
        dev = args[0].device if args else None
        with _efficiency.counting(dev) as c:
            res = run()
        _memory.record_program("optimizer", label, dict(
            c.stats(args, outputs(res)),
            signature=label.rsplit(":", 1)[1], params=n_params))
    else:
        res = run()
    if _efficiency.spec():
        _efficiency.note_dispatch(
            ("optimizer", label), "optimizer", note_label,
            lambda: _memory.get_program("optimizer", label))
    return res


def program_memory(refresh: bool = False) -> Dict[str, dict]:
    """Memory attribution of every bucket program and finiteness
    reduction that has run: ``{signature_digest: {argument_bytes,
    output_bytes, temp_bytes, alias_bytes, generated_code_bytes, flops,
    bytes_accessed, signature, params}}`` from the program registry (kind
    ``optimizer``), each counted on its first execution. ``refresh``
    drops the records, so each program is counted again the next time it
    runs."""
    out: Dict[str, dict] = {}
    for row in _memory.program_report(None):
        if row.get("kind") != "optimizer":
            continue
        if refresh:
            _memory.drop_program("optimizer", row["label"])
            _COUNTED.discard(row["label"])
            continue
        if "argument_bytes" in row and "signature" in row:
            out[row["signature"]] = {k: v for k, v in row.items()
                                     if k not in ("kind", "label")}
    return out


def global_finite_flag(grads) -> torch.Tensor:
    """One 0-d bool tensor on the device: every gradient finite. ``g * 0``
    is 0 where g is finite and NaN where it is not, so the sum of each
    tensor's L1 norm of it is 0 or NaN, whatever the gradients'
    magnitude. Nothing is fetched to the host."""
    grads = list(grads)

    def run():
        zeros = torch._foreach_mul(grads, 0.0)
        norms = torch._foreach_norm(zeros, 1)
        return torch.stack([n.float() for n in norms]).sum() == 0

    name = f"finite_flag:{len(grads)}"
    label = _label(name, ("finite", len(grads)), grads, lambda: (
        "finite", tuple((tuple(g.shape), g.dtype) for g in grads)))
    return _run_counted(label, len(grads), run, lambda: grads,
                        lambda r: (r,), name)


# ---------------------------------------------------------------------------
# The update
# ---------------------------------------------------------------------------

def _grad_nd(p):
    """The parameter's gradient NDArray, or None (frozen / not created)."""
    if p.grad_req == "null" or p.tensor is None:
        return None
    return p.data()._grad


def _is_dense(p) -> bool:
    return _grad_nd(p) is not None


def eligible(updater, items) -> bool:
    """True when EVERY (index, Parameter) item can ride the grouped path:
    the optimizer has a rule and every parameter has a dense gradient.
    All or nothing: the sentinel's skip decision must cover the whole
    parameter set."""
    if not items:
        return False
    if _rule_for(updater.optimizer) is None:
        return False
    return all(_is_dense(p) for _, p in items)


def prepare_update(updater, items):
    """Host half of one aggregated step over ``items``: state creation,
    update-count bumps, then lr / wd resolution (every count bumps before
    any lr is resolved, as in the per-parameter loop). Returns
    ``(prepared, created)``: entries ``(index, Parameter, state_handles,
    mp, lr, wd)`` and the indices whose state this call created (a
    rollback deletes them again)."""
    opt = updater.optimizer
    rule = _rule_for(opt)
    check(rule is not None,
          f"optimizer {type(opt).__name__} has no grouped-update rule")
    for _, p in items:
        if not _is_dense(p):
            raise MXNetError(
                f"grouped optimizer update requires dense parameters with a "
                f"gradient; {p.name!r} has none (grad_req={p.grad_req!r})")
    is_adam = rule.name == "Adam"
    created = []
    for i, p in items:
        if i not in updater.states:
            updater.states[i] = opt.create_state_multi_precision(i, p.data())
            created.append(i)
            _memory.track_optimizer_state(updater, i, updater.states[i],
                                          param=p)
        opt._update_count(i)
    prepared = []
    for i, p in items:
        lr, wd = opt._get_lr(i), opt._get_wd(i)
        if is_adam:
            lr = adam_lr(lr, opt.beta1, opt.beta2,
                         opt._index_update_count[i])
        handles, mp = _state_handles(opt, p, updater.states[i])
        prepared.append((i, p, handles, mp, float(lr), float(wd)))
    return prepared, created


def chunk_prepared(prepared, agg_size: int):
    """Bucket ``prepared`` entries by (weight dtype, device, mp, state
    arity), at most ``agg_size`` each, keeping parameter order."""
    buckets: "OrderedDict[Tuple, List]" = OrderedDict()
    for ent in prepared:
        p, handles, mp = ent[1], ent[2], ent[3]
        t = p.tensor
        buckets.setdefault((t.dtype, t.device, mp, len(handles)),
                           []).append(ent)
    chunks = []
    step = max(1, agg_size)
    for ents in buckets.values():
        for s in range(0, len(ents), step):
            chunks.append(ents[s:s + step])
    return chunks


def apply_chunk(updater, rule, chunk, lrs, wds, rescale,
                sentinel: bool = False, flag=None, stats_out=None):
    """Device half for ONE chunk: its bucket kernel (cached by rule) on
    the chunk's tensors, written in place, guarded by ``flag`` when
    ``sentinel``. ``lrs`` / ``wds`` are the chunk's per-parameter scalars
    and ``rescale`` the gradient scale: Python floats, or (the megastep's
    CUDA graph, whose inputs change every step) a float32 device vector
    slice each and a 0-d float32 device tensor, which round alike
    (``optimizer_ops.scalar``). ``stats_out``: a list to append
    ``(param_names, (n, 6) f32 device matrix)`` to (a numerics sampled
    step). Returns the handled indices."""
    opt = updater.optimizer
    ws = [e[1].tensor for e in chunk]
    gs = [_grad_nd(e[1])._data for e in chunk]
    n_slots = len(chunk[0][2])
    states = [[e[2][k]._data for e in chunk] for k in range(n_slots)]
    mp = chunk[0][3]
    has_state = n_slots - (1 if mp else 0) > 0

    def build():
        k = rule.make_kernel(opt, has_state)
        return _ops.mp(k) if mp else k

    statics = rule.statics(opt)
    kernel = _get_or_build((rule.name, statics, mp, has_state), build)
    collect = stats_out is not None
    key = (rule.name, statics, mp, has_state, bool(sentinel), collect)

    def run():
        nonlocal lrs, wds, rescale
        with torch.no_grad():
            if not isinstance(rescale, torch.Tensor):
                lrs, wds, rescale = list(lrs), list(wds), float(rescale)
            nw, ns = kernel(ws, gs, states, lrs, wds, rescale)
            mat = _numerics.stats_rows(ws, gs, nw) if collect else None
            _ops.commit(ws + [s for slot in states for s in slot],
                        list(nw) + [s for slot in ns for s in slot],
                        flag if sentinel else None)
        return mat

    label = _label(rule.name, (*key, len(ws)), ws, lambda: (
        *key, tuple((tuple(t.shape), t.dtype)
                    for t in ws + gs + [s for slot in states for s in slot])))
    mat = _run_counted(label, len(chunk), run,
                       lambda: ws + gs + [s for slot in states for s in slot],
                       lambda m: ws + [s for slot in states for s in slot]
                       + ([m] if m is not None else []),
                       f"{rule.name}:bucket{len(chunk)}")
    if collect:
        stats_out.append((tuple(e[1].name for e in chunk), mat))
    return [e[0] for e in chunk]


def grouped_update(updater, items, agg_size: int, sentinel: bool = False,
                   sentinel_grads=None, stats_out=None):
    """One aggregated optimizer step over ``items`` ([(index, Parameter)]
    with fresh dense gradients).

    ``sentinel_grads``: the gradient tensors the finiteness flag covers
    (the caller's whole live set, which may be wider than ``items``);
    default the items' own.

    ``stats_out``: a list collecting each bucket's numerics stats
    (:func:`apply_chunk`); None for the stats-free programs.

    Returns ``(handled_indices, n_dispatches, finite_flag, created)``:
    ``finite_flag`` is the device flag when ``sentinel``, else None;
    ``created`` lists the indices whose state this call created."""
    opt = updater.optimizer
    rule = _rule_for(opt)
    prepared, created = prepare_update(updater, items)
    chunks = chunk_prepared(prepared, agg_size)
    flag = None
    if sentinel:
        if sentinel_grads is None:
            sentinel_grads = [_grad_nd(p)._data for _, p in items]
        flag = global_finite_flag(sentinel_grads)
    handled = []
    for chunk in chunks:
        handled += apply_chunk(updater, rule, chunk, [e[4] for e in chunk],
                               [e[5] for e in chunk], opt.rescale_grad,
                               sentinel=sentinel, flag=flag,
                               stats_out=stats_out)
    return handled, len(chunks), flag, created


def sparse_rows_update(opt, weight, states, grad_rows, idx, valid, lr, wd,
                       flag=None):
    raise NotPortedError(
        "grouped.sparse_rows_update (row-sparse tables) is not ported yet "
        "(ROADMAP.md, queue A11)")


def rollback_counts(opt, indices: Sequence[int]) -> None:
    """Undo the host-side update counters after a sentinel-skipped step,
    so Adam's bias correction (and any lr scheduler) sees the same ``t``
    the per-parameter skip path would."""
    for i in indices:
        if i in opt._index_update_count:
            opt._index_update_count[i] -= 1
    counts = list(opt._index_update_count.values())
    opt.num_update = max(counts + [opt.begin_num_update])
