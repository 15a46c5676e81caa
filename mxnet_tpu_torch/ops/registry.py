"""Operator registry (ref: the JAX package's ``ops/registry.py``; the
reference's NNVM op registry and ``Imperative::Invoke``).

Every operator is a plain function ``fn(*tensors, **params)`` over
``torch.Tensor`` values that returns a tensor or a tuple of them, under
the reference's op name (``elemwise_add``, ``dot``, ``SliceChannel``...).
:func:`invoke` calls it eagerly: PyTorch runs each op as it comes, so
there is no compile cache, and autograd records it when the caller runs
it under ``torch.enable_grad()`` (``ndarray.imperative_invoke`` decides
that from ``autograd.record()``).

Storage types (ref: the JAX package's ``register_sparse`` /
``stype_dispatch``; ``FInferStorageType`` and ``FComputeEx`` in the
reference): :func:`register_sparse` adds a kernel for an op and a
signature of input storage types (``("csr", "default")``); the ``mx.nd``
front end asks :func:`stype_dispatch` for it when an input is sparse and
otherwise densifies the inputs, warning once per op and signature
(:func:`storage_fallback_warn`).

Not ported: the JAX package's jit cache, op islands and NaiveEngine
switch (XLA plumbing).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, coerce_param, env

__all__ = ["OpDef", "register", "alias", "get_op", "list_ops", "invoke",
           "normalize_params", "as_tuple_outputs", "NotPortedError",
           "register_sparse", "stype_dispatch", "storage_fallback_warn"]

_OPS: Dict[str, "OpDef"] = {}
_SPARSE_IMPLS: Dict[Tuple[str, Tuple[str, ...]], Callable] = {}
_FALLBACK_WARNED: set = set()


class NotPortedError(MXNetError, AttributeError):
    """An op name the port does not have (yet). It is an AttributeError
    too, so ``hasattr(mx.nd, name)`` stays False for it."""


class OpDef:
    """A registered operator.

    name : canonical op name (reference-compatible).
    fn : ``fn(*tensors, **params) -> tensor | tuple``.
    num_outputs : int, or ``(n_inputs, params) -> int``.
    differentiable : recorded by autograd.
    variadic : takes any number of array inputs.
    rng : draws random numbers (from the ``generator`` it is given, else
        the device's default generator; the JAX package's ops take a key).
    creation : takes no array inputs (``_zeros``, ``_random_uniform``...);
        it makes its output on the ``ctx`` it is given, else the current
        context.
    aux_inputs : input slots that are auxiliary states (BatchNorm's
        moving statistics; ref: OperatorProperty::ListAuxiliaryStates).
    """

    __slots__ = ("name", "fn", "num_outputs", "differentiable", "variadic",
                 "doc", "rng", "aux_inputs", "creation")

    def __init__(self, name: str, fn: Callable, num_outputs=1,
                 differentiable: bool = True, variadic: bool = False,
                 doc: str = "", rng: bool = False,
                 aux_inputs: Sequence[int] = (), creation: bool = False):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.variadic = variadic
        self.doc = doc or (fn.__doc__ or "")
        self.rng = rng
        self.aux_inputs = tuple(aux_inputs)
        self.creation = creation

    def __repr__(self):
        return f"<OpDef {self.name}>"


def _trace_time_flags() -> Tuple:
    """The environment flags that op implementations read at run time
    and that change what a captured program computes (ref: the JAX
    package's ``ops/registry.py _trace_time_flags``). ``CachedOp`` keys
    its signatures on them, so toggling one captures anew instead of
    replaying a graph of the other setting."""
    return (bool(env.get("MXNET_SAFE_ACCUMULATION")),
            env.get("MXNET_RESID_DTYPE") or "",
            env.get("MXNET_CONV_COMPUTE") or "",
            float(env.get("MXNET_CONV_INT8_RANGE")),
            bool(env.get("MXTPU_FUSED_EPILOGUE")))


def register(name: str, aliases: Sequence[str] = (), **kw) -> Callable:
    """Decorator registering an op implementation under ``name``."""

    def deco(fn: Callable) -> Callable:
        if name in _OPS:
            raise MXNetError(f"op {name} already registered")
        opdef = OpDef(name, fn, **kw)
        _OPS[name] = opdef
        for a in aliases:
            _OPS.setdefault(a, opdef)
        return fn

    return deco


def alias(name: str, target: str) -> None:
    _OPS[name] = _OPS[target]


def register_sparse(name: str, stypes: Sequence[str]) -> Callable:
    """Register the kernel of ``name`` for the input storage types
    ``stypes``. It takes the front end's arrays (NDArray or sparse) as
    they come and returns NDArray or sparse outputs (ref: FComputeEx)."""

    def deco(fn: Callable) -> Callable:
        _SPARSE_IMPLS[(name, tuple(stypes))] = fn
        return fn

    return deco


def stype_dispatch(name: str, stypes: Sequence[str]) -> Optional[Callable]:
    """The kernel of ``name`` for these input storage types, or None (the
    dense fallback). Matching: the exact tuple, then signatures ending in
    ``"*"`` (any further inputs) by their head, then ``("*",)``."""
    stypes = tuple(stypes)
    impl = _SPARSE_IMPLS.get((name, stypes))
    if impl is not None:
        return impl
    for (n, sig), fn in _SPARSE_IMPLS.items():
        if n != name or not sig or sig[-1] != "*":
            continue
        head = sig[:-1]
        if stypes[:len(head)] == head:
            return fn
    return _SPARSE_IMPLS.get((name, ("*",)))


def storage_fallback_warn(name: str, stypes: Sequence[str]) -> None:
    """Warn once per (op, storage types) that sparse inputs were
    densified (ref: LogStorageFallback); silenced by
    ``MXNET_STORAGE_FALLBACK_LOG_VERBOSE=0``."""
    key = (name, tuple(stypes))
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    if not env.get("MXNET_STORAGE_FALLBACK_LOG_VERBOSE"):
        return
    import warnings
    warnings.warn(
        f"operator {name} has no sparse kernel for input storage types "
        f"{tuple(stypes)}: falling back to dense compute (inputs densified). "
        "Set MXNET_STORAGE_FALLBACK_LOG_VERBOSE=0 to silence.",
        stacklevel=3)


def get_op(name: str) -> OpDef:
    try:
        return _OPS[name]
    except KeyError:
        raise NotPortedError(
            f"operator {name!r} is not in mxnet_tpu_torch: not ported yet "
            "(see ROADMAP.md, queue A14)") from None


def list_ops() -> List[str]:
    return sorted(_OPS)


def normalize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    return {k: coerce_param(v) for k, v in params.items() if v is not None}


def invoke(opdef: OpDef, tensors: Sequence, params: Dict[str, Any]):
    """Run an op on tensors; returns what the op returns."""
    return opdef.fn(*tensors, **normalize_params(params))


def as_tuple_outputs(out) -> Tuple:
    if isinstance(out, (tuple, list)):
        return tuple(out)
    return (out,)
