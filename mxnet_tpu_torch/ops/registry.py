"""Operator registry (ref: the JAX package's ``ops/registry.py``; the
reference's NNVM op registry and ``Imperative::Invoke``).

Every operator is a plain function ``fn(*tensors, **params)`` over
``torch.Tensor`` values that returns a tensor or a tuple of them, under
the reference's op name (``elemwise_add``, ``dot``, ``SliceChannel``...).
:func:`invoke` calls it eagerly: PyTorch runs each op as it comes, so
there is no compile cache, and autograd records it when the caller runs
it under ``torch.enable_grad()`` (``ndarray.imperative_invoke`` decides
that from ``autograd.record()``).

Not ported: the JAX package's jit cache, op islands and NaiveEngine
switch (XLA plumbing), and ``register_sparse`` / ``stype_dispatch``
(sparse storage; ROADMAP).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

from ..base import MXNetError, coerce_param

__all__ = ["OpDef", "register", "alias", "get_op", "list_ops", "invoke",
           "normalize_params", "as_tuple_outputs", "NotPortedError"]

_OPS: Dict[str, "OpDef"] = {}


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


def get_op(name: str) -> OpDef:
    try:
        return _OPS[name]
    except KeyError:
        raise NotPortedError(
            f"operator {name!r} is not in mxnet_tpu_torch: not ported yet "
            "(see ROADMAP.md, queue A)") from None


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
