"""Custom Python operators, ``mx.operator`` (ref: the JAX package's
``operator.py``; python/mxnet/operator.py and
src/operator/custom/custom-inl.h in the reference).

The user API is the reference's: a ``CustomOpProp`` subclass registered
with ``@mx.operator.register(name)`` declares names, shapes and types and
makes a ``CustomOp``, whose ``forward`` / ``backward`` fill ``out_data``
/ ``in_grad`` through ``assign``; ``mx.nd.Custom(*inputs,
op_type=name, **kwargs)`` (also ``mx.sym.Custom`` and ``F.Custom`` in a
``hybrid_forward``) runs it. One ``CustomOp`` instance is made per
(op type, keyword arguments, input signature) and serves both passes.

The JAX package runs the user's code on the host through
``jax.pure_callback`` under a ``custom_vjp``. Here the op is one
``torch.autograd.Function``, and the NDArrays the user's ``forward`` and
``backward`` get (``in_data``, ``out_data``, ``out_grad``, ``in_grad``,
``aux``) live on the device of the op's inputs, the card when the inputs
are on the card: the user's ``mx.nd`` code runs there, with recording
off, and nothing goes through the host unless that code asks for it
(``asnumpy``). Inside a hybridized block on the card the user's code runs
during the CUDA graph's warm-up and capture and its kernels replay after,
so it must not read values on the host or keep per-call Python state
there; an eager call runs it every time. ``backward`` defaults to zero
gradients; auxiliary states get none.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple

import numpy as _np
import torch

from .base import MXNetError, check, numpy_dtype, torch_dtype
from .ops import registry as _reg

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "NumpyOp", "NDArrayOp"]

_REGISTRY: Dict[str, type] = {}
_REG_LOCK = threading.Lock()


class CustomOp:
    """Base class for custom operators (ref: python/mxnet/operator.py
    ``class CustomOp``). Override ``forward`` and ``backward``."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute outputs from ``in_data`` into ``out_data``."""
        raise NotImplementedError("CustomOp.forward must be overridden")

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute input gradients into ``in_grad``; default: zeros."""
        for i, g in enumerate(in_grad):
            self.assign(g, req[i] if i < len(req) else "write",
                        _zeros_like_nd(g))

    @staticmethod
    def assign(dst, req, src):
        """Write ``src`` into ``dst`` as the write request says (ref
        OpReqType: null / write / inplace / add)."""
        if req in ("null", 0):
            return
        if req in ("add", "add_to", 3):
            dst[:] = dst + src
        else:  # write / inplace
            dst[:] = src


class CustomOpProp:
    """Declarative half of a custom op (ref ``class CustomOpProp``):
    names, shapes, types, and the factory for the imperative half."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = bool(need_top_grad)
        # the call site's keyword arguments as strings, as the reference
        # passes op parameters
        self._kwargs: Dict[str, str] = {}

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        """Default: one output of the first input's shape per output."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        t = in_type[0] if in_type else _np.float32
        return ([t] * len(in_type),
                [t] * len(self.list_outputs()),
                [t] * len(self.list_auxiliary_states()))

    def infer_storage_type(self, in_stype):
        return (in_stype, ["default"] * len(self.list_outputs()),
                ["default"] * len(self.list_auxiliary_states()))

    def infer_storage_type_backward(self, ograd_stype, in_stype, out_stype,
                                    igrad_stype, aux_stype):
        return (ograd_stype, in_stype, out_stype,
                ["default"] * len(igrad_stype), aux_stype)

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """Which arrays backward needs (declarative: the op keeps its
        inputs and outputs for backward in any case)."""
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError("CustomOpProp.create_operator must be "
                                  "overridden")


def register(reg_name: str):
    """Class decorator registering a ``CustomOpProp`` subclass under
    ``op_type=reg_name`` (ref: mx.operator.register)."""

    def deco(prop_cls: type) -> type:
        check(isinstance(prop_cls, type) and
              issubclass(prop_cls, CustomOpProp),
              f"register({reg_name!r}) expects a CustomOpProp subclass, "
              f"got {prop_cls!r}")
        with _REG_LOCK:
            _REGISTRY[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered() -> List[str]:
    return sorted(_REGISTRY)


def _get_prop(op_type: str, kwargs: Dict[str, str]) -> CustomOpProp:
    try:
        cls = _REGISTRY[op_type]
    except KeyError:
        raise MXNetError(
            f"custom op type {op_type!r} is not registered; known: "
            f"{get_all_registered()}") from None
    # the reference passes user kwargs to the prop constructor as strings
    try:
        prop = cls(**kwargs)
    except TypeError:
        prop = cls()
    prop._kwargs = dict(kwargs)
    return prop


def _nd():
    from .ndarray import ndarray as nd
    return nd


def _zeros_like_nd(arr):
    return _nd().NDArray(torch.zeros_like(arr._data))


class _OpInstanceCache:
    """One live CustomOp per (op type, kwargs, input signature), shared by
    forward and backward (ref: custom.cc CreateState, once at bind)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: Dict[Tuple, CustomOp] = {}

    def get(self, key: Tuple, prop: CustomOpProp, ctx, shapes,
            dtypes) -> CustomOp:
        with self._lock:
            inst = self._cache.get(key)
            if inst is None:
                inst = self._cache[key] = prop.create_operator(ctx, shapes,
                                                               dtypes)
            return inst


_INSTANCES = _OpInstanceCache()


def _split_str_kwargs(params: Dict[str, Any]) -> Dict[str, str]:
    return {k: str(v) for k, v in params.items()}


def _user_call(fn, *args):
    """The user's forward / backward with recording off (its ``mx.nd``
    ops are the op's insides, not nodes of the caller's record)."""
    from . import autograd
    prev = autograd.set_recording(False)
    try:
        with torch.no_grad():
            fn(*args)
    finally:
        autograd.set_recording(prev)


class _CustomFunction(torch.autograd.Function):
    """The op as one autograd node over the user's forward / backward."""

    @staticmethod
    def forward(ctx, op, prop, is_train, n_args, specs, *inputs):
        nd = _nd()
        nd_in = [nd.NDArray(x) for x in inputs[:n_args]]
        nd_aux = [nd.NDArray(x) for x in inputs[n_args:]]
        dev = inputs[0].device
        nd_out = [nd.NDArray(torch.zeros(s, dtype=d, device=dev))
                  for s, d in specs]
        _user_call(op.forward, is_train, ["write"] * len(nd_out), nd_in,
                   nd_out, nd_aux)
        outs = tuple(o._data for o in nd_out)
        ctx.op, ctx.prop, ctx.n_args = op, prop, n_args
        ctx.save_for_backward(*inputs, *outs)
        ctx.n_in = len(inputs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        nd = _nd()
        saved = ctx.saved_tensors
        inputs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        n_args = ctx.n_args
        nd_og = [nd.NDArray(g if g is not None else torch.zeros_like(o))
                 for g, o in zip(grads, outs)] \
            if ctx.prop.need_top_grad_ else []
        nd_in = [nd.NDArray(x) for x in inputs[:n_args]]
        nd_aux = [nd.NDArray(x) for x in inputs[n_args:]]
        nd_ig = [nd.NDArray(torch.zeros_like(x)) for x in inputs[:n_args]]
        _user_call(ctx.op.backward, ["write"] * n_args, nd_og, nd_in,
                   [nd.NDArray(o) for o in outs], nd_ig, nd_aux)
        return (None, None, None, None, None,
                *[g._data for g in nd_ig],
                *[None] * (len(inputs) - n_args))


def _custom_impl(*inputs, op_type: str, _training: bool = False, **kwargs):
    """The registered ``Custom`` op: the user's ``CustomOp`` as one
    autograd node (``_CustomFunction``). ``_training`` is the front end's
    ``autograd.is_training()``, the ``is_train`` the user's forward
    gets."""
    from .context import Context
    str_kwargs = _split_str_kwargs(kwargs)
    prop = _get_prop(op_type, str_kwargs)
    n_args = len(prop.list_arguments())
    n_aux = len(prop.list_auxiliary_states())
    n_out = len(prop.list_outputs())
    check(len(inputs) == n_args + n_aux,
          f"Custom({op_type}): expected {n_args} arguments + {n_aux} "
          f"auxiliary states, got {len(inputs)} inputs")
    data_in = inputs[:n_args]
    ishapes, oshapes, _ = prop.infer_shape([list(x.shape) for x in data_in])
    itypes, otypes, _ = prop.infer_type(
        [numpy_dtype(x.dtype) for x in data_in])
    specs = tuple((tuple(s), torch_dtype(t))
                  for s, t in zip(oshapes, otypes))
    sig = tuple((tuple(x.shape), str(x.dtype)) for x in data_in)
    op = _INSTANCES.get((op_type, tuple(sorted(str_kwargs.items())), sig),
                        prop, Context(inputs[0].device),
                        [list(s) for s in ishapes], list(itypes))
    outs = _CustomFunction.apply(op, prop, bool(_training), n_args, specs,
                                 *inputs)
    return outs if n_out > 1 else outs[0]


def _custom_n_out(n_inputs: int, params: Dict[str, Any]) -> int:
    op_type = params.get("op_type")
    if op_type is None:
        raise MXNetError("Custom requires an op_type= keyword")
    prop = _get_prop(str(op_type),
                     _split_str_kwargs({k: v for k, v in params.items()
                                        if k not in ("op_type", "_training")}))
    return len(prop.list_outputs())


_reg.register("Custom", num_outputs=_custom_n_out, variadic=True,
              doc=__doc__)(_custom_impl)


class NumpyOp:
    """Deprecated in the reference (python/mxnet/operator.py PythonOp);
    a named stub pointing users at CustomOp."""

    def __init__(self, *a, **kw):
        raise MXNetError("NumpyOp/PythonOp are deprecated upstream; "
                         "subclass mx.operator.CustomOp + CustomOpProp "
                         "and mx.operator.register instead")


NDArrayOp = NumpyOp
