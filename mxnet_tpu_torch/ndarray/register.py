"""The generated ``mx.nd.<op>`` functions (ref: the JAX package's
``ndarray/register.py``; python/mxnet/ndarray/register.py).

One front-end function per registered op: NDArray inputs positional
(numbers and numpy arrays become arrays on the first NDArray input's
context), op parameters as keywords, ``out=`` to write into given arrays
and ``ctx=`` to move the result (a creation op makes it there). An op
that takes ``_training`` (BatchNorm, the fused epilogues, Dropout) gets
``autograd.is_training()`` unless the caller passes it. A random op given
no ``generator=`` draws from the stream of its device
(``random.default_generator``), where the JAX front end injects a key. Names
go where the reference puts them: ``_`` names to ``mx.nd._internal``,
``_contrib_<name>`` also to ``mx.nd.contrib.<name>``, ``_linalg_<name>``
to ``mx.nd.linalg.<name>``, ``_random_<name>`` and ``_sample_<name>`` to
``mx.nd.random.<name>``, ``_image_<name>`` to ``mx.nd.image.<name>``;
every op is also in ``mx.nd.op``. A name the port does not have raises
:class:`~mxnet_tpu_torch.ops.registry.NotPortedError` (an MXNetError)
instead of being silently missing.

Storage types (ref: the JAX package's ``register.py``; FInferStorageType
then FComputeEx or the dense fallback in the reference): when an input is
a sparse container, the op's kernel for the inputs' storage types
(``ops/registry.stype_dispatch``) runs on the containers themselves; an
op without one densifies them, warning once.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict

import numpy as _np

from .. import autograd
from ..base import MXNetError
from ..context import Context
from ..ops import registry as _reg
from ..ops.opdoc import signature_and_doc
from . import ndarray as _nd
from . import sparse as _sp


def _takes_training(fn) -> bool:
    try:
        return "_training" in inspect.signature(fn).parameters
    except ValueError:          # a torch builtin registered as it is
        return False


def make_nd_function(name: str, opdef):
    takes_training = _takes_training(opdef.fn)

    def generic(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = kwargs.pop("ctx", None)
        if any(isinstance(a, _sp.BaseSparseNDArray) for a in args):
            stypes = tuple(getattr(a, "stype", "default") for a in args)
            impl = _reg.stype_dispatch(name, stypes)
            if impl is not None:
                return _write_out(impl(*args, **kwargs), out)
            _reg.storage_fallback_warn(name, stypes)
            args = tuple(a.todense() if isinstance(a, _sp.BaseSparseNDArray)
                         else a for a in args)
        if takes_training and "_training" not in kwargs:
            kwargs["_training"] = autograd.is_training()
        home = next((a.context for a in args if isinstance(a, _nd.NDArray)),
                    None)
        if opdef.creation:          # the op makes its output on ctx
            kwargs["ctx"], ctx = ctx, None
        inputs = []
        for a in args:
            if isinstance(a, _nd.NDArray):
                inputs.append(a)
            elif isinstance(a, (_np.ndarray, list, tuple, int, float)):
                inputs.append(_nd.array(_np.asarray(a), ctx=home))
            else:
                raise MXNetError(
                    f"{name}: positional argument {a!r} is not an NDArray; "
                    "pass op parameters as keywords")
        result = _nd.imperative_invoke(name, tuple(inputs), kwargs, out=out)
        if ctx is not None and out is None:
            c = Context(ctx)
            if isinstance(result, _nd.NDArray):
                result = result.as_in_context(c)
            else:
                result = tuple(r.as_in_context(c) for r in result)
        return result

    generic.__name__ = name
    generic.__qualname__ = name
    generic.__module__ = "mxnet_tpu_torch.ndarray.op"
    # the typed signature and numpydoc docstring from the registry entry
    # (ref: python/mxnet/ndarray/register.py): help(nd.Convolution)
    # lists the op's parameters
    sig, doc = signature_and_doc(name, opdef, creation=opdef.creation)
    generic.__signature__ = sig
    generic.__doc__ = doc
    return generic


def _write_out(result, out):
    """A storage kernel's result, written into ``out`` when given: a
    row_sparse result into a row_sparse ``out`` keeps it compact, any
    other into a dense one."""
    if out is None:
        return result
    if isinstance(result, _sp.RowSparseNDArray) and \
            isinstance(out, _sp.RowSparseNDArray):
        out._update(result._data, result._indices, result._indices_np)
    elif isinstance(result, _sp.BaseSparseNDArray):
        out._write(result.todense()._data)
    else:
        out._write(result._data)
    return out


def not_ported(namespace: str):
    """A module ``__getattr__`` that names what is missing."""
    def __getattr__(attr: str):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise _reg.NotPortedError(
            f"{namespace}.{attr} is not in mxnet_tpu_torch: not ported yet "
            "(see ROADMAP.md, queue A14)")
    return __getattr__


def populate(target_module, submodules: Dict[str, Any]) -> None:
    """Build every front-end function and install it into ``mx.nd``,
    ``mx.nd._internal``, ``mx.nd.contrib`` and ``mx.nd.op``."""
    made = {}
    for name in _reg.list_ops():
        opdef = _reg.get_op(name)
        fn = made.get(id(opdef))
        if fn is None or opdef.name == name:
            fn = make_nd_function(name, opdef)
            if opdef.name == name:
                made[id(opdef)] = fn
        for prefix, sub in (("_contrib_", "contrib"), ("_linalg_", "linalg"),
                            ("_random_", "random"), ("_sample_", "random"),
                            ("_image_", "image")):
            if name.startswith(prefix):
                setattr(submodules[sub], name[len(prefix):], fn)
        if name.startswith("_"):
            setattr(submodules["_internal"], name, fn)
        else:
            setattr(target_module, name, fn)
        setattr(submodules["op"], name, fn)
