"""The generated ``mx.sym.<op>`` functions (ref: the JAX package's
``symbol/register.py``; python/mxnet/symbol/register.py).

One function per registry name, built from the same op records as
``mx.nd``'s: Symbol inputs positional or by keyword, op parameters as
keywords, ``name=`` for the node. The names go where ``mx.nd`` puts them
(``_internal``, ``contrib``, ``linalg``, ``random``, ``image``, ``op``).
"""
from __future__ import annotations

from typing import Any, Dict

from ..base import MXNetError
from ..ops import registry as _reg
from ..ops.opdoc import signature_and_doc
from . import symbol as _sym


def make_sym_function(name: str, opdef):
    def generic(*args, **kwargs):
        node_name = kwargs.pop("name", None)
        kwargs.pop("attr", None)
        inputs = []
        params: Dict[str, Any] = {}
        for a in args:
            if not isinstance(a, _sym.Symbol):
                raise MXNetError(f"sym.{name}: positional args must be "
                                 "Symbols; pass parameters as keywords")
            inputs.append(a)
        for k, v in kwargs.items():
            if isinstance(v, _sym.Symbol):
                inputs.append(v)
            else:
                params[k] = v
        return _sym.create(name, inputs, params, name=node_name)

    generic.__name__ = name
    generic.__qualname__ = name
    generic.__module__ = "mxnet_tpu_torch.symbol.op"
    sig, doc = signature_and_doc(name, opdef, creation=opdef.creation,
                                 symbol=True)
    generic.__signature__ = sig
    generic.__doc__ = doc
    return generic


def populate(target_module, submodules: Dict[str, Any]) -> None:
    for name in _reg.list_ops():
        fn = make_sym_function(name, _reg.get_op(name))
        if name.startswith("_contrib_"):
            setattr(submodules["contrib"], name[len("_contrib_"):], fn)
        elif name.startswith("_linalg_"):
            setattr(submodules["linalg"], name[len("_linalg_"):], fn)
        elif name.startswith("_image_"):
            setattr(submodules["image"], name[len("_image_"):], fn)
        if name.startswith("_"):
            setattr(submodules["_internal"], name, fn)
            if name.startswith("_random_"):
                setattr(submodules["random"], name[len("_random_"):], fn)
            elif name.startswith("_sample_"):
                setattr(submodules["random"], name[len("_sample_"):], fn)
        else:
            setattr(target_module, name, fn)
        setattr(submodules["op"], name, fn)
