"""``mx.sym``: the symbolic API (ref: the JAX package's
``symbol/__init__.py``; python/mxnet/symbol/__init__.py). A function for
every registry name, and the Symbol, Executor and JSON load / save.
``contrib.foreach`` / ``while_loop`` / ``cond`` (symbolic control flow)
raise ``NotPortedError`` (ROADMAP A14)."""
import sys
import types

from .. import ndarray as _ndarray  # noqa: F401  (registers every op)
from ..base import MXNetError
from ..ndarray.register import not_ported as _not_ported
from . import register as _register
from .symbol import Symbol, var, Variable, Group, load, load_json  # noqa
from .executor import Executor  # noqa: F401,E402

_this = sys.modules[__name__]
_submodules = {}
for _n in ("random", "linalg", "contrib", "image", "_internal", "op",
           "sparse"):
    _m = types.ModuleType(__name__ + "." + _n)
    _m.__getattr__ = _not_ported(f"mx.sym.{_n}")
    sys.modules[__name__ + "." + _n] = _m
    setattr(_this, _n, _m)
    _submodules[_n] = _m

_register.populate(_this, _submodules)


def _control_flow(name):
    def f(*args, **kwargs):
        from .symbol import not_ported_node
        raise not_ported_node(f"_{name}")
    f.__name__ = name
    return f


for _n in ("foreach", "while_loop", "cond"):
    setattr(contrib, _n, _control_flow(_n))  # noqa: F821


def split_v2(data, indices_or_sections, axis=0, squeeze_axis=False):
    """Symbolic split_v2 (ref: python/mxnet/symbol/symbol.py split_v2)."""
    if isinstance(indices_or_sections, int):
        return _internal._split_v2(  # noqa: F821
            data, sections=indices_or_sections, axis=axis,
            squeeze_axis=squeeze_axis)
    if isinstance(indices_or_sections, (tuple, list)):
        return _internal._split_v2(  # noqa: F821
            data, indices=(0,) + tuple(indices_or_sections), axis=axis,
            squeeze_axis=squeeze_axis)
    raise MXNetError("indices_or_sections must be int or tuple of ints")


__getattr__ = _not_ported("mx.sym")
