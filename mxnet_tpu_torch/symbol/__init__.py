"""``mx.sym``: the symbolic API (ref: the JAX package's
``symbol/__init__.py``; python/mxnet/symbol/__init__.py). A function for
every registry name, and the Symbol, Executor and JSON load / save.
``contrib.foreach`` / ``while_loop`` / ``cond`` build control-flow nodes
(``control_flow.py``); their ops are registered after the namespaces are
filled, so, as in the JAX package, ``mx.nd`` and ``mx.sym`` have no
function for them."""
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


# symbolic control flow (ref: control_flow.cc) as sym.contrib.foreach /
# while_loop / cond, the reference's surface
from . import control_flow as _cf  # noqa: E402
contrib.foreach = _cf.foreach  # noqa: F821
contrib.while_loop = _cf.while_loop  # noqa: F821
contrib.cond = _cf.cond  # noqa: F821


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
