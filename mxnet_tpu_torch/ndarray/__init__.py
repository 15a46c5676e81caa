"""mx.nd — the imperative array API (ref: the JAX package's
``ndarray/__init__.py``; python/mxnet/ndarray/__init__.py).

The NDArray type, creation functions, save/load, and one generated
function per registered op, with the ``_internal`` and ``op``
sub-namespaces; ``contrib`` holds the ``_contrib_`` ops, ``linalg`` the
``_linalg_`` ops and ``random`` the ``_random_`` and ``_sample_`` ops, with
the prefix stripped. ``image`` and ``sparse`` hold nothing ported yet: any
name asked of them, or of ``mx.nd`` itself, that the port lacks raises
``NotPortedError``.
"""
import sys
import types

from ..base import MXNetError
# importing the op modules registers their ops
from ..ops import broadcast as _broadcast  # noqa: F401
from ..ops import contrib_ops as _contrib_ops  # noqa: F401
from ..ops import elemwise as _elemwise  # noqa: F401
from ..ops import flash_attention as _flash_attention  # noqa: F401
from ..ops import linalg as _linalg  # noqa: F401
from ..ops import matrix as _matrix  # noqa: F401
from ..ops import misc_ops as _misc_ops  # noqa: F401
from ..ops import nn as _nn  # noqa: F401
from ..ops import optimizer_ops as _optimizer_ops  # noqa: F401
from ..ops import ordering as _ordering  # noqa: F401
from ..ops import parity_ops as _parity_ops  # noqa: F401
from ..ops import random_ops as _random_ops  # noqa: F401
from ..ops import reduce as _reduce  # noqa: F401
from . import register as _register
from .ndarray import (NDArray, arange, array, concatenate, empty, eye,  # noqa
                      from_torch, full, imperative_invoke, linspace,
                      moveaxis, ones, stack, waitall, zeros)
from .utils import (from_dlpack, load, save, to_dlpack_for_read,  # noqa
                    to_dlpack_for_write)

_this = sys.modules[__name__]
_submodules = {}
for _n in ("_internal", "op", "random", "linalg", "contrib", "image",
           "sparse"):
    _m = types.ModuleType(f"{__name__}.{_n}")
    _m.__getattr__ = _register.not_ported(f"mx.nd.{_n}")
    sys.modules[_m.__name__] = _m
    setattr(_this, _n, _m)
    _submodules[_n] = _m

_register.populate(_this, _submodules)

# creation helpers shadow ops of the same name
from .ndarray import (arange, array, concatenate, empty, eye, full,  # noqa
                      linspace, moveaxis, ones, stack, zeros)

__getattr__ = _register.not_ported("mx.nd")


def split_v2(ary, indices_or_sections, axis=0, squeeze_axis=False):
    """numpy-style split (ref: python/mxnet/ndarray/ndarray.py split_v2):
    an int gives equal sections, a tuple the interior boundaries."""
    if isinstance(indices_or_sections, int):
        if ary.shape[axis] % indices_or_sections:
            raise MXNetError("array split does not result in an equal "
                             "division")
        return imperative_invoke(
            "_split_v2", (ary,),
            {"sections": indices_or_sections, "axis": axis,
             "squeeze_axis": squeeze_axis})
    if isinstance(indices_or_sections, (tuple, list)):
        return imperative_invoke(
            "_split_v2", (ary,),
            {"indices": (0,) + tuple(indices_or_sections), "axis": axis,
             "squeeze_axis": squeeze_axis})
    raise MXNetError("indices_or_sections must be int or tuple of ints")
