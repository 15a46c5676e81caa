"""Gluon contrib (ref: python/mxnet/gluon/contrib/__init__.py). ``data``
is ported; ``nn`` and ``rnn`` raise ``NotPortedError`` for every name:
``nn.SparseEmbedding`` waits for sparse (ROADMAP A11), the rest of ``nn``
and ``rnn`` for the long tail (A14)."""
import sys
import types

from ...ops.registry import NotPortedError
from . import data


def _not_ported(namespace, queue_of):
    def __getattr__(attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise NotPortedError(
            f"gluon.contrib.{namespace}.{attr} is not ported yet "
            f"(ROADMAP.md, queue {queue_of(attr)})")
    return __getattr__


nn = types.ModuleType(f"{__name__}.nn")
nn.__getattr__ = _not_ported(
    "nn", lambda attr: "A11" if attr == "SparseEmbedding" else "A14")
rnn = types.ModuleType(f"{__name__}.rnn")
rnn.__getattr__ = _not_ported("rnn", lambda attr: "A14")
for _m in (nn, rnn):
    sys.modules[_m.__name__] = _m

__all__ = ["data", "nn", "rnn"]
