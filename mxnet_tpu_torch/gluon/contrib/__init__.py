"""Gluon contrib (ref: python/mxnet/gluon/contrib/__init__.py). ``data``
and ``rnn`` are ported, and of ``nn`` the row-sparse ``SparseEmbedding``;
every other name of ``nn`` raises ``NotPortedError`` (the long tail,
ROADMAP A14)."""
import sys
import types

from ...ops.registry import NotPortedError
from ..block import Block as _Block
from ..nn.basic_layers import Embedding as _Embedding
from . import data, rnn


def _not_ported(namespace, queue_of):
    def __getattr__(attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise NotPortedError(
            f"gluon.contrib.{namespace}.{attr} is not ported yet "
            f"(ROADMAP.md, queue {queue_of(attr)})")
    return __getattr__


class SparseEmbedding(_Embedding):
    """Embedding whose weight is a row_sparse table with a row_sparse
    gradient (ref: the JAX package's ``gluon/contrib/nn/basic_layers.py``
    SparseEmbedding; contrib/nn/basic_layers.py:118 in the reference):
    the weight's ``stype`` and ``grad_stype`` are ``row_sparse``, so a
    Trainer steps it through the lazy row-sparse update and refuses the
    megastep and ZeRO for it. It is a plain ``Block`` there: ``hybridize``
    compiles nothing, and its gradient stays row_sparse."""

    hybridize = _Block.hybridize

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, prefix=None, device=None):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, prefix=prefix, device=device)
        self.params[self.prefix + "weight"].stype = "row_sparse"

    def __repr__(self):
        return f"SparseEmbedding({self._input_dim} -> {self._output_dim})"


nn = types.ModuleType(f"{__name__}.nn")
nn.SparseEmbedding = SparseEmbedding
nn.__getattr__ = _not_ported("nn", lambda attr: "A14")
sys.modules[nn.__name__] = nn

__all__ = ["data", "nn", "rnn"]
