"""Gluon on PyTorch (ref: python/mxnet/gluon/). Of ``contrib``, ``data``,
``rnn`` and ``nn.SparseEmbedding`` are ported; the rest of ``contrib.nn``
waits (ROADMAP A14)."""
from . import contrib, data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock, nn_block_scope
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "Constant", "HybridBlock", "Parameter", "ParameterDict",
           "SymbolBlock", "Trainer", "contrib", "data", "loss", "model_zoo",
           "nn", "nn_block_scope", "rnn", "utils"]
