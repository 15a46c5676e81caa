"""Gluon on PyTorch (ref: python/mxnet/gluon/). ``rnn`` is not ported yet
(ROADMAP A14); of ``contrib`` only ``data`` is."""
from . import contrib, data, loss, model_zoo, nn, utils
from .block import Block, HybridBlock, SymbolBlock, nn_block_scope
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "Constant", "HybridBlock", "Parameter", "ParameterDict",
           "SymbolBlock", "Trainer", "contrib", "data", "loss", "model_zoo",
           "nn", "nn_block_scope", "utils"]
