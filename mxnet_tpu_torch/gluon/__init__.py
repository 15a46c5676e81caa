"""Gluon on PyTorch (ref: python/mxnet/gluon/). ``data``, ``rnn`` and
``contrib`` are not ported yet (ROADMAP A20, A14)."""
from . import loss, model_zoo, nn, utils
from .block import Block, HybridBlock, SymbolBlock, nn_block_scope
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "Constant", "HybridBlock", "Parameter", "ParameterDict",
           "SymbolBlock", "Trainer", "loss", "model_zoo", "nn",
           "nn_block_scope", "utils"]
