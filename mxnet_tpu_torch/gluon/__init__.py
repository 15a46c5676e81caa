"""Gluon on PyTorch (ref: python/mxnet/gluon/)."""
from . import loss, model_zoo, nn
from .block import HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["HybridBlock", "Parameter", "ParameterDict", "Trainer", "loss",
           "model_zoo", "nn"]
