"""Gluon on PyTorch (ref: python/mxnet/gluon/)."""
from . import loss, model_zoo, nn
from .block import HybridBlock
from .parameter import Parameter, ParameterDict

__all__ = ["HybridBlock", "Parameter", "ParameterDict", "loss", "model_zoo",
           "nn"]
