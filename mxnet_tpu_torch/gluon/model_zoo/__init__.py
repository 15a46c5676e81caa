"""Model zoo of the port (ref: python/mxnet/gluon/model_zoo/)."""
from . import vision

__all__ = ["vision"]
