"""Gluon layers of the port (ref: python/mxnet/gluon/nn/)."""
from .basic_layers import Activation, BatchNorm, Dense, HybridSequential
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D
from .fused import FusedBatchNormAddReLU, FusedBatchNormReLU

__all__ = ["Activation", "BatchNorm", "Dense", "HybridSequential", "Conv2D",
           "GlobalAvgPool2D", "MaxPool2D", "FusedBatchNormAddReLU",
           "FusedBatchNormReLU"]
