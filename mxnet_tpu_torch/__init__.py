"""mxnet_tpu_torch: the MXNet-class framework on PyTorch and CUDA for one
NVIDIA H100 (Hopper), beside the JAX package it is ported from.

It imports torch and numpy, never jax and nothing of the JAX package.
Entry points run on the card unless the caller passes ``device="cpu"``; with
no card and no device given they raise. The hand-written CUDA kernels under
``csrc/`` are built with nvcc at first use into ``build/mxnet_tpu_torch/``.
"""
from . import (context, convert, gluon, initializer, models, ops, parallel,
               random)
from .base import MXNetError, check
from .context import cpu, gpu

init = initializer

__version__ = "0.1.0"

__all__ = ["MXNetError", "check", "context", "convert", "cpu", "gpu", "gluon",
           "init", "initializer", "models", "ops", "parallel", "random"]
