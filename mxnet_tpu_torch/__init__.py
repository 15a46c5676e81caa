"""mxnet_tpu_torch: the MXNet-class framework on PyTorch and CUDA for one
NVIDIA H100 (Hopper), beside the JAX package it is ported from.

It imports torch and numpy, never jax and nothing of the JAX package.
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, ``ctx=mx.cpu()`` or ``with mx.cpu():``); the default
context is ``gpu(0)``, and with no card and no device given they raise.
The hand-written CUDA kernels under ``csrc/`` are built with nvcc at first
use into ``build/mxnet_tpu_torch/``; ``rtc.CudaModule`` compiles user
kernels with NVRTC through one of them.
"""
from . import (autograd, context, convert, gluon, initializer, kvstore,
               lr_scheduler, models, ndarray, optimizer, ops, parallel,
               random, rtc)
from . import (cached_op, callback, contrib, fault, fit, image, io, log,
               megastep, metric, monitor, profiler, recordio, telemetry,
               util)
from .base import MXNetError, check
from .context import Context, cpu, current_context, gpu, num_gpus

init = initializer
kv = kvstore
nd = ndarray

__version__ = "0.1.0"

__all__ = ["Context", "MXNetError", "autograd", "cached_op", "callback",
           "check", "context", "contrib", "convert", "cpu",
           "current_context", "fault", "fit", "gpu", "gluon", "image",
           "init", "initializer", "io", "kv", "kvstore", "log",
           "lr_scheduler", "megastep", "metric", "models", "monitor", "nd",
           "ndarray", "num_gpus", "ops", "optimizer", "parallel",
           "profiler", "random", "recordio", "rtc", "telemetry", "util"]
