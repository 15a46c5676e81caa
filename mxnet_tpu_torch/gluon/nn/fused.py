"""Fused conv-epilogue layers: BatchNorm(+residual add)+ReLU as one block
(ref: the JAX package's gluon/nn/fused.py).

Channel-last training goes through the fused CUDA kernels
(ops/fused_bn_act.py); other axes take the composed lowering. Both
subclass :class:`BatchNorm` and hold exactly its parameters, deferred
channels included (``in_channels=0`` is read from ``x``, ref: the JAX
package's ``gluon/nn/fused.py:60``); the mode is
``autograd.is_training()``, as for BatchNorm.
"""
from __future__ import annotations

from ... import autograd
from ...ops import nn as F
from .basic_layers import BatchNorm

__all__ = ["FusedBatchNormReLU", "FusedBatchNormAddReLU"]


class FusedBatchNormReLU(BatchNorm):
    """``relu(BatchNorm(x))`` in one op."""

    def forward(self, x):
        return self._fused(x, None)

    def _fused(self, x, residual):
        training = autograd.is_training()
        out, mean, var = F.fused_bn_act_impl(
            x, residual, self.gamma, self.beta, self.running_mean,
            self.running_var, eps=self._epsilon, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            _training=training)
        self._update_running_stats(training, mean, var)
        return out


class FusedBatchNormAddReLU(FusedBatchNormReLU):
    """``relu(BatchNorm(x) + residual)`` — the ResNet block tail, called
    as ``block(x, residual)``."""

    def forward(self, x, residual):
        return self._fused(x, residual)
