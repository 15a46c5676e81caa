"""Gluon losses (ref: python/mxnet/gluon/loss.py). The slice needs
SoftmaxCrossEntropyLoss only."""
from __future__ import annotations

import torch

from ..ops import nn as F
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, prefix=None):
        super().__init__(prefix=prefix)
        self._weight = weight
        self._batch_axis = batch_axis

    def _batch_mean(self, loss):
        """Mean over every axis but the batch axis (MXNet's
        ``mean(axis=batch_axis, exclude=True)``), f32 accumulation."""
        batch = self._batch_axis % loss.dim()
        axes = [a for a in range(loss.dim()) if a != batch]
        return loss.float().mean(dim=axes).to(loss.dtype)


class SoftmaxCrossEntropyLoss(Loss):
    """(ref: gluon/loss.py SoftmaxCrossEntropyLoss). Sparse labels may be
    float (as MXNet feeds them); they are picked as integer class ids,
    clipped to the valid range like MXNet's ``pick``."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            idx = label.long().clamp(0, pred.shape[self._axis] - 1)
            loss = -torch.gather(pred, self._axis,
                                 idx.unsqueeze(self._axis))
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(
                dim=self._axis, keepdim=True)
        if sample_weight is not None:
            loss = loss * sample_weight
        if self._weight is not None:
            loss = loss * self._weight
        return self._batch_mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
