"""Gluon losses (ref: the JAX package's ``gluon/loss.py``;
python/mxnet/gluon/loss.py).

Each loss is a block on tensors: ``loss(pred, label[, sample_weight])``
returns one value per sample, the mean over every axis but
``batch_axis`` (f32 accumulation), after ``sample_weight`` and the
scalar ``weight``. ``TripletLoss`` sums instead, and
``CosineEmbeddingLoss`` and ``CTCLoss`` are per sample already.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import nn as F
from ..ops.ctc import ctc_loss
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "CTCLoss", "KLDivLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "CosineEmbeddingLoss"]


def _relu(x):
    return torch.maximum(x, x.new_zeros(()))


def _softrelu(x):
    return F.activation(x, act_type="softrelu")


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, prefix=None):
        super().__init__(prefix=prefix)
        self._weight = weight
        self._batch_axis = batch_axis

    def _weighted(self, loss, sample_weight, weight=None):
        """(ref: loss.py _apply_weighting)"""
        weight = self._weight if weight is None else weight
        if sample_weight is not None:
            loss = loss * sample_weight
        if weight is not None:
            loss = loss * weight
        return loss

    def _batch_mean(self, loss):
        """Mean over every axis but the batch axis (MXNet's
        ``mean(axis=batch_axis, exclude=True)``), f32 accumulation."""
        batch = self._batch_axis % loss.dim()
        axes = [a for a in range(loss.dim()) if a != batch]
        if not axes:        # (batch,): per sample already (torch would
            return loss     # take an empty dim list as every dim)
        return loss.float().mean(dim=axes).to(loss.dtype)

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``."""

    def __init__(self, weight=1.0, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        return self._batch_mean(self._weighted(loss, sample_weight,
                                               self._weight / 2))


class L1Loss(Loss):
    """``|label - pred|``."""

    def __init__(self, weight=1.0, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        return self._batch_mean(self._weighted(loss, sample_weight))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (of ``pred`` itself with
    ``from_sigmoid``), in the numerically stable form ``(1 - z) x +
    (1 + (pw - 1) z) log(1 + e^-x)``; ``pos_weight`` weighs the positive
    term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            log1pexp = _softrelu(-pred)
            if pos_weight is None:
                loss = (1.0 - label) * pred + log1pexp
            else:
                loss = (1.0 - label) * pred \
                    + (1.0 + (pos_weight - 1.0) * label) * log1pexp
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1.0 - pred + eps) * (1.0 - label))
        return self._batch_mean(self._weighted(loss, sample_weight))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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
        return self._batch_mean(self._weighted(loss, sample_weight))


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class CTCLoss(Loss):
    """CTC loss over ``ops/ctc.py`` with the blank the LAST class, the
    reference's Gluon convention (the op's own default is ``first``):
    ``loss(pred, label, pred_lengths=None, label_lengths=None,
    sample_weight=None)``, one value per sample. ``layout`` NTC or TNC,
    ``label_layout`` NT or TN."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 prefix=None):
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"unsupported layout {layout}")
        if label_layout not in ("NT", "TN"):
            raise MXNetError(f"unsupported label_layout {label_layout}")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), prefix=prefix)

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        lengths = [x for x in (pred_lengths, label_lengths) if x is not None]
        loss = ctc_loss(pred, label, *lengths,
                        use_data_lengths=pred_lengths is not None,
                        use_label_lengths=label_lengths is not None,
                        blank_label="last")
        return self._weighted(loss, sample_weight)


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``, ``pred`` log-probabilities
    (``from_logits``) or logits put through ``log_softmax``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        return self._batch_mean(self._weighted(loss, sample_weight))


class HuberLoss(Loss):
    """``|d| - rho / 2`` where ``|d| > rho``, else ``d^2 / (2 rho)``."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        return self._batch_mean(self._weighted(loss, sample_weight))


class HingeLoss(Loss):
    """``relu(margin - pred * label)``, labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = _relu(self._margin - pred * label.reshape(pred.shape))
        return self._batch_mean(self._weighted(loss, sample_weight))


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label)^2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(
            _relu(self._margin - pred * label.reshape(pred.shape)))
        return self._batch_mean(self._weighted(loss, sample_weight))


class LogisticLoss(Loss):
    """``log(1 + e^(-pred * label))`` in a stable form; ``label_format``
    "signed" ({-1, 1}) or "binary" ({0, 1})."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"bad label_format {label_format}")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = _relu(pred) - pred * label + _softrelu(-torch.abs(pred))
        return self._batch_mean(self._weighted(loss, sample_weight))


class TripletLoss(Loss):
    """``relu(sum(|pos - pred|^2 - |neg - pred|^2) + margin)`` per
    sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        batch = self._batch_axis % pred.dim()
        axes = [a for a in range(pred.dim()) if a != batch]
        loss = (torch.square(positive - pred)
                - torch.square(negative - pred)).sum(dim=axes)
        return self._weighted(_relu(loss + self._margin), sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` for label 1, ``relu(cos - margin)``
    otherwise, per sample."""

    def __init__(self, weight=None, batch_axis=0, margin=0, prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input1.shape[0], -1)
        input2 = input2.reshape(input2.shape[0], -1)
        cos = (input1 * input2).sum(dim=1) / (
            torch.linalg.vector_norm(input1, dim=1)
            * torch.linalg.vector_norm(input2, dim=1) + 1e-12)
        loss = torch.where(label.reshape(-1) == 1, 1.0 - cos,
                           _relu(cos - self._margin))
        return self._weighted(loss, sample_weight)
