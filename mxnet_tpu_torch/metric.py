"""Evaluation metrics (ref: python/mxnet/metric.py; a copy of the JAX
package's ``metric.py``).

Same registry + update(labels, preds) surface. Internal accumulation is host
numpy — metrics sit at the sync point where training code calls asnumpy()
anyway (ref: Module.update_metric syncs outputs). Labels and predictions
may be NDArrays, torch tensors (on the card or the host) or numpy arrays.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as _np
import torch

from .base import MXNetError, check

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register"]

_METRIC_REGISTRY: Dict[str, type] = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs) -> "EvalMetric":
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        comp = CompositeEvalMetric()
        for m in metric:
            comp.add(create(m, *args, **kwargs))
        return comp
    if isinstance(metric, str):
        aliases = {"acc": "accuracy", "ce": "crossentropy",
                   "nll_loss": "negativeloglikelihood",
                   "top_k_accuracy": "topkaccuracy", "pearsonr":
                   "pearsoncorrelation"}
        name = aliases.get(metric.lower(), metric.lower())
        if name not in _METRIC_REGISTRY:
            raise MXNetError(f"unknown metric {metric!r}")
        return _METRIC_REGISTRY[name](*args, **kwargs)
    raise MXNetError(f"cannot create metric from {metric!r}")


def _as_numpy(x) -> _np.ndarray:
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return _np.asarray(x)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if isinstance(labels, (list, tuple)) != isinstance(preds, (list, tuple)):
        pass
    if not isinstance(labels, (list, tuple)):
        labels = [labels]
    if not isinstance(preds, (list, tuple)):
        preds = [preds]
    check(len(labels) == len(preds),
          f"label/pred count mismatch: {len(labels)} vs {len(preds)}")
    return labels, preds


class EvalMetric:
    """(ref: metric.py EvalMetric)"""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label: Dict, pred: Dict):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def _inc(self, metric, n):
        self.sum_metric += metric
        self.num_inst += n
        self.global_sum_metric += metric
        self.global_num_inst += n

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def update_dict(self, labels, preds):
        for m in self.metrics:
            m.update_dict(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()
        super().reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return (names, values)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_np.int32).ravel()
            label = label.astype(_np.int32).ravel()
            check(len(label) == len(pred), "label/pred length mismatch")
            correct = (pred == label).sum()
            self._inc(float(correct), len(pred))


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names)
        self.top_k = top_k
        check(top_k > 1, "use Accuracy for top_k=1")

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(_np.int32)
            pred = _as_numpy(pred)
            topk = _np.argsort(pred, axis=-1)[:, -self.top_k:]
            correct = (topk == label.reshape(-1, 1)).any(axis=1).sum()
            self._inc(float(correct), len(label))


class _BinaryClassificationHelper:
    def __init__(self):
        self.reset()

    def reset(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred):
        pred_label = pred.argmax(axis=1) if pred.ndim > 1 else (pred > 0.5)
        label = label.astype(_np.int32).ravel()
        pred_label = pred_label.astype(_np.int32).ravel()
        self.tp += int(((pred_label == 1) & (label == 1)).sum())
        self.fp += int(((pred_label == 1) & (label == 0)).sum())
        self.tn += int(((pred_label == 0) & (label == 0)).sum())
        self.fn += int(((pred_label == 0) & (label == 1)).sum())

    @property
    def precision(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def fscore(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0

    @property
    def mcc(self):
        num = self.tp * self.tn - self.fp * self.fn
        den = math.sqrt((self.tp + self.fp) * (self.tp + self.fn) *
                        (self.tn + self.fp) * (self.tn + self.fn))
        return num / den if den else 0.0

    @property
    def total(self):
        return self.tp + self.fp + self.tn + self.fn


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self._helper = _BinaryClassificationHelper()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self._helper.update(_as_numpy(label), _as_numpy(pred))
        self.sum_metric = self._helper.fscore * self._helper.total
        self.num_inst = self._helper.total
        self.global_sum_metric = self.sum_metric
        self.global_num_inst = self.num_inst

    def reset(self):
        if hasattr(self, "_helper"):
            self._helper.reset()
        super().reset()


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._helper = _BinaryClassificationHelper()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self._helper.update(_as_numpy(label), _as_numpy(pred))
        self.sum_metric = self._helper.mcc * self._helper.total
        self.num_inst = self._helper.total

    def reset(self):
        if hasattr(self, "_helper"):
            self._helper.reset()
        super().reset()


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._inc(float(_np.abs(label - pred).mean()), 1)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._inc(float(((label - pred) ** 2).mean()), 1)


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._inc(float(_np.sqrt(((label - pred) ** 2).mean())), 1)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype(_np.int64)
            pred = _as_numpy(pred)
            prob = pred[_np.arange(label.shape[0]), label]
            ce = (-_np.log(prob + self.eps)).sum()
            self._inc(float(ce), label.shape[0])


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(_np.int64)
            pred = _as_numpy(pred)
            probs = _np.take_along_axis(
                pred.reshape(-1, pred.shape[-1]),
                label.reshape(-1, 1), axis=-1).ravel()
            if self.ignore_label is not None:
                ignore = (label.ravel() == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= _np.log(_np.maximum(probs, 1e-10)).sum()
            num += probs.size
        self._inc(float(loss), num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred).ravel()
            r = _np.corrcoef(label, pred)[0, 1]
            self._inc(float(r), 1)


@register
class Loss(EvalMetric):
    """Mean of a loss output (ref: metric.py Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            loss = float(_as_numpy(pred).sum())
            self._inc(loss, int(_np.prod(_as_numpy(pred).shape)))


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self._inc(float(sum_metric), int(num_inst))
            else:
                self._inc(float(reval), 1)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (ref: metric.py np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", "feval")
    return CustomMetric(feval, name, allow_extra_outputs)
