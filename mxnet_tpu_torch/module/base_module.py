"""BaseModule: the symbolic training harness (ref: the JAX package's
``module/base_module.py``; python/mxnet/module/base_module.py ``fit``,
``score``, ``predict``).

``fit`` binds, initialises the parameters (``Uniform(0.01)`` unless told
otherwise) and the optimizer, then runs ``forward_backward`` and
``update`` over every batch of every epoch, with the metric, the
callbacks (batch end: a ``BatchEndParam``; epoch end: ``(epoch, symbol,
arg_params, aux_params)``) and an optional ``Monitor``, and ``score`` on
``eval_data`` after each epoch.
"""
from __future__ import annotations

import logging
import time
from typing import List

from .. import metric as metric_mod
from ..base import check
from ..ndarray import ndarray as _nd

__all__ = ["BaseModule", "BatchEndParam"]


def _as_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.inputs_need_grad = False
        self._symbol = None

    # -- abstract surface ----------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    def bind(self, *args, **kwargs):
        raise NotImplementedError

    def init_params(self, *args, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    # -- composite ops ---------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """The metric over ``eval_data`` in inference mode (ref:
        base_module.py score)."""
        check(self.binded and self.params_initialized,
              "call bind() and init_params() first")
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        nbatch = 0
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                _call_callbacks(batch_end_callback,
                                BatchEndParam(epoch, nbatch, eval_metric))
        if score_end_callback is not None:
            _call_callbacks(score_end_callback,
                            BatchEndParam(epoch, nbatch, eval_metric))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True,
                     sparse_row_id_fn=None):
        """``(outputs, nbatch, batch)`` for each batch, the padding rows
        cut (ref: base_module.py iter_predict)."""
        check(self.binded and self.params_initialized, "bind+init first")
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            pad = batch.pad
            yield ([o.slice_axis(axis=0, begin=0, end=o.shape[0] - pad)
                    if pad else o for o in self.get_outputs()],
                   nbatch, batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """Every batch's outputs, concatenated when ``merge_batches`` (ref:
        base_module.py predict)."""
        output_list: List[List] = [
            outs for outs, _, _ in self.iter_predict(eval_data, num_batch,
                                                     reset)]
        if not output_list:
            return []
        if merge_batches:
            num_outputs = len(output_list[0])
            merged = [_nd.concatenate([o[i] for o in output_list], axis=0)
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """Train over a DataIter (ref: base_module.py fit)."""
        from .. import initializer as init_mod
        check(num_epoch is not None, "num_epoch must be given")
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params)
                            if not isinstance(optimizer_params, dict)
                            else optimizer_params)
        eval_metric = _as_metric(eval_metric)
        validation_metric = _as_metric(validation_metric) \
            if validation_metric is not None else eval_metric

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            for nbatch, batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(batch)
                self.update()
                if monitor is not None:
                    monitor.toc_print()
                self.update_metric(eval_metric, batch.label)
                if batch_end_callback is not None:
                    _call_callbacks(batch_end_callback,
                                    BatchEndParam(epoch, nbatch,
                                                  eval_metric))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                _call_callbacks(epoch_end_callback, epoch, self.symbol,
                                arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def install_monitor(self, mon):
        pass


class BatchEndParam:
    """What a batch-end callback gets (ref: model.py BatchEndParam)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _call_callbacks(callbacks, *args):
    if callable(callbacks):
        callbacks(*args)
    else:
        for cb in callbacks:
            cb(*args)
