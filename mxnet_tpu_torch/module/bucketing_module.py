"""BucketingModule: variable-length training with one Module a bucket
(ref: the JAX package's ``module/bucketing_module.py``;
python/mxnet/module/bucketing_module.py).

``sym_gen(bucket_key) -> (symbol, data_names, label_names)``. The default
bucket's Module is bound first; every other bucket's is bound at its
first batch with the default one as ``shared_module``, so all of them
hold the same parameter, aux and gradient tensors (no copy on a switch)
and one optimizer and updater. Each bucket's executor is a walk of its
own graph; nothing is compiled per bucket.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict

from ..base import check
from ..context import current_context
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen: Callable, default_bucket_key=None,
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        check(default_bucket_key is not None, "default_bucket_key required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context if context is not None else \
            current_context()
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._buckets: Dict[Any, Module] = {}
        self._curr_module: Module = None
        self._curr_bucket_key = None
        self._grad_req = "write"

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write", bucket_key=None):
        """Bind the default bucket's Module (or ``bucket_key``'s)."""
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        key = bucket_key if bucket_key is not None \
            else self._default_bucket_key
        module = self._gen_module(key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=grad_req)
        self._buckets[key] = module
        self._curr_module = module
        self._curr_bucket_key = key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s Module current, binding it over the
        default bucket's tensors at its first use (ref:
        bucketing_module.py switch_bucket)."""
        check(self.binded, "bind before switch_bucket")
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            default_mod = self._buckets[self._default_bucket_key]
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad, force_rebind=False,
                        shared_module=default_mod,
                        grad_req=self._grad_req)
            if default_mod.params_initialized:
                module.params_initialized = True
            if default_mod.optimizer_initialized:
                module._optimizer = default_mod._optimizer
                module._updater = default_mod._updater
                module.optimizer_initialized = True
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, **kwargs):
        self._curr_module.init_params(initializer=initializer, **kwargs)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def init_optimizer(self, **kwargs):
        """One optimizer and updater, the default bucket's, for every
        bucket."""
        base = self._buckets[self._default_bucket_key]
        base.init_optimizer(**kwargs)
        for key, mod in self._buckets.items():
            if key != self._default_bucket_key:
                mod._optimizer = base._optimizer
                mod._updater = base._updater
                mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", None)
        if key is None:
            key = self._default_bucket_key
        data_shapes = [(n, a.shape) for n, a in
                       zip(self._curr_module.data_names,
                           data_batch.data or [])]
        label_shapes = None
        if data_batch.label:
            label_shapes = [(n, a.shape) for n, a in
                            zip(self._curr_module.label_names,
                                data_batch.label)]
        self.switch_bucket(key, data_shapes, label_shapes)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)
