"""SequentialModule: a chain of Modules, each one's outputs the next
one's data (ref: the JAX package's ``module/sequential_module.py``;
python/mxnet/module/sequential_module.py). ``add(module,
take_labels=True)`` makes a module take the labels (default: the last);
``auto_wiring=True`` renames the previous module's outputs onto its data
names. The backward runs from the last module to the first, each passing
its input gradients on."""
from __future__ import annotations

import logging

from ..base import check
from ..io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_module_idx = None

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(kwargs)
        if kwargs.get(self.META_TAKE_LABELS, False):
            self._label_module_idx = len(self._modules) - 1
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names

    @property
    def output_names(self):
        return self._modules[-1].output_names

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        self.for_training = for_training
        label_idx = self._label_module_idx \
            if self._label_module_idx is not None else len(self._modules) - 1
        cur_shapes = data_shapes
        for i, mod in enumerate(self._modules):
            if i > 0 and self._metas[i].get(self.META_AUTO_WIRING, False):
                names = mod.data_names
                check(len(names) == len(cur_shapes),
                      f"auto_wiring: module {i} declares {len(names)} "
                      f"data inputs but the previous module produces "
                      f"{len(cur_shapes)} outputs")
                cur_shapes = [(names[j], s)
                              for j, (_, s) in enumerate(cur_shapes)]
            mod.bind(cur_shapes, label_shapes if i == label_idx else None,
                     for_training, inputs_need_grad or i > 0, force_rebind,
                     None, grad_req)
            cur_shapes = [(n, s) for n, s in mod.output_shapes]
        self.binded = True

    def init_params(self, **kwargs):
        for mod in self._modules:
            mod.init_params(**kwargs)
        self.params_initialized = True

    def get_params(self):
        arg, aux = {}, {}
        for mod in self._modules:
            a, x = mod.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def init_optimizer(self, **kwargs):
        for mod in self._modules:
            mod.init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for i, mod in enumerate(self._modules):
            mod.forward(batch, is_train=is_train)
            if i < len(self._modules) - 1:
                batch = DataBatch(mod.get_outputs(), data_batch.label,
                                  pad=data_batch.pad)

    def backward(self, out_grads=None):
        for i, mod in reversed(list(enumerate(self._modules))):
            mod.backward(out_grads)
            if i > 0:
                out_grads = mod.get_input_grads()

    def update(self):
        for mod in self._modules:
            mod.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._modules[-1].update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for mod in self._modules:
            mod.install_monitor(mon)
