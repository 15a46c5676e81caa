"""Module: bind a Symbol to data shapes and train it (ref: the JAX
package's ``module/module.py``; python/mxnet/module/module.py and
executor_group.py).

One Executor a Module, on one device: ``context`` (a list takes its
first entry; default the current context, the card). ``bind`` allocates
the arrays from the inferred shapes (``shared_module=`` shares the other
Module's parameter, aux and gradient tensors wherever the shapes match);
``forward`` writes the batch into the executor and, on a shape change
(bucketing, a last short batch), reshapes it over the same parameter
tensors; ``update`` runs the optimizer (``rescale_grad`` 1 / batch by
default) on every parameter in place, through a kvstore when one was
asked for (``MXNET_UPDATE_ON_KVSTORE`` says whether the store updates or
only aggregates). Parameters are written in place, never rebound, so
every executor sharing them sees each update. ``save_checkpoint`` writes
``prefix-symbol.json``, ``prefix-NNNN.params`` (``arg:`` / ``aux:``
keys) and, if asked, ``prefix-NNNN.states``; ``Module.load(...,
load_optimizer_states=True)`` restores all three, the optimizer states at
``init_optimizer`` (the JAX package's ``load`` records the states file and
never reads it).
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from .. import optimizer as opt_mod
from ..base import check, env
from ..context import Context, current_context
from ..io import DataDesc
from ..ndarray import ndarray as _nd
from ..symbol.executor import Executor
from .base_module import BaseModule

__all__ = ["Module", "load_checkpoint_params"]


def _descs(shapes):
    return [d if hasattr(d, "name") else DataDesc(d[0], d[1])
            for d in shapes or []]


def _copy_into(dst: _nd.NDArray, src) -> None:
    src = src._data if isinstance(src, _nd.NDArray) else torch.as_tensor(src)
    with torch.no_grad():
        dst._data.copy_(src.to(dst._data.device, dst._data.dtype))


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        if context is None:
            context = current_context()
        if isinstance(context, (list, tuple)):
            context = context[0]
        self._context = Context(context)
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        inputs = set(self._data_names) | set(self._label_names) | \
            set(self._state_names)
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec: Optional[Executor] = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = "write"
        self._preloaded = None
        self._preloaded_states = None

    # -- properties -----------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        shapes = {d.name: d.shape for d in self._data_shapes or []}
        shapes.update({d.name: d.shape for d in self._label_shapes or []})
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self.output_names, out_shapes))

    # -- bind ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Allocate the executor (ref: module.py bind -> simple_bind)."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes) or None
        shapes: Dict[str, tuple] = {
            d.name: tuple(d.shape)
            for d in self._data_shapes + (self._label_shapes or [])}
        req: Dict[str, str] = {}
        for n in self._symbol.list_arguments():
            if n in self._param_names and for_training \
                    and n not in self._fixed_param_names:
                req[n] = grad_req
            elif inputs_need_grad and n in self._data_names:
                req[n] = grad_req
            else:
                req[n] = "null"
        shared = shared_module._exec if shared_module is not None else None
        with self._context:
            self._exec = Executor.simple_bind(
                self._symbol, self._context, grad_req=req,
                shared_exec=shared, **shapes)
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True

    # -- params ----------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill the parameters and aux states in place: from
        ``arg_params`` / ``aux_params`` (or a loaded checkpoint's) where
        given, else by ``initializer`` (default ``Uniform(0.01)``)."""
        from .. import initializer as init_mod
        check(self.binded, "bind() before init_params()")
        if self.params_initialized and not force_init:
            return
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        if arg_params is None and self._preloaded is not None:
            arg_params, aux_params = self._preloaded
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                _copy_into(arr, arg_params[name])
            else:
                check(allow_missing or arg_params is None,
                      f"parameter {name} missing and allow_missing=False")
                initializer(init_mod.InitDesc(name), arr._data)
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            if aux_params is not None and name in aux_params:
                _copy_into(arr, aux_params[name])
            else:
                initializer(init_mod.InitDesc(name), arr._data)
        self.params_initialized = True

    def get_params(self):
        """Copies of ``(arg_params, aux_params)``."""
        check(self.binded and self.params_initialized, "bind+init first")
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    # -- optimizer --------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer and its updater (ref: module.py init_optimizer);
        a named optimizer gets ``rescale_grad = 1 / batch``. A kvstore
        named other than ``local`` / ``device`` is created and holds the
        parameters."""
        check(self.binded and self.params_initialized, "bind+init first")
        if self.optimizer_initialized and not force_init:
            return
        if not isinstance(optimizer_params, dict):
            optimizer_params = dict(optimizer_params)
        if isinstance(optimizer, str):
            batch_size = self._data_shapes[0].shape[0] \
                if self._data_shapes else 1
            optimizer_params.setdefault("rescale_grad", 1.0 / batch_size)
            optimizer = opt_mod.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        if isinstance(kvstore, str) and kvstore not in ("local", "device"):
            from .. import kvstore as kv_mod
            kvstore = kv_mod.create(kvstore)
        if kvstore is not None and not isinstance(kvstore, str):
            self._kvstore = kvstore
            # MXNET_UPDATE_ON_KVSTORE=0 keeps the optimizer here and the
            # store only aggregates (ref: model.py _update_params)
            self._update_on_kvstore = bool(env.get("MXNET_UPDATE_ON_KVSTORE"))
            if self._update_on_kvstore:
                kvstore.set_optimizer(optimizer)
            for i, name in enumerate(self._param_names):
                kvstore.init(i, self._exec.arg_dict[name])
        if self._preloaded_states is not None:
            with open(self._preloaded_states, "rb") as f, self._context:
                self._updater.set_states(f.read())
        self.optimizer_initialized = True

    # -- execution --------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Write the batch into the executor and run it; a new input shape
        reshapes the executor over the same parameters."""
        check(self.binded and self.params_initialized, "bind+init first")
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self._data_names, data_batch.data or []))
        if data_batch.label:
            feed.update(zip(self._label_names, data_batch.label))
        if any(self._exec.arg_dict[n].shape != a.shape
               for n, a in feed.items() if n in self._exec.arg_dict):
            self._exec = self._exec.reshape(
                **{n: a.shape for n, a in feed.items()})
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        check(self.binded, "bind first")
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step on every parameter with a gradient (ref:
        module.py update)."""
        check(self.optimizer_initialized, "init_optimizer first")
        for i, name in enumerate(self._param_names):
            g = self._exec.grad_dict.get(name)
            if g is None:
                continue
            w = self._exec.arg_dict[name]
            if self._kvstore is not None:
                self._kvstore.push(i, g)
                if self._update_on_kvstore:
                    self._kvstore.pull(i, w)
                    continue
                self._kvstore.pull(i, g)
            self._updater(i, g, w)

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        check(self.inputs_need_grad, "bind with inputs_need_grad=True")
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels or [])),
            dict(zip(self.output_names, self.get_outputs())))

    # -- checkpoints (ref: module.py save_checkpoint + model.py) --------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over ``prefix-symbol.json`` whose ``init_params`` (and,
        with ``load_optimizer_states``, ``init_optimizer``) take the
        epoch's saved values."""
        from ..symbol import load as sym_load
        mod = Module(sym_load(f"{prefix}-symbol.json"), **kwargs)
        mod._preloaded = load_checkpoint_params(
            f"{prefix}-{epoch:04d}.params", ctx=mod._context)
        if load_optimizer_states:
            mod._preloaded_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def set_states(self, states=None, value=None):
        pass

    def install_monitor(self, mon):
        mon.install(self._exec)


def load_checkpoint_params(fname, ctx=None):
    """``(arg_params, aux_params)`` of a ``.params`` file, on ``ctx``
    (default: the current context); keys without an ``arg:`` / ``aux:``
    prefix count as arguments."""
    from ..ndarray import utils as nd_utils
    arg, aux = {}, {}
    for k, v in nd_utils.load(fname, ctx=ctx).items():
        if k.startswith("aux:"):
            aux[k[4:]] = v
        else:
            arg[k[4:] if k.startswith("arg:") else k] = v
    return arg, aux
