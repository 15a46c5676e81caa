"""Checkpoints of symbolic models (ref: the JAX package's ``model.py``;
python/mxnet/model.py): ``prefix-symbol.json`` and
``prefix-NNNN.params`` with ``arg:`` / ``aux:`` keys, the layout that
``HybridBlock.export`` writes and ``SymbolBlock.imports`` reads, and the
deprecated ``FeedForward`` trainer over ``module.Module``."""
from __future__ import annotations

import logging

from .base import check
from .module.base_module import BatchEndParam
from .ndarray import utils as nd_utils

__all__ = ["save_checkpoint", "load_checkpoint", "FeedForward",
           "BatchEndParam"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """(ref: model.py save_checkpoint)"""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    payload = {f"arg:{k}": v for k, v in arg_params.items()}
    payload.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd_utils.save(f"{prefix}-{epoch:04d}.params", payload)
    logging.info("Saved checkpoint to \"%s-%04d.params\"", prefix, epoch)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` (ref: model.py
    load_checkpoint)."""
    from .symbol import load as sym_load
    symbol = sym_load(f"{prefix}-symbol.json")
    arg_params, aux_params = {}, {}
    for k, v in nd_utils.load(f"{prefix}-{epoch:04d}.params").items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The deprecated training wrapper (ref: model.py FeedForward): ``fit``
    trains a ``Module`` on ``ctx`` (default: the current context) and
    keeps its parameters; ``predict`` / ``score`` use that Module."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs
        self._module = None

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        from .module import Module
        mod = Module(self.symbol, context=self.ctx)
        self._module = mod
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=self.kwargs.get("optimizer_params",
                                                 {"learning_rate": 0.01}),
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch, monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        check(self._module is not None, "fit() first or load a checkpoint")
        return self._module.predict(X, num_batch=num_batch, reset=reset)

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        check(self._module is not None, "fit() first or load a checkpoint")
        return self._module.score(X, eval_metric, num_batch=num_batch,
                                  reset=reset)

    def save(self, prefix, epoch=None):
        epoch = epoch if epoch is not None else self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch, **kwargs)
        model.fit(X, y)
        return model
