"""Contrib optimizers (ref: python/mxnet/optimizer/contrib.py; the JAX
package's ``optimizer/contrib.py``).

GroupAdaGrad keeps ONE accumulator value per output row (useful for
embedding tables where whole rows get sparse updates), through the
``_contrib_group_adagrad_update`` op. A row-sparse gradient is
densified first, with the storage-fallback warning.
"""
from __future__ import annotations

import torch

from ..base import check
from ..ndarray import ndarray as _nd
from ..ops import optimizer_ops as _ops
from .optimizer import Optimizer, _clip, _dense, register

__all__ = ["GroupAdaGrad"]


@register
class GroupAdaGrad(Optimizer):
    """Adagrad with per-row grouped statistics
    (ref: src/operator/contrib/optimizer_op.cc
    _contrib_group_adagrad_update)."""

    def __init__(self, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _nd.zeros((weight.shape[0],), ctx=weight.context)

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        lr = self._get_lr(index)
        check(self._get_wd(index) == 0.0,
              "GroupAdaGrad does not support weight decay")
        with torch.no_grad():
            new_w, new_h = _ops._group_adagrad_update(
                weight._data, grad._data, state._data, lr=lr,
                rescale_grad=self.rescale_grad,
                clip_gradient=_clip(self.clip_gradient),
                epsilon=self.float_stable_eps)
            _ops.commit([weight._data, state._data], [new_w, new_h])
