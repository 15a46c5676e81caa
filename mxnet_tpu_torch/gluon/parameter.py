"""Gluon parameters (ref: python/mxnet/gluon/parameter.py).

The tensor of a parameter is an attribute of its block: an ``nn.Parameter``
when it is trained (grad_req 'write') and a buffer when it is an aux state
(BatchNorm's running statistics, grad_req 'null'). A :class:`Parameter`
here is the MXNet-side record that names that tensor — full prefixed name,
grad_req, initializer — so that names, trainer bookkeeping and weight
conversion follow the JAX package.

The port has no deferred initialisation: every shape is known when the
block is built.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..base import check

__all__ = ["Parameter", "ParameterDict"]


class Parameter:
    """Names one tensor of a block (``getattr(block, attr)``)."""

    def __init__(self, name, block, attr, grad_req="write", init=None):
        self.name = name
        self.grad_req = grad_req
        self.init = init
        self._block = block
        self._attr = attr
        self.initialized = False

    @property
    def attr(self) -> str:
        return self._attr

    @property
    def block(self):
        return self._block

    @property
    def shape(self):
        return tuple(self.data().shape)

    @property
    def dtype(self):
        return self.data().dtype

    def data(self) -> torch.Tensor:
        return getattr(self._block, self._attr)

    def set_data(self, value) -> None:
        """Copy ``value`` (array or tensor of this shape) into the tensor."""
        dst = self.data()
        src = torch.tensor(np.asarray(value)) \
            if not isinstance(value, torch.Tensor) else value
        check(tuple(src.shape) == tuple(dst.shape),
              f"parameter {self.name}: shape {tuple(src.shape)} does not "
              f"match {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
        self.initialized = True

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype}, grad_req={self.grad_req})")


class ParameterDict(OrderedDict):
    """Full name -> :class:`Parameter`, with the owning block's prefix."""

    def __init__(self, prefix=""):
        super().__init__()
        self.prefix = prefix
