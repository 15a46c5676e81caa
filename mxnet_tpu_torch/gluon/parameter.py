"""Gluon parameters (ref: python/mxnet/gluon/parameter.py).

The tensor of a parameter is an attribute of its block: an ``nn.Parameter``
when it is trained (grad_req 'write' or 'add') and a buffer when it is an
aux state (BatchNorm's running statistics, grad_req 'null'). A
:class:`Parameter` here is the MXNet-side record that names that tensor —
full prefixed name, grad_req, initializer — so that names, trainer
bookkeeping and weight conversion follow the JAX package.

``data()`` and ``grad()`` return ``NDArray``s, as the JAX package's do.
``data()`` wraps the block's tensor itself, so a write through it (outside
``autograd.record()``) is a write into the block, and the block's tensor
is never rebound: a CUDA graph that captured it stays valid. A trained
parameter's gradient buffer is filled by ``autograd.backward`` through a
hook on the block's ``nn.Parameter``. Code of the framework (the trainer,
``convert``, ``initialize``) reads the tensor through :attr:`tensor`.

The port has no deferred initialisation: every shape is known when the
block is built.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from .. import autograd
from ..base import check
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "ParameterDict"]


class Parameter:
    """Names one tensor of a block (``getattr(block, attr)``)."""

    def __init__(self, name, block, attr, grad_req="write", init=None):
        self.name = name
        self.init = init
        self._block = block
        self._attr = attr
        self._grad_req = "null"
        self._nd = None
        self.initialized = False
        self.grad_req = grad_req

    @property
    def attr(self) -> str:
        return self._attr

    @property
    def block(self):
        return self._block

    @property
    def tensor(self) -> torch.Tensor:
        """The block's tensor itself (for the framework's own code)."""
        return getattr(self._block, self._attr)

    @property
    def shape(self):
        return tuple(self.tensor.shape)

    @property
    def dtype(self):
        return self.tensor.dtype

    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req) -> None:
        """'write' or 'add' give the parameter a zeroed gradient buffer
        (ref: parameter.py _attach); 'null' drops it. An aux state (a
        buffer, not differentiable) stays 'null', as in MXNet."""
        check(req in ("write", "add", "null"),
              f"parameter {self.name}: grad_req must be write, add or null, "
              f"not {req!r}")
        if not isinstance(self.tensor, nn.Parameter):
            req = "null"
        self._grad_req = req
        if self._nd is not None and self._nd._data is self.tensor:
            self._attach(self._nd)
        else:
            self.data()          # wraps the tensor and attaches

    def _attach(self, nd_) -> None:
        if self._grad_req == "null":
            nd_._grad, nd_._grad_req = None, None
            return
        grad = NDArray(torch.zeros_like(self.tensor.detach()))
        autograd.mark_variables([nd_], [grad], self._grad_req)

    def data(self, ctx=None) -> NDArray:
        """The parameter as an ``NDArray`` over the block's tensor (shared
        storage, not a copy). If the block's tensor was replaced, a new
        array and a zeroed gradient buffer follow it."""
        t = self.tensor
        if self._nd is None or self._nd._data is not t:
            self._nd = NDArray(t)
            self._attach(self._nd)
        return self._nd

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None) -> NDArray:
        """The gradient buffer that ``backward`` writes (grad_req 'write')
        or adds to ('add')."""
        g = self.data()._grad
        check(g is not None, f"parameter {self.name!r} has no gradient "
              f"(grad_req={self._grad_req!r})")
        return g

    def list_grad(self):
        return [self.grad()]

    def set_data(self, value) -> None:
        """Copy ``value`` (NDArray, tensor or array of this shape) into the
        block's tensor, in place."""
        dst = self.tensor
        if isinstance(value, NDArray):
            src = value._data
        elif isinstance(value, torch.Tensor):
            src = value
        else:
            src = torch.from_numpy(np.array(value, copy=True))
        check(tuple(src.shape) == tuple(dst.shape),
              f"parameter {self.name}: shape {tuple(src.shape)} does not "
              f"match {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src.detach().to(device=dst.device, dtype=dst.dtype))
        self.initialized = True

    def zero_grad(self) -> None:
        """Zero the gradient buffer in place (ref: parameter.py
        zero_grad)."""
        g = self.data()._grad
        if g is not None:
            with torch.no_grad():
                g._data.zero_()

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype}, grad_req={self.grad_req})")


class ParameterDict(OrderedDict):
    """Full name -> :class:`Parameter`, with the owning block's prefix."""

    def __init__(self, prefix=""):
        super().__init__()
        self.prefix = prefix

    def zero_grad(self) -> None:
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value) -> None:
        """Set one attribute (e.g. ``grad_req``) on every parameter."""
        for p in self.values():
            setattr(p, name, value)
