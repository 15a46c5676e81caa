"""Gluon parameters (ref: python/mxnet/gluon/parameter.py).

The tensor of a parameter is an attribute of its block: an ``nn.Parameter``
when it is trained (grad_req 'write' or 'add') and a buffer when it is an
aux state or frozen (grad_req 'null'). A :class:`Parameter` here is the
MXNet-side record that names that tensor — full prefixed name, grad_req,
initializer — so that names, trainer bookkeeping and weight conversion
follow the JAX package.

``data()`` and ``grad()`` return ``NDArray``s, as the JAX package's do.
``data()`` wraps the block's tensor itself, so a write through it (outside
``autograd.record()``) is a write into the block, and the block's tensor
is never rebound: a CUDA graph that captured it stays valid. A trained
parameter's gradient buffer is filled by ``autograd.backward`` through a
hook on the block's ``nn.Parameter``, which also marks it fresh
(``_fresh_grad``) until ``gluon.Trainer`` consumes it. ``cast`` swaps the
tensor's storage in place. Code of the framework (the trainer,
``convert``, ``initialize``) reads the tensor through :attr:`tensor`.

Deferred initialisation (ref: the JAX package's ``gluon/parameter.py``).
A shape with a 0 (``Dense(in_units=0)``, ``Conv2D(in_channels=0)``) is
allowed where the layer says so (``allow_deferred_init`` of the block's
``_new_param``): the block's attribute is ``None`` until the shape is
known. ``initialize()`` then only records the initializer and its
generator; the block's first forward fills the 0s from its input
(``shape_hint``), creates the tensor once on the block's device and
initialises it (``_finish_deferred``). ``set_data`` on such a parameter
creates it from the value's shape. ``data()`` before that raises
:class:`DeferredInitializationError`.

Each tensor and gradient buffer is registered with the memory ledger
(``telemetry/memory.py``, categories ``params`` and ``grads``) where it
is created, resized or dropped, as the JAX package's parameters do.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from .. import autograd
from ..base import MXNetError, check
from ..ndarray.ndarray import NDArray
from ..telemetry import memory as _memory

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A parameter's shape is not known yet: the first forward resolves it
    (ref: parameter.py)."""


class Parameter:
    """Names one tensor of a block (``getattr(block, attr)``, ``None``
    while its initialisation is deferred)."""

    def __init__(self, name, block, attr, shape, grad_req="write", init=None,
                 dtype=torch.float32, device=None, lr_mult=1.0, wd_mult=1.0):
        self.name = name
        self.init = init
        self.lr_mult = lr_mult       # scale the optimizer's lr / wd by these
        self.wd_mult = wd_mult
        self._block = block
        self._attr = attr
        self._shape = tuple(shape)
        self._dtype = dtype
        self._device = device
        self._trained = grad_req != "null"
        self._grad_req = "null"
        self._nd = None
        self._deferred_init = None     # (initializer, generator)
        self.initialized = False
        self.grad_req = grad_req
        _memory.track_param_data(self)

    @property
    def attr(self) -> str:
        return self._attr

    @property
    def block(self):
        return self._block

    @property
    def tensor(self):
        """The block's tensor itself (for the framework's own code);
        ``None`` while the initialisation is deferred."""
        return getattr(self._block, self._attr)

    @property
    def shape(self):
        """The tensor's shape; while deferred, the declared one with 0 for
        each unknown extent."""
        t = self.tensor
        return self._shape if t is None else tuple(t.shape)

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._device

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
        self._grad_req = req if self._trained else "null"
        if self.tensor is None:
            return
        if self._nd is not None and self._nd._data is self.tensor:
            self._attach(self._nd)
        else:
            self.data()          # wraps the tensor and attaches

    def _attach(self, nd_) -> None:
        if self._grad_req == "null":
            nd_._grad, nd_._grad_req = None, None
            _memory.drop_param_grad(self)
            return
        grad = NDArray(torch.zeros_like(self.tensor.detach()))
        autograd.mark_variables([nd_], [grad], self._grad_req)
        _memory.track_param_grad(self, grad)

    # -- deferred initialisation ------------------------------------------
    def shape_hint(self, shape) -> None:
        """Fill the unknown (0) extents from ``shape``."""
        self._shape = tuple(s if s > 0 else int(h)
                            for s, h in zip(self._shape, shape))

    def _create(self, shape) -> torch.Tensor:
        """Create the block's tensor, once (a deferred parameter only)."""
        t = torch.empty(tuple(shape), dtype=self._dtype, device=self._device)
        if self._trained:
            self._block.register_parameter(self._attr, nn.Parameter(t))
        else:
            self._block.register_buffer(self._attr, t)
        self._shape = tuple(shape)
        _memory.track_param_data(self)
        self.grad_req = self._grad_req       # attaches the gradient buffer
        return self.tensor

    def _finish_deferred(self) -> None:
        """Create and initialise the tensor now that its shape is known."""
        if self._deferred_init is None:
            raise MXNetError(f"parameter {self.name!r} is not initialized; "
                             "call initialize()")
        check(all(s > 0 for s in self._shape),
              f"deferred init of {self.name!r}: shape {self._shape} still "
              "unknown")
        initializer, generator = self._deferred_init
        initializer(self.name, self._create(self._shape).data, generator)
        self._deferred_init = None
        self.initialized = True

    # -- access -----------------------------------------------------------
    def data(self, ctx=None) -> NDArray:
        """The parameter as an ``NDArray`` over the block's tensor (shared
        storage, not a copy). If the block's tensor was replaced, a new
        array and a zeroed gradient buffer follow it."""
        t = self.tensor
        if t is None:
            raise DeferredInitializationError(
                f"parameter {self.name!r} has deferred initialization "
                f"(shape {self._shape}); run a forward pass or give full "
                "shapes first")
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
        block's tensor, in place; a deferred parameter's tensor is created
        from the value's shape."""
        if isinstance(value, NDArray):
            src = value._data
        elif isinstance(value, torch.Tensor):
            src = value
        else:
            src = torch.from_numpy(np.array(value, copy=True))
        dst = self.tensor
        if dst is None:
            check(len(src.shape) == len(self._shape) and all(
                s in (0, v) for s, v in zip(self._shape, src.shape)),
                f"parameter {self.name}: shape {tuple(src.shape)} does not "
                f"match {self._shape}")
            dst = self._create(src.shape)
            self._deferred_init = None
        check(tuple(src.shape) == tuple(dst.shape),
              f"parameter {self.name}: shape {tuple(src.shape)} does not "
              f"match {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src.detach().to(device=dst.device, dtype=dst.dtype))
        self.initialized = True

    def zero_grad(self) -> None:
        """Zero the gradient buffer in place (ref: parameter.py
        zero_grad); it is no longer fresh."""
        if self.tensor is None:
            return
        g = self.data()._grad
        if g is not None:
            with torch.no_grad():
                g._data.zero_()
            g._fresh_grad = False

    @property
    def _fresh_grad(self) -> bool:
        """True while the gradient buffer holds a gradient that backward
        wrote and no optimizer step has consumed (ref: parameter.py
        _fresh_grad)."""
        t = self.tensor
        if t is None or self._grad_req == "null":
            return False
        g = self.data()._grad
        return g is not None and g._fresh_grad

    @_fresh_grad.setter
    def _fresh_grad(self, fresh: bool) -> None:
        if self.tensor is None or self._grad_req == "null":
            return
        g = self.data()._grad
        if g is not None:
            g._fresh_grad = bool(fresh)

    def cast(self, dtype) -> None:
        """Cast the parameter (and its gradient buffer) to ``dtype`` in
        place: the block's tensor keeps its identity, only its storage is
        swapped (``tensor.data = ...``). A deferred parameter is created
        in ``dtype`` later."""
        from ..base import torch_dtype
        dtype = torch_dtype(dtype)
        self._dtype = dtype
        t = self.tensor
        if t is None:
            return
        with torch.no_grad():
            t.data = t.data.to(dtype)
            g = self.data()._grad
            if g is not None:
                g._data = g._data.to(dtype)
        _memory.track_param_data(self)
        _memory.track_param_grad(self, g)

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
