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

MXNet's free-standing form (``Parameter(name, shape=...)``,
``block.params.get(name, ...)``, ``ParameterDict.get_constant``,
:class:`Constant`). A parameter made by ``params.get`` on a block's own
dictionary is bound at once to that block under its short name (the name
without the block's prefix), the name ``hybrid_forward`` receives it by
(``capsnet.py`` keeps its ``caps_weight`` in the attribute ``self.W``: the
attribute holds this record, the block's ``nn.Parameter`` or buffer is
``caps_weight``). A parameter that no block owns yet lives in a holder
module of its own until a block adopts it (``block.x = param``); one
taken from a ``shared`` dictionary is registered in the sharing block
too, the same tensor under the same short name, so the trainers and
``functional_call`` see one tied weight. ``Parameter.var`` needs
``symbol/`` and raises (ROADMAP A14).

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
from .. import initializer as init_mod
from ..base import MXNetError, check, torch_dtype
from ..context import Context, current_context, resolve_device
from ..ndarray import utils as nd_utils
from ..ndarray.ndarray import NDArray
from ..ops.registry import NotPortedError
from ..random import init_generator
from ..telemetry import memory as _memory

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A parameter's shape is not known yet: the first forward resolves it
    (ref: parameter.py)."""


class _Holder(nn.Module):
    """The home of a parameter's tensor while no block owns it."""


class Parameter:
    """Names one tensor of a block (its ``_parameters`` or ``_buffers``
    entry ``attr``; ``None`` while its initialisation is deferred).
    MXNet's signature; a new parameter is free-standing until
    :meth:`_bind` gives it a block."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        check(stype == "default" and grad_stype == "default",
              f"parameter {name}: sparse storage is not ported yet "
              "(ROADMAP A11)")
        self.name = name
        self.init = init
        self.lr_mult = lr_mult       # scale the optimizer's lr / wd by these
        self.wd_mult = wd_mult
        self.allow_deferred_init = allow_deferred_init
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = None if shape is None else tuple(int(s) for s in shape)
        self._dtype = torch_dtype(dtype)
        self._block = None
        self._attr = None
        self._device = None
        self._trained = differentiable and grad_req != "null"
        self._grad_req = "null"
        self._nd = None
        self._deferred_init = None     # (initializer, generator)
        self.initialized = False
        self.grad_req = grad_req

    def _bind(self, block, attr, device=None) -> None:
        """Make ``block.<attr>`` this parameter's tensor: an empty tensor
        of its shape on ``device`` (default: the block's) when the shape
        is known, else ``None`` until it is."""
        self._block, self._attr = block, attr
        self._device = resolve_device(
            device if device is not None else getattr(block, "_device", None))
        t = torch.empty(self._shape, dtype=self._dtype, device=self._device) \
            if self._shape_known() else None
        if self._trained:
            block.register_parameter(attr, None if t is None
                                     else nn.Parameter(t))
        else:
            block.register_buffer(attr, t)
        _memory.track_param_data(self)
        self.grad_req = self._grad_req

    def _home(self, device=None):
        """Bind a free-standing parameter to a holder of its own."""
        if self._block is None:
            self._bind(_Holder(), "data", device)

    def _shape_known(self) -> bool:
        return self._shape is not None and all(s > 0 for s in self._shape)

    @property
    def attr(self) -> str:
        return self._attr

    @property
    def block(self):
        return self._block

    @property
    def tensor(self):
        """The block's tensor itself (for the framework's own code);
        ``None`` while the initialisation is deferred or no block holds
        it."""
        b = self._block
        if b is None:
            return None
        if self._attr in b._parameters:
            return b._parameters[self._attr]
        return b._buffers.get(self._attr)

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
        if self._shape is None:
            self._shape = tuple(int(h) for h in shape)
            return
        self._shape = tuple(s if s > 0 else int(h)
                            for s, h in zip(self._shape, shape))

    def _create(self, shape) -> torch.Tensor:
        """Create the block's tensor, once (a deferred parameter only)."""
        self._home()
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
        check(self._shape_known(),
              f"deferred init of {self.name!r}: shape {self._shape} still "
              "unknown")
        initializer, generator = self._deferred_init
        initializer(self.name, self._create(self._shape).data, generator)
        self._deferred_init = None
        self.initialized = True

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None) -> None:
        """Fill the tensor with ``init`` (else the parameter's own, else
        ``default_init``, else ``Uniform(0.07)``), drawing from
        ``generator`` (default: one seeded with ``mx.random.seed``'s
        last seed, 0 before it is called, on the device). A
        free-standing parameter is placed on ``ctx`` (default: the current
        context); one of unknown shape records the initializer for its
        first forward (``allow_deferred_init``) or raises."""
        if self.initialized and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        self._home(ctx if ctx is not None else current_context())
        initializer = init_mod.create(init if init is not None
                                      else self.init if self.init is not None
                                      else default_init)
        if generator is None:
            generator = init_generator(self._device)
        if self.tensor is None:
            check(self.allow_deferred_init,
                  f"cannot initialize parameter {self.name!r}: shape "
                  f"{self._shape} unknown; set allow_deferred_init=True or "
                  "give a full shape")
            self._deferred_init = (initializer, generator)
            return
        initializer(self.name, self.tensor.data, generator)
        self.initialized = True

    def list_ctx(self):
        """The parameter's device as a one-element list, empty before it
        has a tensor (ref: parameter.py list_ctx)."""
        return [] if self.tensor is None else [Context(self._device)]

    def reset_ctx(self, ctx) -> None:
        """Move the tensor (and its gradient buffer) to ``ctx`` in place:
        the block's tensor keeps its identity."""
        self._device = resolve_device(ctx)
        t = self.tensor
        if t is None:
            return
        with torch.no_grad():
            t.data = t.data.to(self._device)
            g = self.data()._grad
            if g is not None:
                g._data = g._data.to(self._device)

    def var(self):
        raise NotPortedError("Parameter.var makes a symbol variable; "
                             "symbol/ is not ported yet (ROADMAP A14)")

    # -- access -----------------------------------------------------------
    def data(self, ctx=None) -> NDArray:
        """The parameter as an ``NDArray`` over the block's tensor (shared
        storage, not a copy). If the block's tensor was replaced, a new
        array and a zeroed gradient buffer follow it; a tensor computed
        from it that a ``functional_call`` substitutes (the trainer's
        16-bit replica) is wrapped as it is."""
        t = self.tensor
        if t is None:
            if self._block is None:
                raise MXNetError(f"parameter {self.name!r} is not "
                                 "initialized; call initialize()")
            raise DeferredInitializationError(
                f"parameter {self.name!r} has deferred initialization "
                f"(shape {self._shape}); run a forward pass or give full "
                "shapes first")
        if t.requires_grad and not t.is_leaf:
            return NDArray(t)
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
        self._home(src.device)
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


class _ConstantValue(init_mod.Initializer):
    """Writes a :class:`Constant`'s value, whatever the name."""

    def __init__(self, value):
        super().__init__()
        self._value = value

    def __call__(self, desc, arr, generator=None) -> None:
        with torch.no_grad():
            arr.copy_(torch.from_numpy(self._value))


class Constant(Parameter):
    """A parameter that is never trained and holds ``value`` (ref:
    gluon/parameter.py Constant): a buffer of the value's shape and dtype,
    filled by ``initialize``."""

    def __init__(self, name, value):
        if not isinstance(value, np.ndarray):
            value = np.asarray(value, dtype=np.float32)
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_ConstantValue(value))


class ParameterDict(OrderedDict):
    """Full name -> :class:`Parameter`, with the owning block's prefix.
    ``shared``: a dictionary whose parameters ``get`` returns under the
    same full names (ref: parameter.py ParameterDict)."""

    def __init__(self, prefix="", shared=None, owner=None):
        super().__init__()
        self.prefix = prefix
        self._shared = shared
        self._owner = owner      # the block whose own parameters these are

    def _short(self, full: str) -> str:
        return full[len(self.prefix):] if full.startswith(self.prefix) \
            else full

    def get(self, name, **kwargs) -> Parameter:
        """The parameter ``prefix + name``: this dictionary's, else the
        shared one's (registered in the owner block too), else a new
        :class:`Parameter` made from ``kwargs`` and bound to the owner
        block under ``name`` (ref: parameter.py get)."""
        full = self.prefix + name
        if full in self:
            param = self[full]
            shape = kwargs.get("shape")
            if shape is not None and param._shape is None:
                param._shape = (shape,) if isinstance(shape, int) \
                    else tuple(shape)
            return param
        if self._shared is not None and full in self._shared:
            param = self._shared[full]
        else:
            param = Parameter(full, **kwargs)
        self._adopt(param)
        return param

    def get_constant(self, name, value=None) -> Constant:
        """The :class:`Constant` ``prefix + name``, made from ``value``
        the first time."""
        full = self.prefix + name
        if full in self:
            return self[full]
        check(value is not None, f"constant {full!r} needs a value")
        const = Constant(full, value)
        self._adopt(const)
        return const

    def _adopt(self, param) -> None:
        self[param.name] = param
        if self._owner is not None:
            self._owner._adopt(param)

    def update(self, other) -> None:
        """Add ``other``'s parameters (a mapping or pairs); a name already
        here must name the same parameter."""
        for k, v in (other.items() if hasattr(other, "items") else other):
            if k in self and self[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None) -> None:
        """``Parameter.initialize`` on each, in order: ``init`` (default
        ``Uniform(0.07)``) for those without an initializer of their own,
        the random draws from ``generator`` (default: one seeded with
        ``mx.random.seed``'s last seed, 0 before it is called, per device,
        shared by the parameters on it). With ``ctx`` each
        parameter is first moved there."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        default = init_mod.create(init)
        gens = {}
        for p in self.values():
            if p.initialized and not force_reinit:
                continue
            p._home(ctx if ctx is not None else current_context())
            if ctx is not None:
                p.reset_ctx(ctx)
            gen = generator
            if gen is None:
                gen = gens.get(p.device)
                if gen is None:
                    gen = gens[p.device] = init_generator(p.device)
            p.initialize(None, None, default, force_reinit, gen)

    def zero_grad(self) -> None:
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx) -> None:
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value) -> None:
        """Set one attribute (e.g. ``grad_req``) on every parameter."""
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix="") -> None:
        """``mx.nd.save`` of every parameter, ``strip_prefix`` taken off
        the names that start with it."""
        payload = {}
        for name, p in self.items():
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            payload[name] = p.data()
        nd_utils.save(filename, payload)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="") -> None:
        """Set each parameter from a file of :meth:`save` (either
        package's), ``restore_prefix`` put before the file's names."""
        loaded = {restore_prefix + k: v
                  for k, v in nd_utils.load(filename, ctx=Context("cpu"))
                  .items()}
        if not allow_missing:
            for name in self:
                check(name in loaded,
                      f"parameter {name} missing from file {filename}")
        for name, data in loaded.items():
            if name not in self:
                if ignore_extra:
                    continue
                raise MXNetError(f"parameter {name} in file is not in this "
                                 "ParameterDict (pass ignore_extra=True)")
            self[name].set_data(data)
        if ctx is not None:
            self.reset_ctx(ctx)
