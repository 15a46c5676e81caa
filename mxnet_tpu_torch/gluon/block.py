"""Gluon HybridBlock as a ``torch.nn.Module`` (ref:
python/mxnet/gluon/block.py).

Naming follows MXNet: a block's prefix is its class name, lower-cased with
CamelCase breaks as the JAX package spells them, plus a per-scope counter
(``res_netv10_``); blocks built inside ``with parent.name_scope():`` take
the parent's prefix in front. Parameter names are ``prefix + short name``,
so a port model built in the same order as a JAX model carries the same
names (up to the top-level counter).

Calling a block with ``NDArray``s (the imperative loop: ``record()``,
``net(x)``, ``backward()``) unwraps them, runs ``forward`` on their
tensors and wraps the outputs; torch records a graph only while
``autograd.is_recording()``. Called with tensors (children inside a
forward, ``functional_call``, the trainer), a block is a plain
``nn.Module`` call and pays nothing extra. Layers whose behaviour depends
on the mode (BatchNorm) read ``autograd.is_training()``, never
``nn.Module.training``.

Deferred initialisation (ref: the JAX package's ``block.py:211-301``). A
layer built without its input width (``in_units=0``, ``in_channels=0``)
holds parameters whose tensors do not exist yet. On its first call the
block reads the width from its input (``infer_shape_from_inputs``, each
layer's rule as in the JAX package), creates those tensors once on its
device and initialises them with what ``initialize()`` recorded. A block
with nothing deferred pays one attribute test per call.

``hybridize()`` is a no-op: PyTorch runs the forward eagerly, and the
trainer's CUDA graph (``parallel/spmd.py run_steps``) is the port's
counterpart of a compiled program. It is kept so MXNet-style code runs
unchanged.
"""
from __future__ import annotations

import re
import threading

import torch
from torch import nn

from .. import autograd
from ..base import check
from ..context import resolve_device
from .. import initializer as init_mod
from .. import random as _random
from ..ndarray.ndarray import NDArray, _own
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["HybridBlock", "name_scope"]


class _NameManager(threading.local):
    def __init__(self):
        self.counters = {}
        self.prefix_stack = [""]

    def next_prefix(self, hint: str) -> str:
        scope = self.prefix_stack[-1]
        n = self.counters.get((scope, hint), 0)
        self.counters[(scope, hint)] = n + 1
        return f"{scope}{hint}{n}_"


_names = _NameManager()


class name_scope:
    """Prefix scope for the blocks built inside it (ref: _BlockScope)."""

    def __init__(self, prefix: str):
        self.prefix = prefix

    def __enter__(self):
        _names.prefix_stack.append(self.prefix)
        return self

    def __exit__(self, *exc):
        _names.prefix_stack.pop()


def _hint(cls_name: str) -> str:
    hint = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", cls_name)
    return re.sub("([a-z0-9])([A-Z])", r"\1\2", hint).lower()


class HybridBlock(nn.Module):
    """Base block: an ``nn.Module`` with an MXNet prefix and a
    :class:`ParameterDict` of its own parameters. ``device`` (default: the
    card) is where its parameters are allocated."""

    def __init__(self, prefix=None, device=None):
        super().__init__()
        self._prefix = prefix if prefix is not None \
            else _names.next_prefix(_hint(type(self).__name__))
        self._params = ParameterDict(self._prefix)
        self._device = None if device is None else torch.device(device)
        self._deferred = []      # own parameters whose shape is not known

    # -- naming ---------------------------------------------------------
    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self) -> name_scope:
        return name_scope(self._prefix)

    # -- parameters -----------------------------------------------------
    def _new_param(self, name, shape, grad_req="write", init=None,
                   dtype=torch.float32, allow_deferred_init=False
                   ) -> Parameter:
        """Declare ``self.<name>`` on this block's device: an
        ``nn.Parameter`` if trained, a buffer if ``grad_req == 'null'``.
        A shape with a 0 (allowed with ``allow_deferred_init``) leaves the
        attribute ``None`` until the first forward knows it. Values are set
        by :meth:`initialize` or by weight conversion."""
        shape = tuple(int(s) for s in shape)
        known = all(s > 0 for s in shape)
        check(known or allow_deferred_init,
              f"{self._prefix}{name}: shape {shape} must be fully known "
              "(this layer cannot defer it)")
        device = resolve_device(self._device)
        t = torch.empty(shape, dtype=dtype, device=device) if known \
            else None
        if grad_req == "null":
            self.register_buffer(name, t)
        else:
            self.register_parameter(name, None if t is None
                                    else nn.Parameter(t))
        p = Parameter(self._prefix + name, self, name, shape, grad_req, init,
                      dtype, device)
        self._params[p.name] = p
        if not known:
            self._deferred.append(p)
        return p

    def infer_shape_from_inputs(self, *args, **kwargs) -> None:
        """Fill the deferred parameters' shapes from the inputs (each
        layer's rule; ref: the JAX package's block.py)."""
        raise DeferredInitializationError(
            f"{type(self).__name__} has uninitialized-shape parameters and "
            "no shape inference rule; initialize with explicit shapes")

    def _finish_deferred(self, *args, **kwargs) -> None:
        with torch.no_grad():
            self.infer_shape_from_inputs(*args, **kwargs)
        for p in self._deferred:
            if p.tensor is None:
                p._finish_deferred()
        self._deferred = []

    def register_child(self, block, name=None) -> None:
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self) -> ParameterDict:
        """Own parameters, then each child's, in build order."""
        ret = ParameterDict(self._prefix)
        ret.update(self._params)
        for child in self.children():
            if isinstance(child, HybridBlock):
                ret.update(child.collect_params())
        return ret

    def _collect_params_with_prefix(self, prefix: str = "") -> dict:
        """Parameters under structural names (``"0.weight"``,
        ``"features.3.body.1.gamma"``: child attribute names and the
        parameter's short name), which do not depend on the name counters
        (ref: the JAX package's ``block.py``; the checkpoint format)."""
        if prefix:
            prefix += "."
        ret = {prefix + k[len(self._prefix):]: v
               for k, v in self._params.items()}
        for name, child in self.named_children():
            if isinstance(child, HybridBlock):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, generator=None) -> None:
        """Fill every parameter not yet set: a parameter's own initializer
        when it has one, else ``init`` (default ``Uniform(0.07)``, MXNet's);
        names decide the bias / gamma / beta / running-stat values as in
        MXNet. Random draws use ``generator`` (default: one seeded with 0
        per device). A deferred parameter keeps the initializer and the
        generator for its block's first forward."""
        default = init_mod.create(init)
        gens = {}
        for p in self.collect_params().values():
            if p.initialized:
                continue
            gen = generator
            if gen is None:
                gen = gens.get(p.device)
                if gen is None:
                    gen = gens[p.device] = _random.seed(0, p.device)
            initializer = init_mod.create(p.init) if p.init is not None \
                else default
            if p.tensor is None:
                p._deferred_init = (initializer, gen)
                continue
            initializer(p.name, p.tensor.data, gen)
            p.initialized = True

    def __call__(self, *args, **kwargs):
        """NDArrays in, NDArrays out (see the module docstring); tensors
        in, tensors out."""
        if not any(isinstance(a, NDArray) for a in (*args,
                                                      *kwargs.values())):
            if self._deferred:
                self._finish_deferred(*args, **kwargs)
            return super().__call__(*args, **kwargs)
        args = tuple(a._data if isinstance(a, NDArray) else a for a in args)
        kwargs = {k: v._data if isinstance(v, NDArray) else v
                  for k, v in kwargs.items()}
        inputs = [t for t in (*args, *kwargs.values())
                  if isinstance(t, torch.Tensor)]
        with torch.enable_grad() if autograd.is_recording() \
                else torch.no_grad():
            out = self(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            return NDArray(_own(out, inputs))
        return type(out)(NDArray(_own(o, inputs)) for o in out)

    def cast(self, dtype) -> None:
        """Cast every parameter of the block and its children to ``dtype``
        in place (``Parameter.cast``)."""
        for p in self.collect_params().values():
            p.cast(dtype)

    def hybridize(self, active: bool = True, **kwargs) -> None:
        """No-op (see the module docstring)."""

    def extra_repr(self) -> str:
        return f"prefix={self._prefix!r}"

