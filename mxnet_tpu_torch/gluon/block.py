"""Gluon HybridBlock as a ``torch.nn.Module`` (ref:
python/mxnet/gluon/block.py).

Naming follows MXNet: a block's prefix is its class name, lower-cased with
CamelCase breaks as the JAX package spells them, plus a per-scope counter
(``res_netv10_``); blocks built inside ``with parent.name_scope():`` take
the parent's prefix in front. Parameter names are ``prefix + short name``,
so a port model built in the same order as a JAX model carries the same
names (up to the top-level counter).

``hybridize()`` is a no-op: PyTorch runs the forward eagerly and the port
has no graph-capture path yet (a CUDA graph of the training step is later
work). It is kept so MXNet-style code runs unchanged.
"""
from __future__ import annotations

import re
import threading

import torch
from torch import nn

from ..base import check
from ..context import resolve_device
from .. import initializer as init_mod
from .. import random as _random
from .parameter import Parameter, ParameterDict

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
                   dtype=torch.float32) -> Parameter:
        """Allocate ``self.<name>`` on this block's device: an
        ``nn.Parameter`` if trained, a buffer if ``grad_req == 'null'``.
        Values are set by :meth:`initialize` or by weight conversion."""
        shape = tuple(int(s) for s in shape)
        check(all(s > 0 for s in shape),
              f"{self._prefix}{name}: shape {shape} must be fully known "
              "(the port has no deferred initialisation; pass in_channels "
              "/ in_units)")
        t = torch.empty(shape, dtype=dtype,
                        device=resolve_device(self._device))
        if grad_req == "null":
            self.register_buffer(name, t)
        else:
            self.register_parameter(name, nn.Parameter(t))
        p = Parameter(self._prefix + name, self, name, grad_req, init)
        self._params[p.name] = p
        return p

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

    def initialize(self, init=None, generator=None) -> None:
        """Fill every parameter not yet set: a parameter's own initializer
        when it has one, else ``init`` (default ``Xavier()``); names decide
        the bias / gamma / beta / running-stat values as in MXNet. Random
        draws use ``generator`` (default: one seeded with 0 per device)."""
        default = init_mod.create(init) if init is not None \
            else init_mod.Xavier()
        gens = {}
        for p in self.collect_params().values():
            if p.initialized:
                continue
            arr = p.data()
            gen = generator
            if gen is None:
                gen = gens.get(arr.device)
                if gen is None:
                    gen = gens[arr.device] = _random.seed(0, arr.device)
            initializer = init_mod.create(p.init) if p.init is not None \
                else default
            initializer(p.name, arr.data, gen)
            p.initialized = True

    def hybridize(self, active: bool = True, **kwargs) -> None:
        """No-op (see the module docstring)."""

    def extra_repr(self) -> str:
        return f"prefix={self._prefix!r}"

