"""Gluon basic layers (ref: the JAX package's ``gluon/nn/basic_layers.py``;
python/mxnet/gluon/nn/basic_layers.py).

Each layer's ``forward`` calls the registered op functions of
``ops/nn.py`` on tensors (other registered ops through ``_F``). A width
given as 0 (``in_units``, ``in_channels``) is deferred: the layer's
``infer_shape_from_inputs`` reads it from the first input, with the JAX
package's rule.
"""
from __future__ import annotations

import torch

from ... import autograd
from ...ops import nn as F
from ...ops import registry as _reg
from ...util import is_recomputing
from ..block import HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "InstanceNorm", "LayerNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda"]


class _TensorOps:
    """``F`` for a port block's function: ``F.<op>(*tensors, **params)``
    runs the registered op on tensors."""

    def __getattr__(self, name):
        opdef = _reg.get_op(name)
        return lambda *ts, **params: _reg.invoke(opdef, ts, params)


_F = _TensorOps()


class HybridSequential(HybridBlock):
    """Blocks applied in order (ref: nn.HybridSequential)."""

    def add(self, *blocks) -> None:
        for b in blocks:
            self.register_child(b)

    def forward(self, x):
        for child in self.children():
            x = child(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(HybridSequential):
    """(ref: nn.Sequential) The same container: every port block runs
    eagerly."""


class Dense(HybridBlock):
    """Fully-connected layer (ref: nn.Dense -> FullyConnected).
    ``in_units=0`` is read from the first input: the product of its
    non-batch extents with ``flatten``, else its last extent."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self._use_bias = use_bias
        self._new_param("weight", (units, in_units), init=weight_initializer,
                        allow_deferred_init=True)
        if use_bias:
            self._new_param("bias", (units,), init=bias_initializer)

    def infer_shape_from_inputs(self, x):
        in_units = 1
        if self._flatten:
            for s in x.shape[1:]:
                in_units *= s
        else:
            in_units = x.shape[-1]
        self.params[self.prefix + "weight"].shape_hint((self._units,
                                                        in_units))

    def forward(self, x):
        bias = (self.bias,) if self._use_bias else ()
        out = F.fully_connected(x, self.weight, *bias,
                                num_hidden=self._units,
                                no_bias=not self._use_bias,
                                flatten=self._flatten)
        if self._activation is not None:
            out = F.activation(out, act_type=self._activation)
        return out

    def extra_repr(self):
        return f"{self._units}, act={self._activation}"


class Dropout(HybridBlock):
    """(ref: nn.Dropout) Active only in training (``autograd``'s mode);
    draws from ``generator``, default the device's default generator."""

    def __init__(self, rate, axes=(), generator=None, prefix=None,
                 device=None):
        super().__init__(prefix=prefix, device=device)
        self._rate = rate
        self._axes = tuple(axes)
        self._generator = generator

    def forward(self, x):
        return F.dropout(x, p=self._rate, axes=self._axes,
                         _training=autograd.is_training(),
                         generator=self._generator)

    def extra_repr(self):
        return f"p={self._rate}"


class BatchNorm(HybridBlock):
    """(ref: nn.BatchNorm). gamma/beta are trained; running_mean /
    running_var are f32 buffers (aux states) blended in training mode as
    ``running * momentum + batch * (1 - momentum)`` with the BIASED batch
    variance — MXNet's rule, not PyTorch's. ``in_channels=0`` is read from
    the first input's ``axis``.

    The mode is ``autograd.is_training()`` (``record()``,
    ``train_mode()``; the trainer sets it around its forward), as the JAX
    package passes ``_training``; ``nn.Module.training`` decides nothing.
    Training normalises by the batch statistics and blends them into the
    running ones; otherwise the running statistics normalise and stay."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        c = (in_channels,)
        self._new_param("gamma", c, "write" if scale else "null",
                        gamma_initializer, allow_deferred_init=True)
        self._new_param("beta", c, "write" if center else "null",
                        beta_initializer, allow_deferred_init=True)
        self._new_param("running_mean", c, "null", running_mean_initializer,
                        allow_deferred_init=True)
        self._new_param("running_var", c, "null",
                        running_variance_initializer,
                        allow_deferred_init=True)

    def infer_shape_from_inputs(self, x, *rest):
        c = x.shape[self._axis]
        for p in self.params.values():
            p.shape_hint((c,))

    def _update_running_stats(self, training, mean, var) -> None:
        """Momentum-blend the batch stats into the running buffers, in
        place (training mode only; ref: basic_layers.py
        _update_running_stats). A checkpoint's recompute in backward
        (``util.is_recomputing``) leaves them as the forward moved them."""
        if training and not self._use_global_stats and \
                not is_recomputing():
            m = self._momentum
            with torch.no_grad():
                self.running_mean.copy_(self.running_mean * m
                                        + mean * (1 - m))
                self.running_var.copy_(self.running_var * m + var * (1 - m))

    def forward(self, x):
        training = autograd.is_training()
        out, mean, var = F.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            _training=training)
        self._update_running_stats(training, mean, var)
        return out

    def extra_repr(self):
        return f"axis={self._axis}"


class InstanceNorm(HybridBlock):
    """(ref: nn.InstanceNorm) over channel axis 1; ``in_channels=0`` is
    read from the first input."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._epsilon = epsilon
        c = (in_channels,)
        self._new_param("gamma", c, "write" if scale else "null",
                        gamma_initializer, allow_deferred_init=True)
        self._new_param("beta", c, "write" if center else "null",
                        beta_initializer, allow_deferred_init=True)

    def infer_shape_from_inputs(self, x):
        for p in self.params.values():
            p.shape_hint((x.shape[1],))

    def forward(self, x):
        return F.instance_norm(x, self.gamma, self.beta, eps=self._epsilon)


class LayerNorm(HybridBlock):
    """(ref: nn.LayerNorm) over ``axis``; ``in_channels=0`` is read from
    the first input."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._axis = axis
        self._epsilon = epsilon
        c = (in_channels,)
        self._new_param("gamma", c, "write" if scale else "null",
                        gamma_initializer, allow_deferred_init=True)
        self._new_param("beta", c, "write" if center else "null",
                        beta_initializer, allow_deferred_init=True)

    def infer_shape_from_inputs(self, x):
        for p in self.params.values():
            p.shape_hint((x.shape[self._axis],))

    def forward(self, x):
        out, _, _ = F.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                                 eps=self._epsilon)
        return out


class Embedding(HybridBlock):
    """(ref: nn.Embedding) rows of an ``(input_dim, output_dim)`` table.
    A row-sparse gradient (``sparse_grad=True``) is not ported (ROADMAP
    A11)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 device=None):
        super().__init__(prefix=prefix, device=device)
        if sparse_grad:
            raise _reg.NotPortedError(
                "Embedding(sparse_grad=True): row-sparse gradients are not "
                "ported yet (see ROADMAP.md, queue A11)")
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._new_param("weight", (input_dim, output_dim),
                        init=weight_initializer)

    def forward(self, x):
        return F.embedding(x, self.weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"


class Flatten(HybridBlock):
    """(ref: nn.Flatten) ``(N, ...)`` -> ``(N, prod(...))``."""

    def forward(self, x):
        return _F.flatten(x)


class Lambda(HybridBlock):
    """(ref: nn.Lambda) A function of the inputs: a callable, or the name
    of a registered op (``"tanh"``)."""

    def __init__(self, function, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._func = getattr(_F, function) if isinstance(function, str) \
            else function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """(ref: nn.HybridLambda) The name of a registered op, or a callable
    ``f(F, *inputs)`` whose ``F.<op>`` runs registered ops on tensors."""

    def __init__(self, function, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        if isinstance(function, str):
            op = getattr(_F, function)
            self._func = lambda F, *args: op(*args)
        else:
            self._func = function

    def forward(self, *args):
        return self._func(_F, *args)
