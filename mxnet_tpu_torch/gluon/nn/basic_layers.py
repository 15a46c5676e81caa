"""Gluon basic layers (ref: the JAX package's ``gluon/nn/basic_layers.py``;
python/mxnet/gluon/nn/basic_layers.py).

Each layer's ``forward`` calls the registered op functions of
``ops/nn.py`` on tensors (other registered ops through ``_F``). Its
``hybrid_forward(F, x, **params)`` is the symbolic twin that
``HybridBlock.export`` calls with ``F = mx.sym``: the JAX layer's ops and
attributes, so both packages write the same graph. A width
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

    def hybrid_forward(self, F, x):
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

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, num_hidden=self._units,
                                   no_bias=True, flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   no_bias=False, flatten=self._flatten)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
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

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)

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
        self._center = center
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

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out, _, _ = F.BatchNorm(
            x, gamma, beta, running_mean, running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)
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

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


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

    def hybrid_forward(self, F, x, gamma, beta):
        out, _, _ = F.LayerNorm(x, gamma, beta, axis=self._axis,
                                eps=self._epsilon)
        return out


class Embedding(HybridBlock):
    """(ref: nn.Embedding) rows of an ``(input_dim, output_dim)`` table.

    With ``sparse_grad=True`` the weight's gradient is row_sparse: only
    the looked-up rows, never the dense table (``grad_stype``; inside a
    hybridized block the whole-graph backward gives the dense gradient,
    with a warning, as in the JAX package, ``cached_op.py``). Whatever
    ``sparse_grad`` is, the attribute ``weight`` is the
    :class:`Parameter` record, as in MXNet (``weight.data()``,
    ``weight.grad()``: a ``RowSparseNDArray``, which no torch tensor's
    ``.grad`` could hold), and the tensor is the attribute
    ``weight_table``."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 device=None):
        super().__init__(prefix=prefix, device=device)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = bool(sparse_grad)
        p = self._new_param("weight", (input_dim, output_dim),
                            init=weight_initializer,
                            grad_stype="row_sparse" if sparse_grad
                            else "default", attr="weight_table")
        object.__setattr__(self, "weight", p)

    def forward(self, x):
        return F.embedding(x, self.weight_table, input_dim=self._input_dim,
                           output_dim=self._output_dim,
                           sparse_grad=self._sparse_grad)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim,
                           sparse_grad=self._sparse_grad)

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"


class Flatten(HybridBlock):
    """(ref: nn.Flatten) ``(N, ...)`` -> ``(N, prod(...))``."""

    def forward(self, x):
        return _F.flatten(x)

    def hybrid_forward(self, F, x):
        return F.flatten(x)


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
            self._func = lambda F, *args: getattr(F, function)(*args)
        else:
            self._func = function

    def forward(self, *args):
        return self._func(_F, *args)

    def hybrid_forward(self, F, *args):
        return self._func(F, *args)
