"""Gluon basic layers (ref: python/mxnet/gluon/nn/basic_layers.py)."""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops import nn as F
from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Activation"]


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


class Dense(HybridBlock):
    """Fully-connected layer (ref: nn.Dense). ``in_units`` must be given."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self._new_param("weight", (units, in_units), init=weight_initializer)
        self._use_bias = use_bias
        if use_bias:
            self._new_param("bias", (units,), init=bias_initializer)

    def forward(self, x):
        out = F.fully_connected(x, self.weight,
                                self.bias if self._use_bias else None,
                                flatten=self._flatten)
        if self._activation is not None:
            out = _activation(out, self._activation)
        return out


def _activation(x, act_type):
    if act_type == "relu":
        return F.relu(x)
    raise MXNetError(f"act_type {act_type!r} is not ported yet (relu only)")


class Activation(HybridBlock):
    """(ref: nn.Activation) ReLU only in this port."""

    def __init__(self, activation, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        if activation != "relu":
            raise MXNetError(f"act_type {activation!r} is not ported yet "
                             "(relu only)")
        self._act_type = activation

    def forward(self, x):
        return _activation(x, self._act_type)

    def extra_repr(self):
        return self._act_type


class BatchNorm(HybridBlock):
    """(ref: nn.BatchNorm). gamma/beta are trained; running_mean /
    running_var are f32 buffers (aux states) blended in training mode as
    ``running * momentum + batch * (1 - momentum)`` with the BIASED batch
    variance — MXNet's rule, not PyTorch's. ``in_channels`` must be given."""

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
                        gamma_initializer)
        self._new_param("beta", c, "write" if center else "null",
                        beta_initializer)
        self._new_param("running_mean", c, "null", running_mean_initializer)
        self._new_param("running_var", c, "null",
                        running_variance_initializer)

    def _update_running_stats(self, mean, var) -> None:
        """Momentum-blend the batch stats into the running buffers
        (training mode only; ref: basic_layers.py _update_running_stats)."""
        if self.training and not self._use_global_stats:
            m = self._momentum
            with torch.no_grad():
                self.running_mean.copy_(self.running_mean * m
                                        + mean * (1 - m))
                self.running_var.copy_(self.running_var * m + var * (1 - m))

    def forward(self, x):
        out, mean, var = F.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=self.training)
        self._update_running_stats(mean, var)
        return out

    def extra_repr(self):
        return f"axis={self._axis}"
