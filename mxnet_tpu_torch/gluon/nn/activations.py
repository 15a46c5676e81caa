"""Gluon activation layers (ref: the JAX package's
``gluon/nn/activations.py``; python/mxnet/gluon/nn/activations.py), over
the ``Activation`` and ``LeakyReLU`` ops of ``ops/nn.py``."""
from __future__ import annotations

from ... import initializer
from ...ops import nn as F
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


class Activation(HybridBlock):
    """relu, sigmoid, tanh, softrelu or softsign."""

    def __init__(self, activation, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._act_type = activation

    def forward(self, x):
        return F.activation(x, act_type=self._act_type)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class LeakyReLU(HybridBlock):
    """``x`` where ``x >= 0``, else ``alpha * x``."""

    def __init__(self, alpha, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, act_type="leaky", slope=self._alpha)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` of shape (1,), starting at
    0.25."""

    def __init__(self, alpha_initializer=None, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._new_param("alpha", (1,),
                        init=alpha_initializer or initializer.Constant(0.25))

    def forward(self, x):
        return F.leaky_relu(x, self.alpha, act_type="prelu")

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, act_type="elu", slope=self._alpha)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return F.leaky_relu(x, act_type="selu")

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def forward(self, x):
        return F.leaky_relu(x, act_type="gelu")

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._beta = beta

    def forward(self, x):
        return x * F.activation(self._beta * x, act_type="sigmoid")

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
