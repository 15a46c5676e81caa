"""Weight initializers (ref: python/mxnet/initializer.py).

The reference's name-pattern dispatch is kept: ``*bias``, ``*beta`` and
``*running_mean`` start at zero, ``*gamma`` and ``*running_var`` at one,
everything else goes to the initializer's ``_init_weight``. Random draws use
the ``torch.Generator`` the caller passes.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "Zero", "One", "Xavier", "create"]


class Initializer:
    """Base initializer: fills a tensor in place according to its name."""

    def __call__(self, name: str, arr: torch.Tensor,
                 generator: torch.Generator = None) -> None:
        with torch.no_grad():
            if name.endswith(("bias", "beta", "running_mean", "moving_mean")):
                arr.zero_()
            elif name.endswith(("gamma", "running_var", "moving_var")):
                arr.fill_(1.0)
            else:
                self._init_weight(arr, generator)

    def _init_weight(self, arr, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class Zero(Initializer):
    def _init_weight(self, arr, generator):
        arr.zero_()


class One(Initializer):
    def _init_weight(self, arr, generator):
        arr.fill_(1.0)


class Xavier(Initializer):
    """(ref: initializer.py Xavier; MXNet defaults uniform / avg / 3). The
    fans follow the reference's formula on the stored shape."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        if rnd_type not in ("uniform", "gaussian"):
            raise MXNetError(f"invalid rnd_type {rnd_type}")
        if factor_type not in ("avg", "in", "out"):
            raise MXNetError(f"invalid factor_type {factor_type}")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, arr, generator):
        shape = arr.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale if len(shape) > 1 else shape[0]
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=generator)
        else:
            arr.normal_(0.0, scale, generator=generator)

    def __repr__(self):
        return (f"Xavier(rnd_type={self.rnd_type!r}, "
                f"factor_type={self.factor_type!r}, "
                f"magnitude={self.magnitude})")


_REGISTRY = {"zero": Zero, "zeros": Zero, "one": One, "ones": One,
             "xavier": Xavier}


def create(init) -> Initializer:
    """An :class:`Initializer` from an instance or a registered name."""
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str) and init.lower() in _REGISTRY:
        return _REGISTRY[init.lower()]()
    raise MXNetError(f"cannot create initializer from {init!r}")
