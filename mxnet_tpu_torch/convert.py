"""Carry weights from a JAX-package model to its port.

``from_mxnet_tpu_params(net, params)`` takes the JAX net's
``collect_params()`` values as numpy arrays (``{name: array}``), running
statistics included, and copies them into the port's ``net``. Names are
matched exactly; pass ``prefix`` (the JAX net's ``prefix``) when the two
top-level blocks were numbered differently, and that prefix is swapped for
the port net's own.

Layouts: MXNet's channel-last convolutions keep their weight as OHWI, and
so does the port's parameter (it becomes the OIHW ``channels_last`` view
the convolution wants at the call, without a copy), so arrays are copied
as they are. A missing, extra or mis-shaped name raises.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError

__all__ = ["from_mxnet_tpu_params"]


def from_mxnet_tpu_params(net, params, prefix=None) -> None:
    if prefix is not None:
        renamed = {}
        for k, v in params.items():
            if not k.startswith(prefix):
                raise MXNetError(f"parameter {k!r} does not start with "
                                 f"{prefix!r}")
            renamed[net.prefix + k[len(prefix):]] = v
        params = renamed
    ours = net.collect_params()
    missing = sorted(set(ours) - set(params))
    extra = sorted(set(params) - set(ours))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    for name, p in ours.items():
        arr = np.asarray(params[name], dtype=np.float32)
        if tuple(arr.shape) != p.shape:
            raise MXNetError(f"parameter {name}: shape {tuple(arr.shape)} "
                             f"does not match {p.shape}")
        p.set_data(arr)
