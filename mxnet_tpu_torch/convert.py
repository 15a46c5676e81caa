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

``from_transformer_params(params, config, device=None)`` takes the JAX
``models.transformer.init_params`` pytree as numpy arrays and returns the
port's nested dict on ``device`` (default: the card). The layouts are the
JAX package's (``w_qkv`` ``(d, 3d)``, ``embed`` ``(V, d)`` ...), so nothing
is transposed. Names, shapes and the dtype (``config.dtype``: float32
arrays, or the ``bfloat16`` arrays that ``np.asarray`` makes of JAX bf16
arrays) must match exactly, or it raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .models.transformer import _dt, param_shapes

__all__ = ["from_mxnet_tpu_params", "from_transformer_params"]


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


def from_transformer_params(params, config, device=None) -> dict:
    dev = resolve_device(device)
    dt = _dt(config)
    want_dtype = str(dt).replace("torch.", "")

    def walk(got, want, path):
        if not isinstance(got, dict):
            raise MXNetError(f"parameter {path!r}: expected a dict")
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing or extra:
            raise MXNetError(f"parameter names differ under {path!r}: "
                             f"missing {missing[:5]}, extra {extra[:5]}")
        out = {}
        for k, shape in want.items():
            name = f"{path}{k}"
            if isinstance(shape, dict):
                out[k] = walk(got[k], shape, name + "/")
                continue
            arr = np.asarray(got[k])
            if tuple(arr.shape) != shape:
                raise MXNetError(f"parameter {name}: shape "
                                 f"{tuple(arr.shape)} does not match {shape}")
            if str(arr.dtype) != want_dtype:
                raise MXNetError(f"parameter {name}: dtype {arr.dtype} is "
                                 f"not the configured {want_dtype}")
            out[k] = torch.from_numpy(arr.astype(np.float32)).to(
                device=dev, dtype=dt)
        return out

    return walk(params, param_shapes(config), "")
