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
as they are. A missing, extra or mis-shaped name raises; a deferred
parameter (a 0 in its shape) takes the array's extent there and its
tensor is created from it. Values are written in place into each block's
tensor (``Parameter.set_data``), so a CUDA graph the trainer captured over
the net stays valid.

``from_transformer_params(params, config, device=None)`` takes the JAX
``models.transformer.init_params`` pytree as numpy arrays and returns the
port's nested dict on ``device`` (default: the card). The layouts are the
JAX package's (``w_qkv`` ``(d, 3d)``, ``embed`` ``(V, d)`` ...), so nothing
is transposed; MoE layers' leaves sit a level deeper
(``layer1/moe/w_in``). Names, shapes and each leaf's dtype
(``param_dtypes``: ``config.dtype`` as float32 arrays or the ``bfloat16``
arrays that ``np.asarray`` makes of JAX bf16 arrays, and float32 for every
MoE router ``gate``) must match exactly, or it raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .models.transformer import (flat_params, nest_params,
                                 param_dtypes, param_shapes)

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
        if arr.ndim != len(p.shape) or any(
                s not in (0, a) for s, a in zip(p.shape, arr.shape)):
            raise MXNetError(f"parameter {name}: shape {tuple(arr.shape)} "
                             f"does not match {p.shape}")
        p.set_data(arr)


def from_transformer_params(params, config, device=None) -> dict:
    dev = resolve_device(device)
    got = flat_params(params)
    shapes = flat_params(param_shapes(config))
    dtypes = flat_params(param_dtypes(config))
    missing = sorted(set(shapes) - set(got))
    extra = sorted(set(got) - set(shapes))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    out = {}
    for name, shape in shapes.items():
        arr = np.asarray(got[name])
        if tuple(arr.shape) != shape:
            raise MXNetError(f"parameter {name}: shape {tuple(arr.shape)} "
                             f"does not match {shape}")
        want_dtype = str(dtypes[name]).replace("torch.", "")
        if str(arr.dtype) != want_dtype:
            raise MXNetError(f"parameter {name}: dtype {arr.dtype} is not "
                             f"the configured {want_dtype}")
        out[name] = torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=dtypes[name])
    return nest_params(out)
