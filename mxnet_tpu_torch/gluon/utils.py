"""Gluon utilities (ref: python/mxnet/gluon/utils.py; the JAX package's
``gluon/utils.py``).

``split_data`` / ``split_and_load`` cut a batch along an axis and place
the pieces on contexts; ``clip_global_norm`` rescales arrays in place so
their joint L2 norm is at most ``max_norm``; ``check_sha1`` hashes a
file. ``download`` raises: the port reaches no network.
"""
from __future__ import annotations

import hashlib
import math
import warnings
from typing import List

import torch

from ..base import MXNetError, check
from ..ndarray import ndarray as _nd

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download"]


def split_data(data, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List:
    """``num_slice`` pieces of ``data`` along ``batch_axis``, the last one
    taking the remainder; an uneven split raises with ``even_split``."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"cannot evenly split batch of {size} into {num_slice}")
    step = size // num_slice
    return [data.slice_axis(axis=batch_axis, begin=i * step,
                            end=(i + 1) * step if i < num_slice - 1
                            else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis: int = 0,
                   even_split: bool = True) -> List:
    """``data`` (an NDArray or anything ``mx.nd.array`` takes) split over
    ``ctx_list``, one piece on each context."""
    if not isinstance(data, _nd.NDArray):
        data = _nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm: float, check_isfinite: bool = True):
    """Scale ``arrays`` in place by ``max_norm / (norm + 1e-8)`` when that
    is below 1, ``norm`` their joint L2 norm (each array's norm in its own
    dtype, summed in float64 on the host, as the JAX package does);
    returns the norm. A non-finite norm warns with ``check_isfinite``."""
    check(len(arrays) > 0, "need at least one array")
    total = math.sqrt(sum(float(a.norm().asscalar()) ** 2 for a in arrays))
    if check_isfinite and not math.isfinite(total):
        warnings.warn("nan or inf in clip_global_norm")
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for a in arrays:
                a._data.mul_(scale)
    return total


def check_sha1(filename: str, sha1_hash: str) -> bool:
    """Whether the file's SHA-1 hex digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """Raises: the port downloads nothing (the JAX package's behaviour)."""
    raise MXNetError("network downloads are disabled in this environment")
