"""Ordering ops: sort / argsort / topk (ref: the JAX package's
``ops/ordering.py``; MXNet src/operator/tensor/ordering_op.cc).

``jax.lax.top_k`` and ``jnp.argsort`` are stable: equal values come out in
index order. ``torch.topk``'s order among ties is unspecified on CUDA, so
every op here is a ``torch.sort(..., stable=True)``. A descending order is
the ascending stable order flipped, as in the JAX package (so ties come
out last index first), except ``topk``, which ranks ``-data`` ascending
(ties first index first) as ``lax.top_k`` does.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, torch_dtype
from .registry import register

__all__ = ["stable_argsort"]


def stable_argsort(x, dim=-1, descending=False):
    """Indices that sort ``x`` along ``dim``, ties in index order (the
    order of ``jnp.argsort``)."""
    return torch.sort(x, dim=dim, descending=descending, stable=True)[1]


@register("sort")
def _sort(data, axis=-1, is_ascend=True):
    if axis is None:
        out = torch.sort(data.reshape(-1), stable=True)[0]
        return out if is_ascend else out.flip(0)
    out = torch.sort(data, dim=axis, stable=True)[0]
    return out if is_ascend else out.flip(axis)


@register("argsort", differentiable=False)
def _argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    if axis is None:
        idx = stable_argsort(data.reshape(-1))
        idx = idx if is_ascend else idx.flip(0)
    else:
        idx = stable_argsort(data, axis)
        idx = idx if is_ascend else idx.flip(axis)
    return idx.to(torch_dtype(dtype))


def _topk_nout(n_inputs, params):
    return 2 if params.get("ret_typ", "indices") == "both" else 1


@register("topk", num_outputs=_topk_nout, differentiable=False)
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    if axis is None:
        data_, axis_ = data.reshape(-1), 0
    else:
        axis_ = axis % data.dim()
        data_ = data.movedim(axis_, -1)
    k = int(k)
    # lax.top_k of (-data if ascending): the k largest, ties lowest index
    idx = stable_argsort(data_, -1, descending=not is_ascend)[..., :k]
    vals = torch.gather(data_, -1, idx)
    if ret_typ == "mask":
        mask = torch.zeros(data_.shape, dtype=data.dtype,
                           device=data.device)
        mask.scatter_(-1, idx, 1)
        return mask if axis is None else mask.movedim(-1, axis_)
    if axis is not None:
        vals, idx = vals.movedim(-1, axis_), idx.movedim(-1, axis_)
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx.to(torch_dtype(dtype))
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    raise MXNetError(f"unknown ret_typ {ret_typ}")
