"""Reductions with the reference's axis semantics: ``axis`` (int, tuple or
None for all), ``keepdims`` and ``exclude`` (reduce every axis but those)
(ref: the JAX package's ``ops/reduce.py``;
src/operator/tensor/broadcast_reduce_op_value.cc)."""
from __future__ import annotations

import torch

from ..base import env
from .registry import register


def _axes(x, axis, exclude: bool):
    if axis is None or axis == ():
        ax = tuple(range(x.dim()))
    elif isinstance(axis, int):
        ax = (axis % x.dim(),)
    else:
        ax = tuple(a % x.dim() for a in axis)
    if exclude:
        ax = tuple(i for i in range(x.dim()) if i not in ax)
    return ax


def _safe_acc(x):
    """MXNET_SAFE_ACCUMULATION: accumulate float16/bfloat16 reductions in
    float32 (ref: broadcast_reduce-inl.h AType promotion behind the same
    flag). Returns (maybe-upcast x, dtype to cast the result back to)."""
    if env.get("MXNET_SAFE_ACCUMULATION") and \
            x.dtype in (torch.float16, torch.bfloat16):
        return x.float(), x.dtype
    return x, None


def _sum(x, ax, keepdim):
    # integer sums keep their type, as jnp.sum does (torch widens to int64)
    dt = x.dtype if not (x.is_floating_point() or x.dtype == torch.bool) \
        else None
    return torch.sum(x, dim=ax, keepdim=keepdim, dtype=dt)


def _mean(x, ax, keepdim):
    x = x if x.is_floating_point() else x.float()
    return torch.mean(x, dim=ax, keepdim=keepdim)


def _prod(x, ax, keepdim):
    for a in sorted(ax, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


def _nanprod(x, ax, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), ax,
                 keepdim)


def _reduce(fn, accumulating: bool = True):
    def impl(x, axis=None, keepdims: bool = False, exclude: bool = False,
             **_):
        back = None
        if accumulating:
            x, back = _safe_acc(x)
        ax = _axes(x, axis, exclude)
        # no axis left to reduce: the input as it is (jnp with axis=())
        out = fn(x, ax, bool(keepdims)) if ax else x
        return out if back is None else out.to(back)
    return impl


register("sum", aliases=("sum_axis",))(_reduce(_sum))
register("mean")(_reduce(_mean))
register("prod")(_reduce(_prod))
register("nansum")(_reduce(
    lambda x, ax, k: torch.nansum(x, dim=ax, keepdim=k)))
register("nanprod")(_reduce(_nanprod))
register("max", aliases=("max_axis",))(_reduce(
    lambda x, ax, k: torch.amax(x, dim=ax, keepdim=k), accumulating=False))
register("min", aliases=("min_axis",))(_reduce(
    lambda x, ax, k: torch.amin(x, dim=ax, keepdim=k), accumulating=False))


@register("norm")
def _norm(x, ord: int = 2, axis=None, keepdims: bool = False, **_):
    x, back = _safe_acc(x)
    if axis is None:
        ax = tuple(range(x.dim()))
    elif isinstance(axis, int):
        ax = (axis,)
    else:
        ax = tuple(axis)
    if ord == 1:
        out = torch.sum(torch.abs(x), dim=ax, keepdim=keepdims)
    else:
        out = torch.sqrt(torch.sum(x * x, dim=ax, keepdim=keepdims))
    return out if back is None else out.to(back)


@register("_square_sum", aliases=("square_sum",))
def _square_sum(data, axis=None, keepdims: bool = False, exclude=False,
                **_):
    """sum(data**2) (ref: src/operator/tensor/square_sum-inl.h)."""
    x, back = _safe_acc(data)
    out = torch.sum(x * x, dim=_axes(x, axis, bool(exclude)),
                    keepdim=keepdims)
    return out if back is None else out.to(back)


def _arg(fn, x, axis, keepdims):
    if axis is None:
        out = fn(x.reshape(-1))
        return out.reshape((1,) * x.dim()) if keepdims else out
    return fn(x, dim=axis, keepdim=keepdims)


@register("argmax", differentiable=False)
def _argmax(x, axis=None, keepdims: bool = False, **_):
    return _arg(torch.argmax, x, axis, keepdims).to(torch.float32)


@register("argmin", differentiable=False)
def _argmin(x, axis=None, keepdims: bool = False, **_):
    return _arg(torch.argmin, x, axis, keepdims).to(torch.float32)


@register("argmax_channel", differentiable=False)
def _argmax_channel(x, **_):
    return torch.argmax(x, dim=1).to(torch.float32)
