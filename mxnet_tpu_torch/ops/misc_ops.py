"""The remaining dense reference ops (ref: the dense part of the JAX
package's ``ops/misc_ops.py``): ``add_n``, the legacy ``Crop``, slice
assignment, internal identity / zeros / concat helpers, the cross-device
copy marker, and the legacy ``*_v1`` and ``_contrib_SparseEmbedding``
names. ``cast_storage`` and ``sparse_retain`` are queue A11's.
"""
from __future__ import annotations

import torch

from ..base import check
from ..context import resolve_device
from .random_ops import out_dtype
from .registry import alias, register

__all__ = []


@register("add_n", aliases=("ElementWiseSum", "_sum"), variadic=True)
def _add_n(*xs, num_args=None):
    """Elementwise sum of n inputs, added left to right (ref:
    elemwise_sum.cc add_n)."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register("Crop", variadic=True)
def _crop(*inputs, num_args=1, offset=(0, 0), h_w=(0, 0),
          center_crop=False):
    """Legacy NCHW crop (ref: src/operator/crop.cc). With two inputs the
    second (``crop_like``) gives the target H and W."""
    data = inputs[0]
    if int(num_args) >= 2 and len(inputs) >= 2:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    H, W = data.shape[2], data.shape[3]
    check(th <= H and tw <= W,
          f"Crop: target ({th}, {tw}) larger than input ({H}, {W})")
    if center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
        check(y0 + th <= H and x0 + tw <= W,
              f"Crop: offset ({y0}, {x0}) + target ({th}, {tw}) exceeds "
              f"input ({H}, {W})")
    return data[:, :, y0:y0 + th, x0:x0 + tw]


def _make_slices(shape, begin, end, step):
    """The index of ``x[begin:end:step]`` (MXNet's slice parameters; a
    missing or 0 step is 1)."""
    begin, end = tuple(begin), tuple(end)
    step = tuple(step) if step else (1,) * len(begin)
    out = []
    for i in range(len(shape)):
        if i < len(begin):
            b = begin[i]
            e = end[i] if i < len(end) else None
            s = step[i] if i < len(step) and step[i] not in (None, 0) else 1
            out.append(slice(None if b is None else int(b),
                             None if e is None else int(e), int(s)))
        else:
            out.append(slice(None))
    return tuple(out)


def _assign(lhs, sl, value):
    from ..ndarray.ndarray import _setitem
    out = lhs.clone()
    _setitem(out, sl, value)
    return out


@register("_slice_assign", aliases=("slice_assign",))
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """lhs with lhs[begin:end:step] = rhs (ref: matrix_op.cc
    _slice_assign)."""
    sl = _make_slices(lhs.shape, begin, end, step)
    return _assign(lhs, sl, rhs.to(lhs.dtype))


@register("_slice_assign_scalar", aliases=("slice_assign_scalar",))
def _slice_assign_scalar(lhs, scalar=0.0, begin=(), end=(), step=()):
    sl = _make_slices(lhs.shape, begin, end, step)
    return _assign(lhs, sl, scalar)


@register("_zeros_without_dtype", creation=True, differentiable=False)
def _zeros_without_dtype(shape=(), ctx=None, dtype=None, **_):
    """zeros whose dtype defaults to float32 (ref: init_op.cc
    _zeros_without_dtype, used for gradient buffers)."""
    return torch.zeros(tuple(shape), dtype=out_dtype(dtype),
                       device=resolve_device(ctx))


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    """lhs; rhs only lends its attributes in the reference's graph passes
    (ref: elemwise_unary_op_basic.cc)."""
    return lhs


@register("_rnn_param_concat", variadic=True)
def _rnn_param_concat(*xs, dim=0, num_args=None):
    """The flattened inputs concatenated (ref: src/operator/nn/concat.cc
    _rnn_param_concat, a 1-d concat at run time)."""
    return torch.cat([x.reshape(-1) for x in xs])


@register("_CrossDeviceCopy")
def _cross_device_copy(data):
    """The copy marker between ctx_group placements (ref:
    src/operator/cross_device_copy.cc): the identity on one device."""
    return data


# SparseEmbedding's dense forward and gradient are Embedding's, as in the
# JAX package; its row-sparse gradient is queue A11's
alias("_contrib_SparseEmbedding", "Embedding")
# the reference's pre-NNVM implementations, kept under their *_v1 names
alias("BatchNorm_v1", "BatchNorm")
alias("Convolution_v1", "Convolution")
alias("Pooling_v1", "Pooling")
