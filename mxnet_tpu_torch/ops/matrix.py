"""Shape manipulation, joining and splitting, indexing, and matrix products
(ref: the JAX package's ``ops/matrix.py``; src/operator/tensor/
matrix_op.cc, indexing_op.cc, dot-inl.h in the reference).

The reference's reshape codes (0, -1, -2, -3, -4) are kept exactly. Index
inputs arrive in any dtype (MXNet passes float indices) and are cast to
int64 for torch. torch has no negative-step slice; ``slice`` with a
negative step gathers the same elements with ``index_select``. The
products go to ``torch.matmul`` (cuBLAS on the card), as the JAX package
leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .registry import alias, register


def mx_reshape_shape(src_shape, target):
    """Reference reshape semantics (src/operator/tensor/matrix_op-inl.h):
    0 copy input dim; -1 infer; -2 copy all remaining; -3 merge two dims;
    -4 split one dim into the next two values."""
    target = list(target)
    out = []
    i = 0  # index into src
    j = 0  # index into target
    while j < len(target):
        t = target[j]
        if t > 0:
            out.append(t)
            i += 1
        elif t == 0:
            out.append(src_shape[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src_shape[i:])
            i = len(src_shape)
        elif t == -3:
            out.append(src_shape[i] * src_shape[i + 1])
            i += 2
        elif t == -4:
            d1, d2 = target[j + 1], target[j + 2]
            if d1 == -1:
                d1 = src_shape[i] // d2
            if d2 == -1:
                d2 = src_shape[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            raise MXNetError(f"invalid reshape code {t}")
        j += 1
    if out.count(-1) > 1:
        raise MXNetError("reshape can infer at most one dimension")
    return tuple(out)


def _long(idx):
    return idx.to(torch.int64)


@register("reshape", aliases=("Reshape",))
def _reshape(x, shape=(), reverse: bool = False, **_):
    return x.reshape(mx_reshape_shape(x.shape, tuple(shape)))


@register("reshape_like")
def _reshape_like(x, y, **_):
    return x.reshape(y.shape)


@register("flatten", aliases=("Flatten",))
def _flatten(x):
    return x.reshape(x.shape[0], -1) if x.dim() else x.reshape(1, 1)


@register("transpose")
def _transpose(x, axes=()):
    return x.permute(*(tuple(axes) if axes else range(x.dim() - 1, -1, -1)))


@register("expand_dims")
def _expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(axis if isinstance(axis, int) else tuple(axis))


@register("swapaxes", aliases=("SwapAxis",))
def _swapaxes(x, dim1=0, dim2=0):
    return x.swapaxes(dim1, dim2)


@register("moveaxis")
def _moveaxis(x, source=0, destination=0):
    return x.movedim(source, destination)


def _slice_dim(x, dim, begin, end, step):
    """x[begin:end:step] along ``dim``, python semantics, any step sign."""
    start, stop, st = slice(begin, end, step).indices(x.shape[dim])
    if st > 0:
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start, stop, st)
        return x[tuple(idx)]
    keep = torch.arange(start, stop, st, device=x.device)
    return x.index_select(dim, keep)


@register("slice", aliases=("crop",))
def _slice(x, begin=(), end=(), step=()):
    step = step or (None,) * len(begin)
    for d, (b, e, s) in enumerate(zip(begin, end, step)):
        x = _slice_dim(x, d, b, e, s)
    return x


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None):
    return _slice_dim(x, axis % x.dim(), begin, end, None)


@register("slice_like")
def _slice_like(x, y, axes=()):
    ax = tuple(axes) if axes else tuple(range(min(x.dim(), y.dim())))
    idx = [slice(None)] * x.dim()
    for a in ax:
        idx[a] = slice(0, y.shape[a])
    return x[tuple(idx)]


@register("flip", aliases=("reverse",))
def _flip(x, axis=0):
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


@register("tile")
def _tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register("repeat")
def _repeat(x, repeats=1, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("Pad", aliases=("pad",))
def _pad(x, mode="constant", pad_width=(), constant_value=0.0):
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = [p for pair in reversed(pairs) for p in pair]
        return F.pad(x, flat, mode="constant", value=constant_value)
    if mode in ("edge", "reflect"):
        # torch pads the trailing (spatial) dims in these modes; the
        # reference's Pad leaves the batch and channel axes alone in them
        if any(pairs[i] != (0, 0) for i in range(min(2, len(pairs)))):
            raise MXNetError(f"Pad mode {mode!r} pads spatial axes only")
        flat = [p for pair in reversed(pairs[2:]) for p in pair]
        return F.pad(x, flat, mode="replicate" if mode == "edge"
                     else "reflect")
    raise MXNetError(f"unsupported pad mode {mode}")


@register("clip")
def _clip(x, a_min=0.0, a_max=0.0):
    return torch.clamp(x, a_min, a_max)


@register("concat", aliases=("Concat",), variadic=True)
def _concat(*xs, dim=1, num_args=None):
    return torch.cat(xs, dim=dim)


@register("stack", variadic=True)
def _stack(*xs, axis=0, num_args=None):
    return torch.stack(xs, dim=axis)


def _split_outputs(n_inputs, params):
    return int(params.get("num_outputs", 1))


def _finish_split(parts, axis, squeeze_axis):
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("split", aliases=("SliceChannel",), num_outputs=_split_outputs)
def _split(x, num_outputs=1, axis=1, squeeze_axis=False):
    n = x.shape[axis]
    if n % num_outputs:
        raise MXNetError(f"split: axis of size {n} does not divide into "
                         f"{num_outputs} equal parts")
    return _finish_split(torch.split(x, n // num_outputs, dim=axis), axis,
                         squeeze_axis)


def _split_v2_outputs(n_inputs, params):
    sections = int(params.get("sections", 0))
    if sections > 0:
        return sections
    return max(1, len(tuple(params.get("indices", ()))))


@register("_split_v2", num_outputs=_split_v2_outputs)
def _split_v2(x, indices=(), axis=1, squeeze_axis=False, sections=0):
    """Split by equal sections or by boundary indices. As the JAX
    package does (ops/misc_ops.py _split_v2), ``indices[0]`` is taken for
    the leading 0 that MXNet's serialised attributes carry and dropped:
    the array is split at ``indices[1:]`` with numpy's slice rules, so
    ``len(indices)`` parts come out whatever the first index is."""
    axis = int(axis)
    n = x.shape[axis]
    if int(sections) > 0:
        if n % int(sections):
            raise MXNetError("array split does not result in an equal "
                             "division")
        parts = torch.split(x, n // int(sections), dim=axis)
    else:
        bounds = [0] + [int(i) for i in indices][1:] + [n]
        lead = (slice(None),) * (axis % x.dim())
        parts = [x[lead + (slice(b, e),)]
                 for b, e in zip(bounds[:-1], bounds[1:])]
    return _finish_split(parts, axis, squeeze_axis)


@register("take")
def _take(x, indices, axis=0, mode="clip"):
    idx = _long(indices)
    n = x.shape[axis]
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


@register("pick")
def _pick(x, index, axis=-1, keepdims=False, mode="clip"):
    ax = axis % x.dim()
    idx = _long(index).clamp(0, x.shape[ax] - 1).unsqueeze(ax)
    out = torch.take_along_dim(x, idx, dim=ax)
    return out if keepdims else out.squeeze(ax)


@register("gather_nd")
def _gather_nd(x, indices):
    return x[tuple(_long(indices))]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(_long(indices)), data)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, data, indices, shape=()):
    return lhs.index_put(tuple(_long(indices)), data.to(lhs.dtype))


@register("one_hot")
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    hot = _long(indices).unsqueeze(-1) == torch.arange(
        depth, device=indices.device)
    d = torch_dtype(dtype)
    return torch.where(hot, torch.tensor(on_value, dtype=d,
                                         device=indices.device),
                       torch.tensor(off_value, dtype=d,
                                    device=indices.device))


@register("where")
def _where(cond, a, b):
    return torch.where(cond != 0, a, b)


@register("depth_to_space")
def _depth_to_space(x, block_size=1):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def _space_to_depth(x, block_size=1):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


@register("diag")
def _diag(x, k=0, axis1=0, axis2=1):
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=axis1, dim2=axis2)


@register("ravel_multi_index", differentiable=False)
def _ravel_multi_index(data, shape=()):
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    st = torch.tensor(strides[::-1], dtype=data.dtype, device=data.device)
    return torch.sum(data * st[:, None], dim=0)


@register("unravel_index", differentiable=False)
def _unravel_index(data, shape=()):
    out, rem = [], _long(data)
    for s in reversed(shape):
        out.append(rem % s)
        rem = rem // s
    return torch.stack(out[::-1], dim=0).to(data.dtype)


alias("_ravel_multi_index", "ravel_multi_index")
alias("_unravel_index", "unravel_index")


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _t(x, flag):
    if not flag:
        return x
    return x.t() if x.dim() == 2 else x.permute(*range(x.dim() - 1, -1, -1))


@register("dot")
def _dot(a, b, transpose_a=False, transpose_b=False, forward_stype=None):
    x, y = _t(a, transpose_a), _t(b, transpose_b)
    if x.dim() == 1 and y.dim() == 1:
        return torch.dot(x, y)
    if x.dim() == 2 and y.dim() == 2:
        return torch.matmul(x, y)
    # the reference's dot on >2-D: contract a's last axis with b's first
    return torch.tensordot(x, y, dims=([x.dim() - 1], [0]))


@register("batch_dot")
def _batch_dot(a, b, transpose_a=False, transpose_b=False,
               forward_stype=None):
    x = a.swapaxes(-1, -2) if transpose_a else a
    y = b.swapaxes(-1, -2) if transpose_b else b
    return torch.matmul(x, y)


@register("matmul")
def _matmul(a, b):
    """numpy matmul semantics (batched over leading axes)."""
    return torch.matmul(a, b)


@register("khatri_rao", variadic=True)
def _khatri_rao(*mats):
    """Column-wise Kronecker product (ref: src/operator/contrib/krprod.cc)."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, m.shape[1])
    return out


@register("batch_take")
def _batch_take(a, indices):
    """out[i] = a[i, indices[i]] (ref: tensor/indexing_op.cc batch_take)."""
    idx = _long(indices.reshape(-1))
    return a[torch.arange(a.shape[0], device=a.device), idx]
