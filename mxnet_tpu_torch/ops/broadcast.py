"""Broadcasting binary ops and broadcast shape manipulation (ref: the JAX
package's ``ops/broadcast.py``; src/operator/tensor/
elemwise_binary_broadcast_op_*.cc). torch broadcasting has numpy's rules,
as the reference does."""
from __future__ import annotations

import torch

from .elemwise import _named
from .registry import register


def _like(cond, x):
    return cond.to(x.dtype)


_BCAST = {
    "broadcast_add": lambda a, b: a + b,
    "broadcast_sub": lambda a, b: a - b,
    "broadcast_mul": lambda a, b: a * b,
    "broadcast_div": lambda a, b: a / b,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
    "broadcast_equal": lambda a, b: _like(a == b, a),
    "broadcast_not_equal": lambda a, b: _like(a != b, a),
    "broadcast_greater": lambda a, b: _like(a > b, a),
    "broadcast_greater_equal": lambda a, b: _like(a >= b, a),
    "broadcast_lesser": lambda a, b: _like(a < b, a),
    "broadcast_lesser_equal": lambda a, b: _like(a <= b, a),
    "broadcast_logical_and": lambda a, b: _like((a != 0) & (b != 0), a),
    "broadcast_logical_or": lambda a, b: _like((a != 0) | (b != 0), a),
    "broadcast_logical_xor": lambda a, b: _like((a != 0) ^ (b != 0), a),
}

for _name, _fn in _BCAST.items():
    register(_name)(_named(_fn, 2))

register("broadcast_plus")(lambda a, b: a + b)
register("broadcast_minus")(lambda a, b: a - b)


@register("broadcast_to")
def _broadcast_to(x, shape=None):
    # reference semantics: 0 in the target shape keeps that dim
    tgt = tuple(s if t == 0 else t for s, t in zip(x.shape, shape)) \
        if len(shape) == x.dim() else tuple(shape)
    return torch.broadcast_to(x, tgt)


@register("broadcast_like")
def _broadcast_like(x, y, lhs_axes=None, rhs_axes=None):
    return torch.broadcast_to(x, y.shape)


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(x, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return torch.broadcast_to(x, tuple(tgt))
