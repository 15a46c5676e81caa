"""Elementwise unary/binary operators and their *_scalar forms (ref: the
JAX package's ``ops/elemwise.py``; src/operator/tensor/elemwise_*.cc and
mshadow_op.h in the reference).

Each op is a one-line torch expression. The formulas follow the JAX
package where torch's own function would differ: ``sigmoid`` is
``1/(1+exp(-x))``, ``relu`` is ``maximum(x, 0)`` (a tie splits the gradient
in halves, as ``jnp.maximum`` does; ``torch.relu`` gives 0 there),
``gamma`` is ``exp(lgamma(x))``, ``mod`` is the floor-mod of
``jnp.mod`` (``torch.remainder``, not ``torch.fmod``) and ``round``
rounds half to even. A scalar operand is a 0-d tensor, which type
promotion treats like a python scalar (a float32 array stays float32).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..base import torch_dtype
from .registry import alias, register


def _s(x, s):
    """The scalar ``s`` as a 0-d tensor on x's device."""
    return torch.as_tensor(s, device=x.device)


def _like(cond, x):
    return cond.to(x.dtype)


# ---------------------------------------------------------------------------
# unary math
# ---------------------------------------------------------------------------

_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "negative": lambda x: -x,
    "reciprocal": lambda x: 1.0 / x,
    "square": lambda x: x * x,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": lambda x: torch.sign(x) * x.abs().pow(1.0 / 3.0),
    "rcbrt": lambda x: 1.0 / (torch.sign(x) * x.abs().pow(1.0 / 3.0)),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "trunc": torch.trunc,
    "round": torch.round,
    "rint": torch.round,
    "fix": torch.trunc,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "relu": lambda x: torch.maximum(x, x.new_zeros(())),
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "logical_not": lambda x: _like(x == 0, x),
    # int64, the reference's type (the JAX package uses int32: x64 is off)
    "size_array": lambda x: torch.tensor([x.numel()], dtype=torch.int64,
                                         device=x.device),
    "shape_array": lambda x: torch.tensor(list(x.shape), dtype=torch.int64,
                                          device=x.device),
}

for _name, _fn in _UNARY.items():
    register(_name)(_fn)


@register("copy", aliases=("identity", "_copy"))
def _copy(x):
    return x.clone()


@register("BlockGrad", aliases=("stop_gradient",))
def _block_grad(x):
    return x.detach()


@register("make_loss")
def _make_loss(x, grad_scale: float = 1.0, **_):
    return x  # the gradient is the head gradient; MakeLoss marks a loss


@register("cast", aliases=("Cast",))
def _cast(x, dtype="float32"):
    return x.to(torch_dtype(dtype))


@register("amp_cast")
def _amp_cast(x, dtype="float32"):
    return _cast(x, dtype)


@register("amp_multicast", num_outputs=lambda n, p: n, variadic=True)
def _amp_multicast(*xs, num_outputs=None):
    widest = functools.reduce(torch.promote_types, [x.dtype for x in xs])
    return tuple(x.to(widest) for x in xs)


@register("zeros_like")
def _zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(x):
    return torch.ones_like(x)


@register("gamma_sample_grad_dummy")
def _noop(x):
    return x


# ---------------------------------------------------------------------------
# binary elementwise (same shape)
# ---------------------------------------------------------------------------

_BINARY = {
    "elemwise_add": lambda a, b: a + b,
    "elemwise_sub": lambda a, b: a - b,
    "elemwise_mul": lambda a, b: a * b,
    "elemwise_div": lambda a, b: a / b,
    "_maximum": torch.maximum,
    "_minimum": torch.minimum,
    "_hypot": torch.hypot,
    "_power": torch.pow,
    "_mod": torch.remainder,
    "_equal": lambda a, b: _like(a == b, a),
    "_not_equal": lambda a, b: _like(a != b, a),
    "_greater": lambda a, b: _like(a > b, a),
    "_greater_equal": lambda a, b: _like(a >= b, a),
    "_lesser": lambda a, b: _like(a < b, a),
    "_lesser_equal": lambda a, b: _like(a <= b, a),
    "_logical_and": lambda a, b: _like((a != 0) & (b != 0), a),
    "_logical_or": lambda a, b: _like((a != 0) | (b != 0), a),
    "_logical_xor": lambda a, b: _like((a != 0) ^ (b != 0), a),
}

for _name, _fn in _BINARY.items():
    register(_name)(_fn)

alias("_add", "elemwise_add")
alias("_plus", "elemwise_add")
alias("_sub", "elemwise_sub")
alias("_minus", "elemwise_sub")
alias("_mul", "elemwise_mul")
alias("_div", "elemwise_div")


@register("_scatter_elemwise_div")
def _scatter_elemwise_div(a, b):
    return a / b


@register("smooth_l1")
def _smooth_l1(x, scalar: float = 1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * x * x,
                       torch.abs(x) - 0.5 / s2)


# ---------------------------------------------------------------------------
# scalar forms (ref: elemwise_binary_scalar_op_*.cc)
# ---------------------------------------------------------------------------

def _rmod(x, s):
    """``s % x`` in the dtype ``jnp.mod(s, x)`` gives: x's own for a float
    x; float32 for a float scalar and an integer or bool x; int32 for an
    int scalar and a bool x; else x's. The scalar goes in as a full tensor,
    since ``remainder(scalar, x)`` has no gradient; integers are taken in
    int64 (torch has no remainder for uint16 / uint32) and cast back."""
    if x.is_floating_point():
        return torch.remainder(torch.full_like(x, s), x)
    if not isinstance(s, (bool, int, np.integer)):
        xf = x.to(torch.float32)
        return torch.remainder(torch.full_like(xf, s), xf)
    dt = torch.int32 if x.dtype == torch.bool else x.dtype
    xi = x.to(torch.int64)
    return torch.remainder(torch.full_like(xi, int(s)), xi).to(dt)


def _scalar_op(fwd, rev=None):
    def impl(x, scalar: float = 1.0, reverse: bool = False):
        if reverse and rev is not None:
            return rev(x, scalar)
        return fwd(x, scalar)
    return impl


_SCALAR = {
    "_plus_scalar": _scalar_op(lambda x, s: x + s),
    "_minus_scalar": _scalar_op(lambda x, s: x - s),
    "_rminus_scalar": _scalar_op(lambda x, s: s - x, lambda x, s: s - x),
    "_mul_scalar": _scalar_op(lambda x, s: x * s),
    "_div_scalar": _scalar_op(lambda x, s: x / s),
    "_rdiv_scalar": _scalar_op(lambda x, s: s / x, lambda x, s: s / x),
    "_mod_scalar": _scalar_op(lambda x, s: torch.remainder(x, s)),
    "_rmod_scalar": _scalar_op(lambda x, s: _rmod(x, s),
                               lambda x, s: _rmod(x, s)),
    "_power_scalar": _scalar_op(lambda x, s: torch.pow(x, s)),
    "_rpower_scalar": _scalar_op(lambda x, s: torch.pow(s, x),
                                 lambda x, s: torch.pow(s, x)),
    "_maximum_scalar": _scalar_op(lambda x, s: torch.maximum(x, _s(x, s))),
    "_minimum_scalar": _scalar_op(lambda x, s: torch.minimum(x, _s(x, s))),
    "_hypot_scalar": _scalar_op(lambda x, s: torch.hypot(x, _s(x, s))),
    "_equal_scalar": _scalar_op(lambda x, s: _like(x == s, x)),
    "_not_equal_scalar": _scalar_op(lambda x, s: _like(x != s, x)),
    "_greater_scalar": _scalar_op(lambda x, s: _like(x > s, x),
                                  lambda x, s: _like(s > x, x)),
    "_greater_equal_scalar": _scalar_op(lambda x, s: _like(x >= s, x),
                                        lambda x, s: _like(s >= x, x)),
    "_lesser_scalar": _scalar_op(lambda x, s: _like(x < s, x),
                                 lambda x, s: _like(s < x, x)),
    "_lesser_equal_scalar": _scalar_op(lambda x, s: _like(x <= s, x),
                                       lambda x, s: _like(s <= x, x)),
    "_logical_and_scalar": _scalar_op(
        lambda x, s: _like((x != 0) & bool(s), x)),
    "_logical_or_scalar": _scalar_op(
        lambda x, s: _like((x != 0) | bool(s), x)),
    "_logical_xor_scalar": _scalar_op(
        lambda x, s: _like((x != 0) ^ bool(s), x)),
}

for _name, _fn in _SCALAR.items():
    register(_name)(_fn)


@register("_scatter_plus_scalar")
def _scatter_plus_scalar(x, scalar: float = 1.0, reverse: bool = False):
    return x + scalar


@register("_scatter_minus_scalar")
def _scatter_minus_scalar(x, scalar: float = 1.0, reverse: bool = False):
    return x - scalar


@register("hard_sigmoid")
def _hard_sigmoid(data, alpha=0.2, beta=0.5):
    """max(0, min(1, alpha*x + beta)) (ref: mshadow_op.h hard_sigmoid)."""
    return torch.clamp(float(alpha) * data + float(beta), 0.0, 1.0)
