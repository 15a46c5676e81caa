"""Neural-network operators on the slice's path (ref: the JAX package's
``ops/nn.py``; MXNet src/operator/nn/).

Plain functions on tensors. Channel-last ("NHWC") data keeps MXNet's layout
at every public function; inside, the convolution and pooling run on the
``channels_last`` NCHW view of the same memory, so no copy is made.
BatchNorm returns ``(out, mean, var)``; the running-stat update is the
calling layer's (gluon/nn/basic_layers.py).

Flags (``base.env``): ``MXTPU_FUSED_EPILOGUE=0`` sends the fused epilogue
op down the composed BatchNorm -> (add) -> ReLU chain, as in the JAX
package. ``MXNET_RESID_DTYPE`` (8-bit saved residuals) is not ported: every
op that reads it in the JAX package (convolution, training BatchNorm, the
composed epilogue, ReLU) raises on float data while it is set, rather than
compute something else.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, check, env
from .fused_bn_act import fused_bn_act

__all__ = ["fully_connected", "convolution", "pooling", "batch_norm",
           "fused_bn_act_impl", "relu", "log_softmax"]

_LAYOUTS = ("NCHW", "NHWC")


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _layout(layout):
    layout = layout or "NCHW"
    if layout not in _LAYOUTS:
        raise MXNetError(f"unsupported 2-d layout {layout!r}")
    return layout


def _to_nchw(x, layout):
    return x.permute(0, 3, 1, 2) if layout == "NHWC" else x


def _from_nchw(x, layout):
    return x.permute(0, 2, 3, 1) if layout == "NHWC" else x


def _no_resid8(data, op):
    """Raise while MXNET_RESID_DTYPE asks for the JAX package's 8-bit
    residual lowering of ``op`` (ref: ops/resid8.py), which is not ported."""
    rdt = env.get("MXNET_RESID_DTYPE")
    if rdt and data.is_floating_point():
        raise MXNetError(f"{op}: MXNET_RESID_DTYPE={rdt!r} (8-bit saved "
                         "residuals) is not ported yet; unset it")


def fully_connected(data, weight, bias=None, flatten=True):
    """(ref: FullyConnected) ``data @ weight.T [+ bias]``."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    out = torch.matmul(x, weight.t())
    return out if bias is None else out + bias


def convolution(data, weight, bias=None, stride=1, pad=0, dilate=1,
                num_group=1, layout=None):
    """2-d convolution (ref: Convolution). NHWC data takes MXNet's OHWI
    weight; both are handed to the convolution as OIHW / NCHW views in
    ``channels_last`` memory. Returns data in ``layout``."""
    layout = _layout(layout)
    check(data.dim() == 4 and weight.dim() == 4,
          "convolution: 4-d data and weight expected")
    _no_resid8(data, "convolution")
    w = weight.permute(0, 3, 1, 2) if layout == "NHWC" else weight
    out = F.conv2d(_to_nchw(data, layout), w, None, _pair(stride),
                   _pair(pad), _pair(dilate), num_group)
    out = _from_nchw(out, layout)
    if bias is not None:
        shape = (1, 1, 1, -1) if layout == "NHWC" else (1, -1, 1, 1)
        out = out + bias.reshape(shape)
    return out


def pooling(data, kernel=(1, 1), pool_type="max", global_pool=False,
            stride=None, pad=0, layout=None):
    """(ref: Pooling, "valid" convention) the two the path uses: windowed
    max and global average. The stride defaults to 1, as the reference's
    does."""
    layout = _layout(layout)
    if global_pool and pool_type == "avg":
        axes = (1, 2) if layout == "NHWC" else (2, 3)
        n = data.shape[axes[0]] * data.shape[axes[1]]
        # f32 accumulation, result in the input dtype (as jnp.sum)
        s = data.float().sum(dim=axes, keepdim=True).to(data.dtype)
        return s / n
    if global_pool or pool_type != "max":
        raise MXNetError(f"pooling {pool_type!r} (global={global_pool}) is "
                         "not ported yet")
    stride = _pair(stride if stride else 1)
    out = F.max_pool2d(_to_nchw(data, layout), _pair(kernel), stride,
                       _pair(pad))
    return _from_nchw(out, layout)


def relu(data):
    """(ref: Activation relu, ``jnp.maximum(data, 0)``) as ``maximum``, whose
    gradient splits an exact tie at 0 in halves as JAX's does."""
    _no_resid8(data, "relu")
    return torch.maximum(data, data.new_zeros(()))


def log_softmax(data, axis=-1):
    """(ref: log_softmax) computed in f32, returned in data's dtype."""
    return F.log_softmax(data.float(), dim=axis).to(data.dtype)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

def _bn_shapes(data, axis):
    ax = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    n = 1
    for i in red:
        n *= data.shape[i]
    return ax, red, bshape, n


class _BatchNormCore(torch.autograd.Function):
    """Training-mode BatchNorm with the hand-fused backward of the JAX
    package's ``_make_bn_core``: single-pass shifted f32 statistics, f32
    arithmetic in registers, output and dx in data's dtype, and the
    ``sum_dy`` / ``sum_dy_xhat`` closed form."""

    @staticmethod
    def forward(ctx, data, g32, beta32, axis, eps):
        ax, red, bshape, n = _bn_shapes(data, axis)
        # assumed-mean shift (one real sample per channel) keeps
        # E[d^2] - E[d]^2 free of cancellation when mean >> std
        shift = data
        for i in red:
            shift = shift.narrow(i, 0, 1)
        shift = shift.float()
        d = data.float() - shift
        m1 = d.sum(dim=red) / n
        m2 = (d * d).sum(dim=red) / n
        mean = shift.reshape(-1) + m1
        var = torch.clamp_min(m2 - m1 * m1, 0.0)
        inv = torch.rsqrt(var + eps)
        out = (data.float() - mean.reshape(bshape)) \
            * (inv * g32).reshape(bshape) + beta32.reshape(bshape)
        ctx.save_for_backward(data, mean, inv, g32)
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return out.to(data.dtype), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        data, mean, inv, g32 = ctx.saved_tensors
        _, red, bshape, n = _bn_shapes(data, ctx.axis)
        xhat = (data.float() - mean.reshape(bshape)) * inv.reshape(bshape)
        dy32 = dout.float()
        sum_dy = dy32.sum(dim=red)
        sum_dy_xhat = (dy32 * xhat).sum(dim=red)
        dx = (g32 * inv).reshape(bshape) * (
            dy32 - (sum_dy / n).reshape(bshape)
            - xhat * (sum_dy_xhat / n).reshape(bshape))
        return dx.to(data.dtype), sum_dy_xhat, sum_dy, None, None


def _gamma32(gamma, fix_gamma):
    return torch.ones_like(gamma, dtype=torch.float32) if fix_gamma \
        else gamma.float()


def _inference_norm(data, g32, beta32, moving_mean, moving_var, eps, axis):
    _, _, bshape, _ = _bn_shapes(data, axis)
    mean = moving_mean.float()
    var = moving_var.float()
    inv = torch.rsqrt(var + eps)
    out = (data.float() - mean.reshape(bshape)) \
        * (inv * g32).reshape(bshape) + beta32.reshape(bshape)
    return out, mean, var


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               fix_gamma=True, use_global_stats=False, axis=1,
               training=False):
    """(ref: BatchNorm) ``(out, mean, var)``. Statistics in f32 whatever
    data's dtype; training mode normalises by the batch statistics,
    inference mode by the moving ones."""
    g32 = _gamma32(gamma, fix_gamma)
    b32 = beta.float()
    if training and not use_global_stats:
        _no_resid8(data, "batch_norm")
        return _BatchNormCore.apply(data, g32, b32, axis, float(eps))
    out, mean, var = _inference_norm(data, g32, b32, moving_mean,
                                     moving_var, eps, axis)
    return out.to(data.dtype), mean, var


def fused_bn_act_impl(data, residual, gamma, beta, moving_mean, moving_var,
                      eps=1e-5, fix_gamma=False, use_global_stats=False,
                      axis=-1, training=False):
    """``relu(BatchNorm(data) [+ residual])`` as one op (ref:
    ``_fused_bn_act_impl`` behind _contrib_fused_bn_relu /
    _contrib_fused_bn_add_relu). Training with channel-last float data
    goes through the fused kernels while ``MXTPU_FUSED_EPILOGUE`` is on;
    another axis, or the flag off, takes the composed BatchNorm -> (add)
    -> ReLU chain (ref: ops/nn.py:390-417); inference uses the moving
    stats."""
    g32 = _gamma32(gamma, fix_gamma)
    b32 = beta.float()
    if training and not use_global_stats:
        if axis % data.dim() == data.dim() - 1 and data.is_floating_point() \
                and env.get("MXTPU_FUSED_EPILOGUE"):
            return fused_bn_act(data, residual, g32, b32, float(eps))
        _no_resid8(data, "fused_bn_act (composed)")
        out, mean, var = _BatchNormCore.apply(data, g32, b32, axis,
                                              float(eps))
        if residual is not None:
            out = out + residual
        return relu(out), mean, var
    out, mean, var = _inference_norm(data, g32, b32, moving_mean,
                                     moving_var, eps, axis)
    if residual is not None:
        out = out + residual.float()
    return torch.relu(out).to(data.dtype), mean, var
