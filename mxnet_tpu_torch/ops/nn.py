"""Neural-network operators (ref: the JAX package's ``ops/nn.py``; MXNet
src/operator/nn/ and the legacy top-level ops).

Every op of the JAX module is registered here under the same name,
aliases, ``num_outputs``, ``aux_inputs`` and ``rng``, as a plain function
on tensors with MXNet's parameters; the Gluon layers call the same
functions. Channel-last data ("NWC", "NHWC", "NDHWC") keeps MXNet's layout
at every function; inside, convolution and pooling run on the
channel-first view of the same memory, so no copy is made. Channel-last
convolution weights are MXNet's ``(O, *k, I/g)``; Deconvolution's weight is
``(C_in, num_filter, *k)`` in every layout.

Mode: ops that act differently in training (BatchNorm, the fused
epilogues, Dropout) take ``_training``, which ``mx.nd`` fills from
``autograd.is_training()``, as the JAX package does. BatchNorm returns
``(out, mean, var)`` and leaves ``moving_mean`` / ``moving_var`` as they
are, as the JAX op does (its docstring, ``ops/nn.py:18-20``): the
momentum blend into the running statistics is the Gluon layer's, in place.

The loss heads (``SoftmaxOutput``, the regression outputs, ``SVMOutput``,
``MakeLoss``, ``IdentityAttachKLSparseReg``) are
``torch.autograd.Function``s whose backward is the JAX package's defined
gradient, not the gradient of their forward. ``Dropout`` draws its mask
from the ``generator`` it is given, else the device's default generator.

Flags (``base.env``): ``MXTPU_FUSED_EPILOGUE=0`` sends the fused epilogue
op down the composed BatchNorm -> (add) -> ReLU chain, as in the JAX
package. ``MXNET_RESID_DTYPE`` (8-bit saved residuals) is not ported: every
op that reads it in the JAX package (convolution, training BatchNorm, the
composed epilogue, ReLU) raises on float data while it is set, rather than
compute something else.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, check, env, torch_dtype
from ..random import default_generator
from ..util import replayed
from .fused_bn_act import fused_bn_act
from .registry import register

__all__ = ["fully_connected", "convolution", "deconvolution", "pooling",
           "batch_norm", "fused_bn_act_impl", "fused_bn_relu",
           "fused_bn_add_relu", "layer_norm", "instance_norm",
           "l2_normalization", "lrn", "activation", "leaky_relu", "relu",
           "softmax", "log_softmax", "softmin", "softmax_activation",
           "softmax_cross_entropy", "softmax_output",
           "linear_regression_output", "svm_output", "make_loss",
           "identity_attach_kl_sparse_reg", "mae_regression_output",
           "logistic_regression_output", "dropout", "embedding",
           "sequence_mask", "sequence_last", "sequence_reverse",
           "upsampling", "grid_generator"]


def _tuplify(v, n):
    if v is None or v == ():
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _no_resid8(data, op):
    """Raise while MXNET_RESID_DTYPE asks for the JAX package's 8-bit
    residual lowering of ``op`` (ref: ops/resid8.py), which is not ported."""
    rdt = env.get("MXNET_RESID_DTYPE")
    if rdt and data.is_floating_point():
        raise MXNetError(f"{op}: MXNET_RESID_DTYPE={rdt!r} (8-bit saved "
                         "residuals) is not ported yet; unset it")


def _bias(maybe_bias, no_bias):
    return maybe_bias[0] if maybe_bias and not no_bias else None


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------

@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, *maybe_bias, num_hidden=1, no_bias=False,
                    flatten=True):
    """``data @ weight.T [+ bias]``; ``flatten`` folds every axis after the
    first, otherwise the product is over the last axis."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    out = torch.matmul(x, weight.t())
    bias = _bias(maybe_bias, no_bias)
    return out if bias is None else out + bias


# ---------------------------------------------------------------------------
# Convolution / Deconvolution
# ---------------------------------------------------------------------------

_LAYOUTS = ("NCW", "NWC", "NCHW", "NHWC", "NCDHW", "NDHWC")
_DEFAULT_LAYOUT = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_layout(layout, nd):
    layout = layout or _DEFAULT_LAYOUT.get(nd)
    if layout not in _LAYOUTS or len(layout) != nd + 2:
        raise MXNetError(f"unsupported {nd}-d layout {layout!r}")
    return layout


def _to_cf(x, layout):
    """The channel-first view of channel-last ``x`` (no copy)."""
    if layout[-1] != "C":
        return x
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _from_cf(x, layout):
    if layout[-1] != "C":
        return x
    return x.permute(0, *range(2, x.dim()), 1)


def _add_channel_bias(out, bias, layout):
    shape = [1] * out.dim()
    shape[layout.index("C")] = -1
    return out + bias.reshape(shape)


def _spatial_dims(weight, kernel):
    return len(kernel) if kernel else weight.dim() - 2


@register("Convolution", aliases=("conv2d",))
def convolution(data, weight, *maybe_bias, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=1, num_group=1, workspace=1024,
                no_bias=False, cudnn_tune=None, cudnn_off=False,
                layout=None):
    """1-, 2- or 3-d convolution in any of MXNet's layouts. The weight is
    ``(O, I/g, *k)`` channel-first and ``(O, *k, I/g)`` channel-last; both
    are handed to PyTorch as channel-first views of the same memory."""
    nd = _spatial_dims(weight, kernel)
    check(data.dim() == nd + 2 and weight.dim() == nd + 2,
          f"convolution: {nd + 2}-d data and weight expected")
    layout = _conv_layout(layout, nd)
    _no_resid8(data, "convolution")
    x, stride, pad = _to_cf(data, layout), _tuplify(stride, nd), \
        _tuplify(pad if pad else 0, nd)
    if x.device.type == "cpu" and layout[-1] == "C" and \
            weight.shape[1:-1] == (1,) * nd and not any(pad) and \
            any(s > 1 for s in stride):
        # PyTorch's CPU (oneDNN) channels-last 1x1 strided convolution
        # returns a wrong weight gradient, or crashes, at 8 threads for
        # narrow inputs (e.g. (4, 8, 12, 12) -> 16 filters, stride 2).
        # Without padding it is the stride-1 convolution of the input
        # subsampled by the stride, which is right at every thread count.
        x = x[(slice(None),) * 2 + tuple(slice(None, None, s)
                                         for s in stride)]
        stride = (1,) * nd
    out = _CONV[nd](x, _to_cf(weight, layout), None, stride, pad,
                    _tuplify(dilate, nd), num_group)
    out = _from_cf(out, layout)
    bias = _bias(maybe_bias, no_bias)
    return out if bias is None else _add_channel_bias(out, bias, layout)


@register("Deconvolution")
def deconvolution(data, weight, *maybe_bias, kernel=(), stride=(),
                  dilate=(), pad=(), adj=(), target_shape=(), num_filter=1,
                  num_group=1, workspace=1024, no_bias=True, cudnn_tune=None,
                  cudnn_off=False, layout=None):
    """Transposed convolution (the gradient of Convolution with respect to
    its input): output extent ``(in - 1) * stride - 2 pad + dilate (k - 1)
    + 1 + adj``. ``target_shape``, which the JAX op accepts without using,
    must equal that extent when given."""
    nd = _spatial_dims(weight, kernel)
    check(data.dim() == nd + 2 and weight.dim() == nd + 2,
          f"deconvolution: {nd + 2}-d data and weight expected")
    layout = _conv_layout(layout, nd)
    if num_group != 1:
        raise MXNetError("grouped Deconvolution not yet supported")
    out = _CONV_T[nd](_to_cf(data, layout), weight, None,
                      _tuplify(stride, nd), _tuplify(pad if pad else 0, nd),
                      _tuplify(adj if adj else 0, nd), 1,
                      _tuplify(dilate if dilate else 1, nd))
    if target_shape and any(target_shape):
        got = tuple(out.shape[2:])
        check(got == tuple(target_shape),
              f"Deconvolution: target_shape {tuple(target_shape)} is not "
              f"the output extent {got}; set adj / pad instead")
    out = _from_cf(out, layout)
    bias = _bias(maybe_bias, no_bias)
    return out if bias is None else _add_channel_bias(out, bias, layout)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pad_windows(x, pad, extra, value):
    """``x`` (channel-first) padded by ``pad`` below and ``pad + extra``
    above on each spatial axis."""
    widths = []
    for p, e in reversed(list(zip(pad, extra))):
        widths += [p, p + e]
    return F.pad(x, widths, value=value) if any(widths) else x


def _global_pool(x, pool_type, p_value):
    axes = tuple(range(2, x.dim()))
    if pool_type == "max":
        return x.amax(dim=axes, keepdim=True)
    if pool_type in ("avg", "sum"):
        # f32 accumulation, result in the input dtype (as jnp.sum)
        s = x.float().sum(dim=axes, keepdim=True).to(x.dtype)
        return s / math.prod(x.shape[2:]) if pool_type == "avg" else s
    if pool_type == "lp":
        return x.abs().pow(p_value).sum(dim=axes, keepdim=True) \
            .pow(1.0 / p_value)
    raise MXNetError(f"unknown pool_type {pool_type}")


@register("Pooling", aliases=("pooling",))
def pooling(data, kernel=(), pool_type="max", global_pool=False,
            cudnn_off=False, pooling_convention="valid", stride=(), pad=(),
            p_value=2, count_include_pad=True, layout=None):
    """max / avg / sum / lp pooling over 1, 2 or 3 spatial axes. The
    stride defaults to 1. ``pooling_convention="full"`` rounds the output
    extent up, ``ceil((in + 2 pad - k) / stride) + 1``, padding the high
    side so the last window fits; avg divides by the window size, or with
    ``count_include_pad=False`` by the count of real elements."""
    nd = data.dim() - 2
    layout = _conv_layout(layout, nd)
    x = _to_cf(data, layout)
    if global_pool:
        return _from_cf(_global_pool(x, pool_type, p_value), layout)
    kernel = tuple(kernel)
    check(len(kernel) == nd, f"Pooling: kernel {kernel} for {nd}-d data")
    stride = _tuplify(stride if stride else 1, nd)
    pad = _tuplify(pad if pad else 0, nd)
    extra = [0] * nd
    if pooling_convention == "full":
        for i in range(nd):
            in_i = x.shape[2 + i]
            out_i = -(-(in_i + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            extra[i] = max(0, (out_i - 1) * stride[i] + kernel[i] - in_i
                           - 2 * pad[i])
    if nd == 1:      # as 2-d pooling over a unit axis
        x = x.unsqueeze(2)
        kernel, stride, pad, extra = ((1,) + kernel, (1,) + stride,
                                      (0,) + pad, [0] + extra)
    d = len(kernel)
    if pool_type == "max":
        if not any(extra) and all(p <= k // 2 for p, k in zip(pad, kernel)):
            out = _MAX_POOL[d](x, kernel, stride, pad)
        else:
            low = float("-inf") if x.is_floating_point() \
                else torch.iinfo(x.dtype).min
            out = _MAX_POOL[d](_pad_windows(x, pad, extra, low), kernel,
                               stride)
    elif pool_type in ("avg", "sum", "lp"):
        src = x.abs().pow(p_value) if pool_type == "lp" else x
        out = _AVG_POOL[d](_pad_windows(src, pad, extra, 0.0), kernel,
                           stride, divisor_override=1)
        if pool_type == "lp":
            out = out.pow(1.0 / p_value)
        elif pool_type == "avg":
            if count_include_pad:
                out = out / float(math.prod(kernel))
            else:
                ones = x.new_ones((1, 1) + tuple(x.shape[2:]))
                out = out / _AVG_POOL[d](_pad_windows(ones, pad, extra, 0.0),
                                         kernel, stride, divisor_override=1)
    else:
        raise MXNetError(f"unknown pool_type {pool_type}")
    if nd == 1:
        out = out.squeeze(2)
    return _from_cf(out, layout)


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


@register("BatchNorm", aliases=("batch_norm",), num_outputs=3,
          aux_inputs=(3, 4))
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               _training=False):
    """``(out, mean, var)``. Statistics in f32 whatever data's dtype;
    training mode normalises by the batch statistics, inference mode by
    the moving ones. The moving statistics are not written (see the
    module docstring)."""
    g32 = _gamma32(gamma, fix_gamma)
    b32 = beta.float()
    if _training and not use_global_stats:
        _no_resid8(data, "batch_norm")
        return _BatchNormCore.apply(data, g32, b32, axis, float(eps))
    out, mean, var = _inference_norm(data, g32, b32, moving_mean,
                                     moving_var, eps, axis)
    return out.to(data.dtype), mean, var


def fused_bn_act_impl(data, residual, gamma, beta, moving_mean, moving_var,
                      eps=1e-5, fix_gamma=False, use_global_stats=False,
                      axis=-1, _training=False):
    """``relu(BatchNorm(data) [+ residual])`` as one op (ref:
    ``_fused_bn_act_impl``). Training with channel-last float data goes
    through the fused kernels while ``MXTPU_FUSED_EPILOGUE`` is on;
    another axis, or the flag off, takes the composed BatchNorm -> (add)
    -> ReLU chain (ref: ops/nn.py:390-417); inference uses the moving
    stats."""
    g32 = _gamma32(gamma, fix_gamma)
    b32 = beta.float()
    if _training and not use_global_stats:
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


@register("_contrib_fused_bn_relu", num_outputs=3, aux_inputs=(3, 4))
def fused_bn_relu(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
                  momentum=0.9, fix_gamma=False, use_global_stats=False,
                  axis=-1, _training=False):
    """Fused ``BatchNorm -> ReLU``: ``(out, mean, var)`` like BatchNorm."""
    return fused_bn_act_impl(data, None, gamma, beta, moving_mean,
                             moving_var, eps, fix_gamma, use_global_stats,
                             axis, _training)


@register("_contrib_fused_bn_add_relu", num_outputs=3, aux_inputs=(4, 5))
def fused_bn_add_relu(data, residual, gamma, beta, moving_mean, moving_var,
                      eps=1e-5, momentum=0.9, fix_gamma=False,
                      use_global_stats=False, axis=-1, _training=False):
    """Fused ``BatchNorm -> add(residual) -> ReLU``, the ResNet block
    tail."""
    return fused_bn_act_impl(data, residual, gamma, beta, moving_mean,
                             moving_var, eps, fix_gamma, use_global_stats,
                             axis, _training)


# ---------------------------------------------------------------------------
# other normalisations
# ---------------------------------------------------------------------------

def _channel_shape(data, ax):
    return tuple(data.shape[ax] if i == ax else 1 for i in range(data.dim()))


@register("LayerNorm", aliases=("layer_norm",), num_outputs=3)
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """``(out, mean, var)`` over ``axis`` (the population variance)."""
    ax = axis % data.dim()
    mean = data.mean(dim=ax, keepdim=True)
    var = data.var(dim=ax, keepdim=True, correction=0)
    shape = _channel_shape(data, ax)
    out = (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)
    return out, mean.squeeze(ax), var.squeeze(ax)


@register("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    """Normalise each (sample, channel) over the spatial axes."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data^2) + eps)`` per instance, channel or
    spatial position set."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, data.dim()))
    else:
        raise MXNetError(f"unknown L2Normalization mode {mode}")
    return data / torch.sqrt(data.square().sum(dim=red, keepdim=True) + eps)


@register("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Cross-channel local response norm over 4-d NCHW data; ``alpha`` is
    divided by ``nsize``."""
    sq = data.square()
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    c = data.shape[1]
    acc = sum(padded[:, i:i + c] for i in range(nsize))
    return data / torch.pow(knorm + alpha * acc / nsize, beta)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def relu(data):
    """(ref: Activation relu, ``jnp.maximum(data, 0)``) as ``maximum``, whose
    gradient splits an exact tie at 0 in halves as JAX's does."""
    _no_resid8(data, "relu")
    return torch.maximum(data, data.new_zeros(()))


@register("Activation", aliases=("activation",))
def activation(data, act_type="relu"):
    """relu, sigmoid, tanh, softrelu (``log(1 + e^x)``) or softsign."""
    if act_type == "relu":
        return relu(data)
    if act_type == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-data))
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.logaddexp(data, data.new_zeros(()))
    if act_type == "softsign":
        return data / (1.0 + data.abs())
    raise MXNetError(f"unknown act_type {act_type}")


_SELU_ALPHA, _SELU_LAMBDA = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU")
def leaky_relu(data, *maybe_gamma, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """leaky, elu, selu, gelu (erf form), prelu (with its ``gamma`` input,
    per channel) or rrelu (the mean slope, as at inference)."""
    pos = data >= 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * (torch.exp(data) - 1.0))
    if act_type == "selu":
        return _SELU_LAMBDA * torch.where(
            pos, data, _SELU_ALPHA * (torch.exp(data) - 1.0))
    if act_type == "gelu":
        return 0.5 * data * (1.0 + torch.erf(data / math.sqrt(2.0)))
    if act_type == "prelu":
        check(len(maybe_gamma) == 1, "LeakyReLU prelu needs its gamma input")
        gamma = maybe_gamma[0]
        shape = (1, -1) + (1,) * (data.dim() - 2) if data.dim() > 1 \
            else (-1,)
        g = gamma.reshape(shape) if gamma.dim() == 1 else gamma
        return torch.where(pos, data, g * data)
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(pos, data, mid * data)
    raise MXNetError(f"unknown act_type {act_type}")


# ---------------------------------------------------------------------------
# softmax family
# ---------------------------------------------------------------------------

def _length_mask(data, length, axis):
    """Positions < length along ``axis`` (the length tensor has data's
    shape without the softmax axis)."""
    ax = axis % data.dim()
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    positions = torch.arange(data.shape[ax], device=data.device) \
        .reshape(shape)
    return positions < length.unsqueeze(ax).to(torch.int32)


def _softmax_family(fn, name, data, maybe_length, axis, temperature, dtype,
                    use_length):
    """``fn`` (softmax or log_softmax) in f32 over ``data / temperature``,
    returned in ``dtype`` (default: data's). With ``use_length`` the
    positions past each length are masked out and output 0."""
    x = data if temperature in (None, 1.0) else data / temperature
    x = x.float()
    if use_length:
        if not maybe_length:
            raise MXNetError(f"{name}: use_length=True requires the length "
                             "input")
        mask = _length_mask(data, maybe_length[0], axis)
        # exp(finfo.min - max) is exactly 0 in f32: valid positions
        # normalise over the valid slice alone
        out = fn(torch.where(mask, x, torch.finfo(torch.float32).min),
                 dim=axis)
        out = torch.where(mask, out, 0.0)
    else:
        out = fn(x, dim=axis)
    return out.to(data.dtype if dtype is None else torch_dtype(dtype))


@register("softmax")
def softmax(data, *maybe_length, axis=-1, temperature=None, dtype=None,
            use_length=False):
    return _softmax_family(torch.softmax, "softmax", data, maybe_length,
                           axis, temperature, dtype, use_length)


@register("log_softmax")
def log_softmax(data, *maybe_length, axis=-1, temperature=None, dtype=None,
                use_length=False):
    return _softmax_family(torch.log_softmax, "log_softmax", data,
                           maybe_length, axis, temperature, dtype,
                           use_length)


@register("softmin")
def softmin(data, *maybe_length, axis=-1, temperature=None, dtype=None,
            use_length=False):
    return softmax(-data, *maybe_length, axis=axis, temperature=temperature,
                   dtype=dtype, use_length=use_length)


@register("SoftmaxActivation")
def softmax_activation(data, mode="instance"):
    """Softmax over the channel axis (``mode="channel"``) or over all of
    each instance."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Summed negative log-likelihood of integer ``label`` under
    ``softmax(data)``."""
    logp = torch.log_softmax(data, dim=-1)
    idx = label.to(torch.int64).unsqueeze(-1)
    return -torch.gather(logp, -1, idx).sum()


# ---------------------------------------------------------------------------
# loss heads: forward and a defined backward
# ---------------------------------------------------------------------------

def _onehot(lbl, nclass, axis, dtype):
    """One-hot of integer ``lbl`` with the class axis at ``axis`` of the
    result; labels outside [0, nclass) give all zeros, as jax.nn.one_hot."""
    ndim = lbl.dim() + 1
    ax = axis % ndim
    shape = [1] * ndim
    shape[ax] = nclass
    classes = torch.arange(nclass, device=lbl.device).reshape(shape)
    return (lbl.unsqueeze(ax) == classes).to(dtype)


_NORM_IDS = {"null": 0, "batch": 1, "valid": 2}


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; backward ``(p - onehot(label))``, optionally
    label-smoothed, masked at ``ignore_label``, normalised by the batch or
    the valid count and scaled by ``grad_scale`` (ref:
    softmax_output-inl.h). The incoming gradient is not used."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                norm_id, smooth):
        out = torch.softmax(data, dim=-1 if data.dim() == 2 else 1)
        ctx.save_for_backward(out, label)
        ctx.args = (grad_scale, ignore_label, use_ignore, norm_id, smooth)
        return out

    @staticmethod
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, norm_id, smooth = ctx.args
        axis = -1 if out.dim() == 2 else 1
        nclass = out.shape[axis]
        lbl = label.to(torch.int32)
        onehot = _onehot(lbl, nclass, axis, out.dtype)
        if smooth > 0:
            onehot = onehot * (1 - smooth) \
                + smooth / (nclass - 1) * (1 - onehot)
        grad = out - onehot
        valid = lbl != int(ignore_label)
        if use_ignore:
            grad = grad * valid.to(out.dtype).unsqueeze(axis % out.dim())
        n = out.shape[0]
        if norm_id == 2:
            grad = grad / (torch.clamp_min(valid.sum(), 1) if use_ignore
                           else n)
        elif norm_id == 1:
            grad = grad / n
        return grad * grad_scale, None, None, None, None, None, None


@register("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax whose defined backward is the fused softmax + cross-entropy
    gradient (see ``_SoftmaxOutput``)."""
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(use_ignore),
                                _NORM_IDS.get(normalization, 0),
                                float(smooth_alpha))


class _Head(torch.autograd.Function):
    """A head whose forward is ``fwd(data)`` and whose backward is
    ``bwd(data, out, label, g)``, with no gradient for the label."""

    @staticmethod
    def forward(ctx, data, label, fwd, bwd):
        out = fwd(data)
        ctx.save_for_backward(data, out, label)
        ctx.bwd = bwd
        return out

    @staticmethod
    def backward(ctx, g):
        data, out, label = ctx.saved_tensors
        return ctx.bwd(data, out, label, g), None, None, None


def _head(data, label, fwd, bwd):
    if label is None:
        label = data.new_empty(0)
    return _Head.apply(data, label, fwd, bwd)


def _identity(d):
    return d.clone()


def _sigmoid(d):
    return 1.0 / (1.0 + torch.exp(-d))


@register("LinearRegressionOutput")
def linear_regression_output(data, label, grad_scale=1.0):
    """Identity; backward ``(data - label) * grad_scale``."""
    return _head(data, label, _identity, lambda d, o, l, g:
                 (d - l.reshape(d.shape)) * grad_scale)


@register("MAERegressionOutput")
def mae_regression_output(data, label, grad_scale=1.0):
    """Identity; backward ``sign(data - label) * grad_scale``."""
    return _head(data, label, _identity, lambda d, o, l, g:
                 torch.sign(d - l.reshape(d.shape)) * grad_scale)


@register("LogisticRegressionOutput")
def logistic_regression_output(data, label, grad_scale=1.0):
    """Sigmoid; backward ``(sigmoid(data) - label) * grad_scale``."""
    return _head(data, label, _sigmoid, lambda d, o, l, g:
                 (o - l.reshape(o.shape)) * grad_scale)


@register("SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Identity; backward the L1- (``use_linear``) or L2-SVM hinge gradient
    (ref: src/operator/svm_output.cc)."""
    margin = float(margin)
    reg = float(regularization_coefficient)

    def bwd(d, o, l, g):
        onehot = _onehot(l.to(torch.int32), d.shape[1], -1, d.dtype)
        if use_linear:
            pos = -(margin > d).to(d.dtype) * reg
            neg = (margin > -d).to(d.dtype) * reg
        else:
            pos = torch.where(margin > d, 2.0 * (margin - d), 0.0) * -reg
            neg = torch.where(margin > -d, -2.0 * (margin + d), 0.0) * -reg
        return torch.where(onehot > 0, pos, neg).to(d.dtype)

    return _head(data, label, _identity, bwd)


@register("MakeLoss")
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Identity; backward the constant ``grad_scale``, divided by the batch
    size (``"batch"``) or by the count of entries above ``valid_thresh``
    (``"valid"``) (ref: make_loss-inl.h)."""
    gs = float(grad_scale)

    def bwd(d, o, l, g):
        if normalization == "batch":
            return torch.full_like(d, gs / d.shape[0])
        if normalization == "valid":
            n_valid = torch.clamp_min((d > valid_thresh).float().sum(), 1.0)
            return (torch.full(d.shape, gs, device=d.device) / n_valid) \
                .to(d.dtype)
        return torch.full_like(d, gs)

    return _head(data, None, _identity, bwd)


@register("IdentityAttachKLSparseReg",
          aliases=("identity_attach_KL_sparse_reg",))
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1, penalty=0.001,
                                  momentum=0.9):
    """Identity; backward adds ``penalty * (-rho / rho_hat + (1 - rho) /
    (1 - rho_hat))``, with ``rho_hat`` the batch mean activation (the JAX
    op's batch average in place of the reference's moving one)."""
    rho = float(sparseness_target)
    pen = float(penalty)

    def bwd(d, o, l, g):
        avg = torch.clamp(d.mean(dim=0, keepdim=True), 1e-6, 1 - 1e-6)
        kl_grad = pen * (-(rho / avg) + (1.0 - rho) / (1.0 - avg))
        return (g + kl_grad).to(d.dtype)

    return _head(data, None, _identity, bwd)


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

@register("Dropout", rng=True)
def dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
            _training=False, generator=None):
    """``data * mask / (1 - p)``, the mask kept with probability ``1 - p``
    and broadcast along ``axes``; the identity outside training unless
    ``mode="always"``. Draws from ``generator`` (default: the device's
    default generator); the recompute of a checkpointed forward
    (``util.replayed``) takes the mask the forward drew."""
    if (not _training and mode != "always") or p <= 0:
        return data
    axes = tuple(a % data.dim() for a in axes)
    shape = [1 if i in axes else s for i, s in enumerate(data.shape)]
    gen = generator if generator is not None \
        else default_generator(data.device)
    keep = 1.0 - p
    # a checkpoint's recompute (remat) reuses the forward's mask
    mask = replayed(lambda: (torch.rand(shape, generator=gen,
                                        device=data.device) < keep)
                    .to(data.dtype))
    return data * mask / keep


# ---------------------------------------------------------------------------
# Embedding and sequence ops
# ---------------------------------------------------------------------------

@register("Embedding")
def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """Rows of ``weight`` at the integer indices ``data``, as a JAX gather
    takes them: negative indices count from the end, the rest are clamped
    into range for the values, and an index out of range passes no
    gradient back to the row it was clamped to."""
    n = weight.shape[0]
    idx = data.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = ((idx >= 0) & (idx < n)).unsqueeze(-1)
    rows = weight[idx.clamp(0, n - 1)]
    return torch.where(inside, rows, rows.detach())


@register("SequenceMask")
def sequence_mask(data, *maybe_len, use_sequence_length=False, value=0.0,
                  axis=0):
    """``value`` past each sequence's length along time ``axis`` (0 or 1;
    the batch is the other)."""
    if not use_sequence_length or not maybe_len:
        return data
    seq_len = maybe_len[0]
    pos = torch.arange(data.shape[axis], device=data.device)
    if axis == 0:
        mask = pos[:, None] < seq_len[None, :]
    else:
        mask = pos[None, :] < seq_len[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, value)


@register("SequenceLast")
def sequence_last(data, *maybe_len, use_sequence_length=False, axis=0):
    """Each sequence's last valid step along time ``axis``."""
    if not use_sequence_length or not maybe_len:
        return data.select(axis, data.shape[axis] - 1)
    last = maybe_len[0].to(torch.int64) - 1
    if axis == 0:
        return data[last, torch.arange(data.shape[1], device=data.device)]
    return data[torch.arange(data.shape[0], device=data.device), last]


@register("SequenceReverse")
def sequence_reverse(data, *maybe_len, use_sequence_length=False, axis=0):
    """Each sequence's first ``length`` steps (time-major) reversed, the
    padding left in place."""
    if not use_sequence_length or not maybe_len:
        return data.flip(0)
    seq_len = maybe_len[0].to(torch.int64)
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    rev = seq_len[None, :] - 1 - pos
    idx = torch.where(rev >= 0, rev, pos)
    batch = torch.arange(data.shape[1], device=data.device)[None, :]
    return data[idx, batch]


# ---------------------------------------------------------------------------
# UpSampling / GridGenerator
# ---------------------------------------------------------------------------

@register("UpSampling", variadic=True)
def upsampling(*inputs, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """The first input (NCHW) upsampled ``scale`` times: nearest, or
    bilinear with half-pixel centres."""
    data = inputs[0]
    if sample_type == "nearest":
        return data.repeat_interleave(scale, dim=2) \
            .repeat_interleave(scale, dim=3)
    return F.interpolate(data, scale_factor=scale, mode="bilinear",
                         align_corners=False)


@register("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """The affine sampling grid ``theta @ [x, y, 1]`` over a
    ``target_shape`` grid spanning [-1, 1]: ``(N, 2, H, W)``."""
    if transform_type != "affine":
        raise MXNetError("only affine GridGenerator supported")
    h, w = target_shape
    ys = torch.linspace(-1, 1, h, dtype=data.dtype, device=data.device)
    xs = torch.linspace(-1, 1, w, dtype=data.dtype, device=data.device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])
    theta = data.reshape(-1, 2, 3)
    return torch.matmul(theta, base).reshape(-1, 2, h, w)
