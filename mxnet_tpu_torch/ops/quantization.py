"""INT8 quantization operators (ref: the JAX package's
``ops/quantization.py``; src/operator/quantization/).

The 22 registry names of the JAX module, with its ``num_outputs``,
``differentiable=False`` and ``variadic`` flags, computing the same
arithmetic operation for operation, so that int8 / int32 results are
bit-equal to the JAX package's and the dequantized f32 ones agree to the
last bits of the epilogue: ``_quantize_v2`` divides by the scale,
``_quantize_static`` multiplies by its inverse, ``round`` is half to even,
and every float to integer cast saturates as XLA's convert
(``elemwise.saturating_cast``). Symmetric int8 with float ``(min, max)``
ranges, the reference's ``(data, min_range, max_range)`` triple.

The int8 products (:func:`int_matmul`, :func:`int_conv`) give exact int32
accumulators. On the CPU they are the plain version: PyTorch's int32
``matmul`` and an f64 ``conv`` (exact: integers below 2^53) on the int8
values. On the card
they go through ``torch._int_mm`` (cuBLASLt's int8 GEMM), convolutions by
an NHWC im2col of the int8 input (pad, a strided view of the windows,
``reshape``) against the weights as ``(O, kh kw I/g)``, one product per
group. ``_int_mm`` wants more than 16 rows and K and N multiples of 8:
the operands are zero-padded to that, which keeps the result exact. There
is no float fallback: a shape that cannot be padded raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, check
from .elemwise import saturating_cast
from .registry import register

__all__ = ["int_matmul", "int_conv", "launches"]

# _int_mm launches on the card (the chip check reads and resets it)
launches = {"int_mm": 0}

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


# ---------------------------------------------------------------------------
# exact int8 products
# ---------------------------------------------------------------------------

def _int_mm(a, b):
    """``a @ b.T`` of int8 ``a`` (M, K) and ``b`` (N, K) as int32 through
    ``torch._int_mm``, zero-padded to its shape rules."""
    m, k = a.shape
    n = b.shape[0]
    kp, np_, mp = -(-k // 8) * 8, -(-n // 8) * 8, max(m, 17)
    if kp != k or mp != m:
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if kp != k or np_ != n:
        b = F.pad(b, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    launches["int_mm"] += 1
    return out[:m, :n] if (mp != m or np_ != n) else out


def int_matmul(x, w):
    """int32 ``x @ w.T`` of int8 ``x`` (..., K) and ``w`` (N, K)."""
    check(x.dtype == torch.int8 and w.dtype == torch.int8,
          f"int8 product of {x.dtype} and {w.dtype}")
    if x.device.type == "cpu":
        return torch.matmul(x.to(torch.int32), w.to(torch.int32).t())
    lead = x.shape[:-1]
    out = _int_mm(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[0])


def _windows(x, kernel, stride, pad, dilate):
    """im2col of channel-last int8 ``x`` (N, *S, C): the padded windows as
    a (N, *out, *k, C) strided view and the output extents."""
    nd = len(kernel)
    if any(pad):
        widths = [0, 0]
        for p in reversed(pad):
            widths += [p, p]
        x = F.pad(x, widths)
    x = x.contiguous()
    spatial = x.shape[1:1 + nd]
    out = [(spatial[i] - dilate[i] * (kernel[i] - 1) - 1) // stride[i] + 1
           for i in range(nd)]
    check(all(o > 0 for o in out), f"int8 conv: window {kernel} larger "
          f"than the padded input {tuple(spatial)}")
    st = x.stride()
    shape = (x.shape[0],) + tuple(out) + tuple(kernel) + (x.shape[-1],)
    strides = (st[0],) + tuple(st[1 + i] * stride[i] for i in range(nd)) \
        + tuple(st[1 + i] * dilate[i] for i in range(nd)) + (st[-1],)
    return x.as_strided(shape, strides), out


def _int_conv_card(x, w, stride, pad, dilate, groups):
    """int32 conv of channel-last int8 ``x`` (N, *S, C) with ``w``
    (O, *k, C/g), channel-last out, by im2col + ``_int_mm``."""
    nd = x.dim() - 2
    kernel = tuple(w.shape[1:1 + nd])
    win, out = _windows(x, kernel, stride, pad, dilate)
    n, o = x.shape[0], w.shape[0]
    cg, og = x.shape[-1] // groups, o // groups
    rows = n * math.prod(out)
    parts = []
    for g in range(groups):
        cols = win[..., g * cg:(g + 1) * cg].reshape(rows, -1)
        wg = w[g * og:(g + 1) * og].reshape(og, -1)
        parts.append(_int_mm(cols, wg))
    acc = parts[0] if groups == 1 else torch.cat(parts, dim=1)
    return acc.reshape(n, *out, o)


def int_conv(x, w, stride, pad, dilate, groups, channel_last):
    """Exact int32 convolution of int8 ``x`` and ``w``. Channel-last:
    ``x`` (N, *S, C), ``w`` (O, *k, C/g), out (N, *S', O); else
    channel-first (N, C, *S), (O, C/g, *k), (N, O, *S')."""
    check(x.dtype == torch.int8 and w.dtype == torch.int8,
          f"int8 convolution of {x.dtype} and {w.dtype}")
    nd = x.dim() - 2
    stride, pad, dilate = tuple(stride), tuple(pad), tuple(dilate)
    if x.device.type == "cpu":
        if channel_last:
            x = x.movedim(-1, 1)
            w = w.movedim(-1, 1)
        # f64: every product and partial sum is an integer below 2^53,
        # so exact (PyTorch's CPU int32 convolution has no dilation)
        out = _CONV[nd](x.to(torch.float64), w.to(torch.float64), None,
                        stride, pad, dilate, groups).to(torch.int32)
        return out.movedim(1, -1) if channel_last else out
    if not channel_last:
        x = x.movedim(1, -1)
        w = w.movedim(1, -1)
    out = _int_conv_card(x, w, stride, pad, dilate, groups)
    return out if channel_last else out.movedim(-1, 1)


# ---------------------------------------------------------------------------
# the registry ops
# ---------------------------------------------------------------------------

def _f32(v, like):
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _scale(mn, mx):
    amax = torch.maximum(mn.abs(), mx.abs())
    return torch.clamp_min(amax, 1e-8) / 127.0


def _div(a, b):
    """``a / b`` with JAX's promotion of a 0-d operand (PyTorch would keep
    the other's lower precision)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) / b.to(dt)


def _to_int8(x):
    return saturating_cast(torch.clamp(torch.round(x), -127, 127),
                           torch.int8)


@register("_contrib_quantize_v2", aliases=("quantize_v2",), num_outputs=3,
          differentiable=False)
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """int8 with the data's (or the calibrated) symmetric range."""
    if min_calib_range is None or max_calib_range is None:
        mn, mx = data.amin(), data.amax()
    else:
        mn = _f32(float(min_calib_range), data)
        mx = _f32(float(max_calib_range), data)
    s = _scale(mn, mx)
    q = _to_int8(_div(data, s))
    return q, -s * 127.0, s * 127.0


@register("_contrib_dequantize", aliases=("dequantize",),
          differentiable=False)
def dequantize(data, min_range, max_range, out_type="float32"):
    return data.to(torch.float32) * _scale(min_range, max_range)


@register("_contrib_requantize", aliases=("requantize",), num_outputs=3,
          differentiable=False)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None, out_type="int8"):
    """int32 accumulators to int8 with a new range."""
    f = data.to(torch.float32) * _scale(min_range, max_range) \
        / (127.0 * 127.0)
    if min_calib_range is None:
        mn, mx = f.amin(), f.amax()
    else:
        mn = _f32(float(min_calib_range), f)
        mx = _f32(float(max_calib_range), f)
    s = _scale(mn, mx)
    q = _to_int8(f / s)
    return q, -s * 127.0, s * 127.0


def _flat(x, flatten):
    return x.reshape(x.shape[0], -1) if flatten and x.dim() > 2 else x


@register("_contrib_quantized_fully_connected",
          aliases=("quantized_fully_connected",), num_outputs=3,
          differentiable=False)
def quantized_fully_connected(data, weight, bias, data_min, data_max, w_min,
                              w_max, b_min=None, b_max=None, num_hidden=1,
                              no_bias=False, flatten=True):
    """int8 x int8 -> int32 product, dequantized, plus the int8 bias."""
    acc = int_matmul(_flat(data, flatten), weight)
    out = acc.to(torch.float32) * (_scale(data_min, data_max)
                                   * _scale(w_min, w_max))
    if not no_bias and bias is not None:
        out = out + bias.to(torch.float32) * _scale(b_min, b_max)
    omax = out.abs().amax()
    return out, -omax, omax


@register("_contrib_quantized_conv", aliases=("quantized_conv",),
          num_outputs=3, differentiable=False)
def quantized_conv(data, weight, bias, data_min, data_max, w_min, w_max,
                   b_min=None, b_max=None, kernel=(), stride=(), dilate=(),
                   pad=(), num_filter=1, num_group=1, no_bias=False,
                   layout="NCHW"):
    """Channel-first int8 convolution, dequantized, plus the int8 bias."""
    nd = len(kernel)
    stride = tuple(stride) if stride else (1,) * nd
    dilate = tuple(dilate) if dilate else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    acc = int_conv(saturating_cast(data, torch.int8),
                   saturating_cast(weight, torch.int8), stride, pad, dilate,
                   num_group, channel_last=False)
    out = acc.to(torch.float32) * (_scale(data_min, data_max)
                                   * _scale(w_min, w_max))
    if not no_bias and bias is not None:
        out = out + (bias.to(torch.float32) * _scale(b_min, b_max)).reshape(
            (1, -1) + (1,) * nd)
    omax = out.abs().amax()
    return out, -omax, omax


@register("_quantized_fc_static", differentiable=False)
def quantized_fc_static(qdata, dmin, dmax, qweight, *maybe_bias, w_min=0.0,
                        w_max=0.0, num_hidden=1, no_bias=False,
                        flatten=True):
    """Quantized FC with the weight range baked in at graph-rewrite time;
    dequantized f32 out."""
    acc = int_matmul(_flat(qdata, flatten), qweight)
    sw = max(abs(w_min), abs(w_max), 1e-8) / 127.0
    out = acc.to(torch.float32) * (_scale(dmin, dmax) * sw)
    if not no_bias and maybe_bias:
        out = out + maybe_bias[0].to(torch.float32)
    return out


@register("_contrib_quantized_pooling", aliases=("quantized_pooling",),
          num_outputs=3, differentiable=False)
def quantized_pooling(data, data_min, data_max, kernel=(), pool_type="max",
                      global_pool=False, stride=(), pad=(),
                      pooling_convention="valid", **_):
    from .nn import pooling
    out = pooling(data.to(torch.float32), kernel=kernel,
                  pool_type=pool_type, global_pool=global_pool,
                  stride=stride, pad=pad,
                  pooling_convention=pooling_convention)
    return saturating_cast(out, data.dtype), data_min, data_max


@register("_contrib_quantized_flatten", aliases=("quantized_flatten",),
          num_outputs=3, differentiable=False)
def quantized_flatten(data, data_min, data_max):
    return data.reshape(data.shape[0], -1), data_min, data_max


@register("_contrib_quantize", aliases=("quantize",), num_outputs=3,
          differentiable=False)
def quantize_v1(data, min_range, max_range, out_type="uint8"):
    """v1 quantize with explicit ``(min_range, max_range)`` inputs: uint8
    over ``[min, max]``, or int8 zero-centred (ref:
    quantize-inl.h quantize_unsigned / quantize_zero_centered)."""
    mn = min_range.reshape(())
    mx = max_range.reshape(())
    if out_type == "uint8":
        scale = 255.0 / torch.clamp_min(mx - mn, 1e-8)
        q = saturating_cast(torch.floor((data - mn) * scale + 0.5),
                            torch.uint8)
        return q, mn, mx
    real = torch.clamp_min(torch.maximum(mn.abs(), mx.abs()), 1e-8)
    scale = 127.0 / real
    q = saturating_cast(torch.sign(data) * torch.clamp_max(
        data.abs() * scale + 0.5, 127.0), torch.int8)
    return q, -real, real


@register("_quantize_static", differentiable=False)
def quantize_static(data, scale=1.0):
    """``clip(round(x / scale), -127, 127)`` with a calibration-time scale,
    as a multiply by its inverse (with the consumers' 1e-8 floor)."""
    inv = 1.0 / max(float(scale), 1e-8)
    return _to_int8(data.to(torch.float32) * inv)


def _layout_dn(layout):
    from .nn import _LAYOUTS
    check(layout in _LAYOUTS, f"unsupported quantized conv layout "
          f"{layout!r}")
    return layout[-1] == "C"


@register("_quantized_conv_v2", differentiable=False)
def quantized_conv_v2(qdata, qweight, wscale, *maybe_bias, kernel=(),
                      stride=(), dilate=(), pad=(), num_filter=1,
                      num_group=1, layout="NHWC", in_scale=1.0,
                      no_bias=True, out_dtype="float32"):
    """int8 convolution with per-output-channel weight scales and a static
    input scale; the dequantize multiply and the bias in the epilogue.
    ``qweight``: (O, *k, I/g) channel-last, (O, I/g, *k) otherwise."""
    from ..base import torch_dtype
    nd = len(kernel)
    stride = tuple(stride) if stride else (1,) * nd
    dilate = tuple(dilate) if dilate else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    acc = int_conv(qdata, qweight, stride, pad, dilate, num_group,
                   channel_last=_layout_dn(layout))
    ax = layout.index("C")
    bshape = tuple(num_filter if i == ax else 1 for i in range(qdata.dim()))
    out = acc.to(torch.float32) * (
        wscale.to(torch.float32) * max(float(in_scale), 1e-8)).reshape(bshape)
    if not no_bias and maybe_bias:
        out = out + maybe_bias[0].to(torch.float32).reshape(bshape)
    return out.to(torch_dtype(out_dtype))


@register("_quantized_dense_v2", differentiable=False)
def quantized_dense_v2(qdata, qweight, wscale, *maybe_bias, num_hidden=1,
                       flatten=True, in_scale=1.0, no_bias=True,
                       out_dtype="float32"):
    """int8 product with per-output-channel weight scales (the
    FullyConnected counterpart of ``_quantized_conv_v2``)."""
    from ..base import torch_dtype
    acc = int_matmul(_flat(qdata, flatten), qweight)
    out = acc.to(torch.float32) * (
        wscale.to(torch.float32) * max(float(in_scale), 1e-8))
    if not no_bias and maybe_bias:
        out = out + maybe_bias[0].to(torch.float32)
    return out.to(torch_dtype(out_dtype))


@register("_contrib_quantized_concat", aliases=("quantized_concat",),
          num_outputs=3, variadic=True, differentiable=False)
def quantized_concat(*args, dim=1, num_args=1):
    """Concatenate int8 inputs, each rescaled to the merged range (inputs:
    ``num_args`` data, then their mins, then their maxs)."""
    n = int(num_args)
    if len(args) != 3 * n:
        raise MXNetError(f"quantized_concat: {3 * n} inputs expected for "
                         f"num_args={n}, got {len(args)}")
    datas = args[:n]
    mins = [m.reshape(()) for m in args[n:2 * n]]
    maxs = [m.reshape(()) for m in args[2 * n:3 * n]]
    out_min, out_max = mins[0], maxs[0]
    for m in mins[1:]:
        out_min = torch.minimum(out_min, m)
    for m in maxs[1:]:
        out_max = torch.maximum(out_max, m)
    out_abs = torch.maximum(out_min.abs(), out_max.abs())
    out_scale = 127.0 / torch.clamp_min(out_abs, 1e-8)
    rescaled = []
    for q, mn, mx in zip(datas, mins, maxs):
        in_abs = torch.maximum(mn.abs(), mx.abs())
        f = q.to(torch.float32) * (in_abs / 127.0)
        rescaled.append(_to_int8(f * out_scale))
    return torch.cat(rescaled, dim=int(dim)), -out_abs, out_abs
