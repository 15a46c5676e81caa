"""8-bit activation residuals and int8 training convolutions (ref: the JAX
package's ``ops/resid8.py``).

``MXNET_RESID_DTYPE=fp8|e4m3|e5m2`` stores the activation-sized tensors
that the backward reads as fp8 instead of the compute dtype:

- a convolution saves ``fp8(x)`` and the weights; its dx needs only the
  weights and stays exact, its dW reads the dequantized fp8 input;
- a ReLU saves ``fp8(out)`` and takes its mask from ``fp8(out) > 0``;
- the composed BatchNorm core saves the normalised input ``fp8(xhat)``
  instead of the input (``ops/nn.py _BatchNormCore``).

Every cast goes through :func:`_sat_cast`, which clamps to the format's
largest finite value first: PyTorch's own cast saturates to 448 for
e4m3fn but overflows to inf for e5m2, and XLA's overflows for both, so
the clamp is what makes the two packages store the same bytes.

The JAX package keeps one fp8 copy per activation through XLA's common
subexpression elimination (a ReLU and the convolution after it save the
same cast). Eager PyTorch has none, so a ReLU hangs its fp8 copy on its
output tensor (``_mxt_fp8``: format, copy, version) and a convolution
whose input still carries an unmodified copy of its format saves that
copy instead of casting again.

``MXNET_CONV_COMPUTE=int8`` runs every floating convolution as an int8
product: the input quantized with the static scale
``MXNET_CONV_INT8_RANGE / 127``, the weights per output channel, the
int32 accumulators from ``ops/quantization.py int_conv`` (exact on both
devices), and a straight-through backward: dx against the exact weights,
dW from the saved int8 input times the scale, in dy's dtype.

The fused NHWC epilogue kernels ignore both flags, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, env

__all__ = ["resid_dtype", "conv_int8", "conv_resid8", "relu_resid8",
           "conv_int8_train", "fp8_dtype", "shared_fp8"]

_NAMES = {"fp8": "float8_e4m3fn", "e4m3": "float8_e4m3fn",
          "e5m2": "float8_e5m2"}
_ATTR = "_mxt_fp8"


def resid_dtype():
    """The configured residual storage dtype name, or None (disabled)."""
    v = env.get("MXNET_RESID_DTYPE")
    if not v:
        return None
    name = _NAMES.get(v, v)
    if name not in ("float8_e4m3fn", "float8_e5m2"):
        raise MXNetError(
            f"MXNET_RESID_DTYPE={v!r}: expected fp8|e4m3|e5m2")
    return name


def conv_int8() -> bool:
    """``MXNET_CONV_COMPUTE=int8``: training convolutions as int8
    products."""
    return env.get("MXNET_CONV_COMPUTE") == "int8"


def fp8_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _sat_cast(x: torch.Tensor, rdt: torch.dtype) -> torch.Tensor:
    """Saturating cast to an fp8 format: clamp to its largest finite value,
    then cast (NaN stays NaN)."""
    m = float(torch.finfo(rdt).max)
    return x.clamp(-m, m).to(rdt)


def shared_fp8(x: torch.Tensor, rdt_name: str):
    """The fp8 copy a ReLU left on ``x``, if it is of ``rdt_name`` and ``x``
    has not been written since."""
    held = getattr(x, _ATTR, None)
    if held is not None and held[0] == fp8_dtype(rdt_name) and \
            held[2] == x._version:
        return held[1]
    return None


def _conv_backward(dy, x, w, stride, pad, dilate, groups, mask):
    """(dx, dW) of ``conv(x, w)`` at ``dy``: dx from the weights alone,
    dW from ``x``."""
    nd = w.dim() - 2
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy, x, w, None, list(stride), list(pad), list(dilate), False,
        [0] * nd, groups, [mask[0], mask[1], False])
    return dx, dw


class _ConvResid8(torch.autograd.Function):
    """Convolution of channel-first views whose saved input is fp8."""

    @staticmethod
    def forward(ctx, x, w, conv, stride, pad, dilate, groups, rdt, xq):
        out = conv(x, w, None, stride, pad, dilate, groups)
        if xq is None:
            xq = _sat_cast(x, rdt)
        ctx.save_for_backward(xq, w)
        ctx.cfg = (stride, pad, dilate, groups)
        return out

    @staticmethod
    def backward(ctx, dy):
        xq, w = ctx.saved_tensors
        x = xq.to(dy.dtype)
        dx, dw = _conv_backward(dy, x, w.to(dy.dtype), *ctx.cfg,
                                ctx.needs_input_grad[:2])
        return dx, dw, None, None, None, None, None, None, None


def conv_resid8(x, w, conv, stride, pad, dilate, groups, rdt_name,
                held=None):
    """``conv(x, w)`` of channel-first views saving ``fp8(x)`` for the
    backward; ``held``: the same view of the fp8 copy a ReLU left on the
    op's input (see :func:`shared_fp8`), saved instead of a new cast."""
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return conv(x, w, None, stride, pad, dilate, groups)
    return _ConvResid8.apply(x, w, conv, tuple(stride), tuple(pad),
                             tuple(dilate), int(groups),
                             fp8_dtype(rdt_name), held)


class _ReluResid8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rdt):
        y = torch.maximum(x, x.new_zeros(()))
        yq = _sat_cast(y, rdt)
        ctx.save_for_backward(yq)
        ctx.mark_non_differentiable(yq)
        return y, yq

    @staticmethod
    def backward(ctx, dy, _dyq):
        (yq,) = ctx.saved_tensors
        # fp8 has no comparison kernels: compare in dy's dtype (exact)
        return torch.where(yq.to(dy.dtype) > 0, dy, dy.new_zeros(())), None


def relu_resid8(data, rdt_name):
    """``max(data, 0)`` saving ``fp8(out)``; the mask is ``fp8(out) > 0``
    (an fp8-denormal positive gets the valid 0 subgradient). The copy is
    left on the output for the next convolution."""
    if not (torch.is_grad_enabled() and data.requires_grad):
        return torch.maximum(data, data.new_zeros(()))
    rdt = fp8_dtype(rdt_name)
    y, yq = _ReluResid8.apply(data, rdt)
    setattr(y, _ATTR, (rdt, yq, y._version))
    return y


def _quant_w(w):
    """Per-output-channel symmetric int8 weights and their f32 scales."""
    w32 = w.float()
    absmax = w32.reshape(w32.shape[0], -1).abs().amax(dim=1)
    sw = torch.clamp_min(absmax, 1e-8) / 127.0
    qw = torch.clamp(torch.round(w32 / sw.reshape((-1,) + (1,) *
                                                  (w32.dim() - 1))),
                     -127, 127).to(torch.int8)
    return qw, sw


class _ConvInt8(torch.autograd.Function):
    """The int8 training convolution of channel-first views."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dilate, groups, s_act):
        from .quantization import int_conv
        qx = torch.clamp(torch.round(x.float() * (1.0 / s_act)),
                         -127, 127).to(torch.int8)
        qw, sw = _quant_w(w)
        acc = int_conv(qx, qw, stride, pad, dilate, groups,
                       channel_last=False)
        shape = (1, -1) + (1,) * (acc.dim() - 2)
        out = acc.float() * (sw * s_act).reshape(shape)
        ctx.save_for_backward(qx, w)
        ctx.cfg = (stride, pad, dilate, groups)
        ctx.s_act = s_act
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        qx, w = ctx.saved_tensors
        # the scale rounded to dy's dtype first (a fill: capturable)
        x = qx.to(dy.dtype) * torch.full((), ctx.s_act, dtype=dy.dtype,
                                         device=dy.device)
        dx, dw = _conv_backward(dy, x, w.to(dy.dtype), *ctx.cfg,
                                ctx.needs_input_grad[:2])
        if dw is not None:
            dw = dw.to(w.dtype)
        return dx, dw, None, None, None, None, None


def conv_int8_train(x, w, stride, pad, dilate, groups):
    """The int8 training convolution (``MXNET_CONV_COMPUTE=int8``) of the
    channel-first views ``x`` and ``w``; output in x's dtype."""
    s_act = float(env.get("MXNET_CONV_INT8_RANGE")) / 127.0
    return _ConvInt8.apply(x, w, tuple(stride), tuple(pad), tuple(dilate),
                           int(groups), s_act)
