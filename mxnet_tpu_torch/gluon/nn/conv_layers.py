"""Gluon convolution and pooling layers (ref: the JAX package's
``gluon/nn/conv_layers.py``; python/mxnet/gluon/nn/conv_layers.py).

Convolutions in 1, 2 and 3 dimensions and their transposes, over the
``Convolution`` / ``Deconvolution`` ops. The weight keeps MXNet's layout:
``(O, I/g, *k)`` channel-first and ``(O, *k, I/g)`` channel-last for a
convolution, ``(I, O/g, *k)`` for a transpose. ``in_channels=0`` is read
from the first input's channel axis. Pooling layers (max, avg, global)
over the ``Pooling`` op, with ``ceil_mode`` as the "full" convention.
``hybrid_forward`` is each layer's symbolic twin (``export``).
"""
from __future__ import annotations

from ...ops import nn as F
from ..block import HybridBlock
from .basic_layers import _F

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        nd = len(kernel_size)
        self._channels = channels
        self._layout = layout
        self._channel_axis = layout.index("C")
        self._transpose = op_name == "Deconvolution"
        self._activation = activation
        self._use_bias = use_bias
        self._kwargs = {
            "kernel": kernel_size, "stride": _tup(strides, nd),
            "dilate": _tup(dilation, nd), "pad": _tup(padding, nd),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = _tup(adj, nd)
        if self._transpose:
            wshape = (in_channels, channels // groups) + tuple(kernel_size)
        elif layout.endswith("C"):
            wshape = (channels,) + tuple(kernel_size) \
                + (in_channels // groups,)
        else:
            wshape = (channels, in_channels // groups) + tuple(kernel_size)
        self._new_param("weight", wshape, init=weight_initializer,
                        allow_deferred_init=True)
        if use_bias:
            self._new_param("bias", (channels,), init=bias_initializer)

    def infer_shape_from_inputs(self, x):
        c = x.shape[self._channel_axis]
        w = self.params[self.prefix + "weight"]
        g = self._kwargs["num_group"]
        if self._transpose:
            shape = (c,) + w.shape[1:]
        elif self._layout.endswith("C"):
            shape = (w.shape[0],) + w.shape[1:-1] + (c // g,)
        else:
            shape = (w.shape[0], c // g) + w.shape[2:]
        w.shape_hint(shape)

    def forward(self, x):
        op = F.deconvolution if self._transpose else F.convolution
        bias = (self.bias,) if self._use_bias else ()
        out = op(x, self.weight, *bias, **self._kwargs)
        if self._activation:
            out = F.activation(out, act_type=self._activation)
        return out

    def hybrid_forward(self, F, x, weight, bias=None):
        op = F.Deconvolution if self._transpose else F.Convolution
        if bias is None:
            out = op(x, weight, **self._kwargs)
        else:
            out = op(x, weight, bias, **self._kwargs)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out

    def extra_repr(self):
        return (f"{self._channels}, kernel={self._kwargs['kernel']}, "
                f"layout={self._layout}")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kw):
        super().__init__(channels, _tup(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer, **kw)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kw):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer, **kw)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kw):
        super().__init__(channels, _tup(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer, **kw)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kw):
        super().__init__(channels, _tup(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kw)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kw):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kw)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kw):
        super().__init__(channels, _tup(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kw)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, prefix=None,
                 device=None):
        super().__init__(prefix=prefix, device=device)
        if strides is None:
            strides = pool_size
        nd = len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": _tup(strides, nd),
            "pad": _tup(padding, nd), "pool_type": pool_type,
            "global_pool": global_pool,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def forward(self, x):
        return F.pooling(x, **self._kwargs)

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def extra_repr(self):
        return f"{self._kwargs['kernel']}"


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kw):
        super().__init__(_tup(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", layout, **kw)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kw):
        super().__init__(_tup(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", layout, **kw)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kw):
        super().__init__(_tup(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", layout, **kw)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kw):
        super().__init__(_tup(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kw)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kw):
        super().__init__(_tup(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kw)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kw):
        super().__init__(_tup(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kw)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kw):
        super().__init__((1,), None, 0, False, True, "max", layout, **kw)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kw):
        super().__init__((1, 1), None, 0, False, True, "max", layout, **kw)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kw):
        super().__init__((1, 1, 1), None, 0, False, True, "max", layout,
                         **kw)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kw):
        super().__init__((1,), None, 0, False, True, "avg", layout, **kw)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kw):
        super().__init__((1, 1), None, 0, False, True, "avg", layout, **kw)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kw):
        super().__init__((1, 1, 1), None, 0, False, True, "avg", layout,
                         **kw)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of an NCHW input: an int pads H and W by it on
    both sides; else the ``Pad`` op's 8-tuple ``pad_width``."""

    def __init__(self, padding=0, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def forward(self, x):
        return _F.Pad(x, mode="reflect", pad_width=self._padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
