"""Gluon convolution and pooling layers (ref:
python/mxnet/gluon/nn/conv_layers.py). 2-d only in this port."""
from __future__ import annotations

from ...base import check
from ...ops import nn as F
from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(HybridBlock):
    """2-d convolution. The weight keeps MXNet's layout: (O, kh, kw, I/g)
    for NHWC, (O, I/g, kh, kw) for NCHW. ``in_channels`` must be given."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 device=None):
        super().__init__(prefix=prefix, device=device)
        check(layout in ("NCHW", "NHWC"), f"unsupported layout {layout!r}")
        check(activation is None, "Conv2D activation is not ported yet")
        k = _pair(kernel_size)
        self._channels = channels
        self._layout = layout
        self._kwargs = {"stride": _pair(strides), "pad": _pair(padding),
                        "dilate": _pair(dilation), "num_group": groups,
                        "layout": layout}
        cin = in_channels // groups
        wshape = (channels,) + k + (cin,) if layout == "NHWC" \
            else (channels, cin) + k
        self._new_param("weight", wshape, init=weight_initializer)
        self._use_bias = use_bias
        if use_bias:
            self._new_param("bias", (channels,), init=bias_initializer)

    def forward(self, x):
        return F.convolution(x, self.weight,
                             self.bias if self._use_bias else None,
                             **self._kwargs)

    def extra_repr(self):
        return f"{self._channels}, layout={self._layout}"


class MaxPool2D(HybridBlock):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        check(not ceil_mode, "ceil_mode pooling is not ported yet")
        self._kwargs = {"kernel": _pair(pool_size),
                        "stride": _pair(strides if strides is not None
                                        else pool_size),
                        "pad": _pair(padding), "layout": layout}

    def forward(self, x):
        return F.pooling(x, pool_type="max", **self._kwargs)


class GlobalAvgPool2D(HybridBlock):
    def __init__(self, layout="NCHW", prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._layout = layout

    def forward(self, x):
        return F.pooling(x, pool_type="avg", global_pool=True,
                         layout=self._layout)
