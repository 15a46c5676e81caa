"""Convolutional RNN, LSTM and GRU cells (ref: the JAX package's
``gluon/contrib/rnn/conv_rnn_cell.py``; python/mxnet/gluon/contrib/rnn/
conv_rnn_cell.py).

The state keeps its spatial extent across steps: the state-to-state
(h2h) convolution pads to the same size (its kernel must be odd), and
the input-to-state (i2h) convolution's output extent, set by the i2h
kernel, padding and dilation, is the state's. Both are the port's
``Convolution`` on tensors.
"""
from __future__ import annotations

import torch

from ....base import check
from ....ops import nn as F
from ...rnn.rnn_cell import RecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tuplify(x, ndim):
    if isinstance(x, (list, tuple)):
        check(len(x) == ndim, f"expected length-{ndim} tuple, got {x}")
        return tuple(int(v) for v in x)
    return (int(x),) * ndim


class _BaseConvRNNCell(RecurrentCell):
    """(ref: conv_rnn_cell.py:37 _BaseConvRNNCell)"""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, num_gates, activation,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout="NCHW", prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        ndim = len(conv_layout) - 2
        self._input_shape = tuple(input_shape)
        self._hidden_channels = hidden_channels
        self._i2h_kernel = _tuplify(i2h_kernel, ndim)
        self._h2h_kernel = _tuplify(h2h_kernel, ndim)
        for k in self._h2h_kernel:
            check(k % 2 == 1,
                  f"h2h_kernel dims must be odd for same-padding, got "
                  f"{self._h2h_kernel}")
        self._i2h_pad = _tuplify(i2h_pad, ndim)
        self._i2h_dilate = _tuplify(i2h_dilate, ndim)
        self._h2h_dilate = _tuplify(h2h_dilate, ndim)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        self._num_gates = num_gates
        self._activation = activation
        self._conv_layout = conv_layout
        in_channels = self._input_shape[0]
        # the state's extent is the i2h convolution's output (stride 1)
        self._state_shape = (hidden_channels,) + tuple(
            s + 2 * p - d * (k - 1)
            for s, p, d, k in zip(self._input_shape[1:], self._i2h_pad,
                                  self._i2h_dilate, self._i2h_kernel))
        g = num_gates
        self.i2h_weight = self.params.get(
            "i2h_weight",
            shape=(g * hidden_channels, in_channels) + self._i2h_kernel,
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(g * hidden_channels, hidden_channels) + self._h2h_kernel,
            init=h2h_weight_initializer)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(g * hidden_channels,),
            init=i2h_bias_initializer)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(g * hidden_channels,),
            init=h2h_bias_initializer)

    def infer_shape_from_inputs(self, inputs, states=None):
        pass    # input_shape gave every extent at construction

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._conv_layout}]

    def _convs(self, inputs, h):
        n = self._num_gates * self._hidden_channels
        stride = (1,) * len(self._i2h_kernel)
        i2h = F.convolution(inputs, self.i2h_weight.tensor,
                            self.i2h_bias.tensor, kernel=self._i2h_kernel,
                            stride=stride, pad=self._i2h_pad,
                            dilate=self._i2h_dilate, num_filter=n)
        h2h = F.convolution(h, self.h2h_weight.tensor, self.h2h_bias.tensor,
                            kernel=self._h2h_kernel, stride=stride,
                            pad=self._h2h_pad, dilate=self._h2h_dilate,
                            num_filter=n)
        return i2h, h2h

    def _act(self, x):
        return F.activation(x, act_type=self._activation)

    def extra_repr(self):
        return f"in={self._input_shape}, hidden={self._hidden_channels}"


class _ConvRNNCell(_BaseConvRNNCell):
    """(ref: conv_rnn_cell.py:177)"""

    num_gates = 1

    def forward(self, inputs, states):
        i2h, h2h = self._convs(inputs, states[0])
        out = self._act(i2h + h2h)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    """(ref: conv_rnn_cell.py:420; Shi et al. 2015, Convolutional LSTM)"""

    num_gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._conv_layout}] * 2

    def forward(self, inputs, states):
        i2h, h2h = self._convs(inputs, states[0])
        i, f, g, o = (i2h + h2h).chunk(4, dim=1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * self._act(g)
        out = torch.sigmoid(o) * self._act(c)
        return out, [out, c]


class _ConvGRUCell(_BaseConvRNNCell):
    """(ref: conv_rnn_cell.py:704)"""

    num_gates = 3

    def forward(self, inputs, states):
        prev = states[0]
        i2h, h2h = self._convs(inputs, prev)
        ir, iz, i_n = i2h.chunk(3, dim=1)
        hr, hz, hn = h2h.chunk(3, dim=1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = self._act(i_n + r * hn)
        out = (1 - z) * n + z * prev
        return out, [out]


def _make(base, ndim, name, doc_line):
    layout = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[ndim]

    class Cell(base):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     activation="tanh", conv_layout=layout, **kw):
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                             base.num_gates, activation,
                             conv_layout=conv_layout, **kw)

    Cell.__name__ = Cell.__qualname__ = name
    Cell.__doc__ = doc_line
    return Cell


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell",
                      "1D conv RNN cell (ref: conv_rnn_cell.py:218)")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell",
                      "2D conv RNN cell (ref: conv_rnn_cell.py:285)")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell",
                      "3D conv RNN cell (ref: conv_rnn_cell.py:352)")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell",
                       "1D conv LSTM cell (ref: conv_rnn_cell.py:473)")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell",
                       "2D conv LSTM cell (ref: conv_rnn_cell.py:550)")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell",
                       "3D conv LSTM cell (ref: conv_rnn_cell.py:627)")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell",
                      "1D conv GRU cell (ref: conv_rnn_cell.py:762)")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell",
                      "2D conv GRU cell (ref: conv_rnn_cell.py:834)")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell",
                      "3D conv GRU cell (ref: conv_rnn_cell.py:906)")
