"""Gluon fused RNN layers (ref: the JAX package's ``gluon/rnn/rnn_layer.py``;
python/mxnet/gluon/rnn/rnn_layer.py): the layers that run the fused RNN
op (``ops/rnn_op.py``) instead of unrolled cells.

Each layer and direction holds ``{l,r}{layer}_{i2h,h2h}_{weight,bias}``
(declared with ``self.params.get``, so ``layer.l0_i2h_weight`` is the
:class:`Parameter` record, as in the JAX package); the forward hands them
to the op's layer loop as they are, in the op's packing order, without
building the flat vector. ``input_size=0`` is read from the first input.
Layout ``TNC`` or ``NTC``. ``layer(x)`` returns the output;
``layer(x, states)`` returns ``(output, new_states)``. Without states the
layer starts from f32 zeros on the input's device. Called with NDArrays
(the input, the states or both) the layer takes and gives NDArrays.
``hybridize()`` runs it as a CachedOp: on the card one CUDA graph per
signature, whose dropout masks change on every replay.
"""
from __future__ import annotations

import torch

from ... import autograd
from ...base import check
from ...ops import rnn_op
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        check(layout in ("TNC", "NTC"), f"invalid layout {layout}")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        ng = rnn_op._GATES[mode] * hidden_size
        for layer in range(num_layers):
            for d in range(self._dir):
                suffix = ["l", "r"][d] + str(layer)
                in_sz = input_size if layer == 0 else hidden_size * self._dir
                setattr(self, f"{suffix}_i2h_weight", self.params.get(
                    f"{suffix}_i2h_weight", shape=(ng, in_sz),
                    init=i2h_weight_initializer, allow_deferred_init=True))
                setattr(self, f"{suffix}_h2h_weight", self.params.get(
                    f"{suffix}_h2h_weight", shape=(ng, hidden_size),
                    init=h2h_weight_initializer))
                setattr(self, f"{suffix}_i2h_bias", self.params.get(
                    f"{suffix}_i2h_bias", shape=(ng,),
                    init=i2h_bias_initializer))
                setattr(self, f"{suffix}_h2h_bias", self.params.get(
                    f"{suffix}_h2h_bias", shape=(ng,),
                    init=h2h_bias_initializer))

    def infer_shape_from_inputs(self, inputs, *rest):
        in_sz = inputs.shape[2]
        for d in range(self._dir):
            p = self._params[self._prefix + ["l", "r"][d] + "0_i2h_weight"]
            p.shape_hint((p.shape[0], in_sz))

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        if self._mode == "lstm":
            return [{"shape": shape}, {"shape": shape}]
        return [{"shape": shape}]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """NDArray zeros of each state's shape (``func(shape, **kwargs)``
        when given)."""
        from ... import ndarray as nd
        func = func or nd.zeros
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _layers(self):
        """(W, R, bW, bR) of each layer and direction, in the op's
        packing order."""
        own = self._parameters
        return [tuple(own[f"{['l', 'r'][d]}{layer}_{k}"]
                      for k in ("i2h_weight", "h2h_weight", "i2h_bias",
                                "h2h_bias"))
                for layer in range(self._num_layers)
                for d in range(self._dir)]

    def forward(self, inputs, states=None):
        explicit = states is not None
        x = inputs if self._layout == "TNC" else inputs.transpose(0, 1)
        if not explicit:
            states = [torch.zeros(info["shape"], device=x.device)
                      for info in self.state_info(x.shape[1])]
        elif isinstance(states, torch.Tensor):
            states = [states]
        cell = states[1] if len(states) > 1 else torch.zeros_like(states[0])
        out, h, c = rnn_op.run_layers(
            x, self._layers(), states[0], cell, self._mode, self._dir == 2,
            self._dropout, autograd.is_training())
        new_states = [h, c] if self._mode == "lstm" else [h]
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        return (out, new_states) if explicit else out

    def extra_repr(self):
        return (f"{self._hidden_size}, layers={self._num_layers}, "
                f"bidir={self._dir == 2}")


class RNN(_RNNLayer):
    """Elman RNN layer, ``relu`` or ``tanh`` (ref: gluon.rnn.RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, mode, **kwargs)


class LSTM(_RNNLayer):
    """LSTM layer (ref: gluon.rnn.LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """GRU layer (ref: gluon.rnn.GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
