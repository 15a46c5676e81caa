"""Contrib RNN cells (ref: the JAX package's
``gluon/contrib/rnn/rnn_cell.py``; python/mxnet/gluon/contrib/rnn/
rnn_cell.py): ``VariationalDropoutCell`` and ``LSTMPCell``, on tensors as
the cells of ``gluon/rnn/rnn_cell.py`` are."""
from __future__ import annotations

import torch

from .... import autograd
from ....ops import nn as F
from ...rnn.rnn_cell import RecurrentCell, _BaseCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(RecurrentCell):
    """Variational (locked) dropout: in training, one mask per unroll for
    the inputs, the first state and the outputs, reused at every time
    step (ref: contrib/rnn/rnn_cell.py:27)."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0., **kw):
        super().__init__(**kw)
        self.register_child(base_cell, "base_cell")
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size=batch_size, **kwargs)

    @staticmethod
    def _initialize_mask(rate, like):
        # dropout of ones is the inverted-dropout mask (0 or 1 / (1 - p))
        return F.dropout(torch.ones_like(like), p=rate, _training=True)

    def forward(self, inputs, states):
        training = autograd.is_training()
        if training:
            if self.drop_inputs:
                if self.drop_inputs_mask is None:
                    self.drop_inputs_mask = self._initialize_mask(
                        self.drop_inputs, inputs)
                inputs = inputs * self.drop_inputs_mask
            if self.drop_states:
                if self.drop_states_mask is None:
                    self.drop_states_mask = self._initialize_mask(
                        self.drop_states, states[0])
                states = [states[0] * self.drop_states_mask] + \
                    list(states[1:])
        out, next_states = self.base_cell(inputs, states)
        if training and self.drop_outputs:
            if self.drop_outputs_mask is None:
                self.drop_outputs_mask = self._initialize_mask(
                    self.drop_outputs, out)
            out = out * self.drop_outputs_mask
        return out, next_states

    def extra_repr(self):
        return (f"p_in={self.drop_inputs}, p_state={self.drop_states}, "
                f"p_out={self.drop_outputs}")


class LSTMPCell(_BaseCell):
    """LSTM whose hidden state is projected to ``projection_size`` (ref:
    contrib/rnn/rnn_cell.py:198, arXiv:1402.1128). States: the projected
    hidden (N, projection_size) and the cell (N, hidden_size)."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None,
                 device=None):
        # h2h reads the projected state, so the weights are declared here
        RecurrentCell.__init__(self, prefix=prefix, params=params,
                               device=device)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,), init=i2h_bias_initializer)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,), init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0],
                                     4 * self._hidden_size)
        i, f, g, o = (i2h + h2h).chunk(4, dim=1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        hidden = torch.sigmoid(o) * torch.tanh(c)
        proj = F.fully_connected(hidden, self.h2r_weight.tensor,
                                 num_hidden=self._projection_size,
                                 no_bias=True)
        return proj, [proj, c]

    def extra_repr(self):
        return f"{self._hidden_size}, proj={self._projection_size}"
