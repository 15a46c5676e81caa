"""Gluon RNN cells (ref: the JAX package's ``gluon/rnn/rnn_cell.py``;
python/mxnet/gluon/rnn/rnn_cell.py).

A cell's ``forward(inputs, states)`` computes one time step on tensors
and returns ``(output, new_states)``. Called with NDArrays (the input, the
states or both), a cell takes and gives NDArrays, recorded while
``autograd.record()`` is on, as every Gluon block does; called with
tensors it is a plain module call. ``unroll`` steps the cell over a sequence (a
tensor or NDArray split along the layout's ``T``, or a list of steps) and
stacks the outputs with ``merge_outputs``. ``begin_state`` gives NDArray
zeros (``func=`` another creator) on the current context, as the JAX
package's does; ``unroll`` without ``begin_state`` starts from f32 zeros
on the input's device.

Parameters are declared with ``self.params.get`` as in the JAX package,
so ``cell.i2h_weight`` is the :class:`Parameter` record; ``input_size=0``
is read from the first input (``infer_shape_from_inputs``).
"""
from __future__ import annotations

import torch

from ... import autograd
from ...base import MXNetError, check
from ...ops import nn as F
from ..block import HybridBlock, has_ndarray, ndarray_call

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "BidirectionalCell",
           "ResidualCell", "ZoneoutCell"]


class RecurrentCell(HybridBlock):
    """Base of the cells (ref: rnn_cell.py RecurrentCell)."""

    def __init__(self, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self.reset()

    def reset(self):
        """Reset the step counters, this cell's and its children's."""
        self._init_counter = -1
        self._counter = -1
        for cell in self.children():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """NDArray zeros of each state's shape (``func(shape, **kwargs)``
        when given)."""
        from ... import ndarray as nd
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(func(info["shape"], **kwargs))
        return states

    def _zero_states(self, batch_size, device):
        """``begin_state`` as f32 tensors on ``device``."""
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(torch.zeros(info["shape"], device=device))
        return states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """(ref: rnn_cell.py BaseRNNCell.unroll) Outputs (a list, or
        stacked along ``T`` with ``merge_outputs``) and the last states;
        NDArrays when ``inputs`` or ``begin_state`` hold NDArrays."""
        def run(x, s):
            return self._unroll(length, x, s, layout, merge_outputs)
        if has_ndarray((inputs, begin_state)):
            return ndarray_call(run, (inputs, begin_state), {})
        return run(inputs, begin_state)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            seq = list(inputs)
            batch = seq[0].shape[0]
        else:
            batch = inputs.shape[layout.find("N")]
            check(inputs.shape[axis] == length,
                  f"unroll: {length} steps, but the input has "
                  f"{inputs.shape[axis]} along {layout}'s T")
            seq = list(inputs.unbind(axis))
        states = begin_state if begin_state is not None \
            else self._zero_states(batch, seq[0].device)
        outputs = []
        for i in range(length):
            out, states = self(seq[i], states)
            outputs.append(out)
        if merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, states


class _BaseCell(RecurrentCell):
    """The i2h / h2h weights and biases of a gated cell."""

    def __init__(self, hidden_size, num_gates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self._hidden_size = hidden_size
        g = num_gates
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(g * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(g * hidden_size, hidden_size),
            init=h2h_weight_initializer)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(g * hidden_size,),
            init=i2h_bias_initializer)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(g * hidden_size,),
            init=h2h_bias_initializer)

    def infer_shape_from_inputs(self, inputs, states=None):
        self.i2h_weight.shape_hint(
            (self.i2h_weight.shape[0], inputs.shape[-1]))

    def _projections(self, inputs, h, n):
        """``inputs`` W_i2h + b and ``h`` W_h2h + b, each ``n`` wide."""
        i2h = F.fully_connected(inputs, self.i2h_weight.tensor,
                                self.i2h_bias.tensor, num_hidden=n)
        h2h = F.fully_connected(h, self.h2h_weight.tensor,
                                self.h2h_bias.tensor, num_hidden=n)
        return i2h, h2h


class RNNCell(_BaseCell):
    """Elman cell: ``act(x W_i2h + b + h W_h2h + b)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0, **kw):
        super().__init__(hidden_size, 1, input_size, **kw)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0], self._hidden_size)
        out = F.activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_BaseCell):
    """LSTM cell, gates i, f, g, o."""

    def __init__(self, hidden_size, input_size=0, **kw):
        super().__init__(hidden_size, 4, input_size, **kw)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0],
                                     4 * self._hidden_size)
        i, f, g, o = (i2h + h2h).chunk(4, dim=1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        out = torch.sigmoid(o) * torch.tanh(c)
        return out, [out, c]


class GRUCell(_BaseCell):
    """GRU cell, gates r, z, n (``n`` from ``r * (h W_hn + b_hn)``)."""

    def __init__(self, hidden_size, input_size=0, **kw):
        super().__init__(hidden_size, 3, input_size, **kw)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def forward(self, inputs, states):
        prev = states[0]
        i2h, h2h = self._projections(inputs, prev, 3 * self._hidden_size)
        ir, iz, i_n = i2h.chunk(3, dim=1)
        hr, hz, hn = h2h.chunk(3, dim=1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(i_n + r * hn)
        out = (1 - z) * n + z * prev
        return out, [out]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input (ref:
    rnn_cell.py SequentialRNNCell)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        out = []
        for cell in self.children():
            out.extend(cell.state_info(batch_size))
        return out

    def begin_state(self, batch_size=0, **kwargs):
        out = []
        for cell in self.children():
            out.extend(cell.begin_state(batch_size=batch_size, **kwargs))
        return out

    def forward(self, inputs, states):
        next_states = []
        p = 0
        for cell in self.children():
            n = len(cell.state_info())
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self.children())[i]


class DropoutCell(RecurrentCell):
    """Dropout on the input in training; no state."""

    def __init__(self, rate, axes=(), **kw):
        super().__init__(**kw)
        self._rate = rate
        self._axes = tuple(axes)

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate > 0:
            inputs = F.dropout(inputs, p=self._rate, axes=self._axes,
                               _training=autograd.is_training())
        return inputs, states


class BidirectionalCell(RecurrentCell):
    """A left-to-right and a right-to-left cell over one sequence, outputs
    concatenated; ``unroll`` only."""

    def __init__(self, l_cell, r_cell, **kw):
        super().__init__(**kw)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return (self._modules["l_cell"].state_info(batch_size) +
                self._modules["r_cell"].state_info(batch_size))

    def begin_state(self, batch_size=0, **kwargs):
        return (self._modules["l_cell"].begin_state(batch_size=batch_size,
                                                    **kwargs) +
                self._modules["r_cell"].begin_state(batch_size=batch_size,
                                                    **kwargs))

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell supports only unroll()")

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs):
        l_cell = self._modules["l_cell"]
        r_cell = self._modules["r_cell"]
        if begin_state is None:
            first = inputs[0] if isinstance(inputs, (list, tuple)) \
                else inputs
            batch = first.shape[0] if isinstance(inputs, (list, tuple)) \
                else inputs.shape[layout.find("N")]
            begin_state = self._zero_states(batch, first.device)
        nl = len(l_cell.state_info())
        l_out, l_states = l_cell._unroll(length, inputs, begin_state[:nl],
                                         layout, False)
        rev = list(reversed(inputs)) if isinstance(inputs, (list, tuple)) \
            else inputs.flip(layout.find("T"))
        r_out, r_states = r_cell._unroll(length, rev, begin_state[nl:],
                                         layout, False)
        outputs = [torch.cat([l, r], dim=1)
                   for l, r in zip(l_out, reversed(r_out))]
        if merge_outputs:
            outputs = torch.stack(outputs, dim=layout.find("T"))
        return outputs, l_states + r_states


class _ModifierCell(RecurrentCell):
    """A cell around ``base_cell`` (a child module, so ``self.base_cell``
    reads it), with its states."""

    def __init__(self, base_cell, **kw):
        super().__init__(**kw)
        self.register_child(base_cell, "base_cell")

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size=batch_size, **kwargs)


class ResidualCell(_ModifierCell):
    """``base_cell``'s output plus its input."""

    def forward(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(_ModifierCell):
    """In training, each output and state unit keeps its previous value
    with probability ``zoneout_outputs`` / ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 **kw):
        super().__init__(base_cell, **kw)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def _keep_new(self, like, rate):
        return F.dropout(torch.ones_like(like), p=rate, _training=True) > 0

    def forward(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        if autograd.is_training():
            if self._zo > 0:
                prev = self._prev_output if self._prev_output is not None \
                    else torch.zeros_like(out)
                out = torch.where(self._keep_new(out, self._zo), out, prev)
            if self._zs > 0:
                next_states = [torch.where(self._keep_new(ns, self._zs), ns, s)
                               for ns, s in zip(next_states, states)]
        self._prev_output = out
        return out, next_states
