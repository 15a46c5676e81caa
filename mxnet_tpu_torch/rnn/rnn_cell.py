"""Symbol-era RNN cells (ref: the JAX package's ``rnn/rnn_cell.py``;
python/mxnet/rnn/rnn_cell.py).

These build ``mx.sym`` graphs, bound through the port's Executor; each
cell creates its weight variables on first use and ``unroll`` composes
the time steps. ``FusedRNNCell`` emits one ``RNN`` node over a flat
``parameters`` variable, as the reference's cuDNN cell does.
"""
from __future__ import annotations

from typing import List

from ..base import check
from .. import symbol as sym

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell"]


class BaseRNNCell:
    def __init__(self, prefix="", params=None):
        self._prefix = prefix
        self._counter = 0
        self._init_counter = 0
        self._own_vars = {}

    def _var(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._own_vars:
            self._own_vars[full] = sym.var(full, **kwargs)
        return self._own_vars[full]

    @property
    def state_info(self):
        raise NotImplementedError

    def begin_state(self, func=sym.var, like=None, **kwargs):
        """Default zero states. With ``like`` (a data symbol), states are
        `_state_zeros` ops so shape inference stays forward-only; otherwise
        plain variables the caller must bind."""
        states = []
        for i, info in enumerate(self.state_info):
            if like is not None:
                shape = info["shape"]
                if len(shape) == 2:
                    s = sym.op._state_zeros(like, num_hidden=shape[1])
                else:
                    s = sym.op._rnn_state_zeros(like, num_states=shape[0],
                                                state_size=shape[2])
                states.append(s)
            else:
                states.append(
                    func(f"{self._prefix}begin_state_"
                         f"{self._init_counter}_{i}", **kwargs))
            self._init_counter += 1
        return states

    def __call__(self, inputs, states):
        raise NotImplementedError

    def reset(self):
        self._counter = 0

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        """(ref: rnn_cell.py BaseRNNCell.unroll)"""
        self.reset()
        if inputs is None:
            inputs = [sym.var(f"{input_prefix}t{i}_data")
                      for i in range(length)]
        elif isinstance(inputs, sym.Symbol):
            axis = layout.find("T")
            inputs = list(sym.split(inputs, num_outputs=length, axis=axis,
                                    squeeze_axis=True))
        if begin_state is None:
            begin_state = self.begin_state(like=inputs[0])
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(inputs[i], states)
            outputs.append(out)
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=layout.find("T"))
        return outputs, states


class RNNCell(BaseRNNCell):
    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._activation = activation

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(inputs, self._var("i2h_weight"),
                                 self._var("i2h_bias"),
                                 num_hidden=self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(states[0], self._var("h2h_weight"),
                                 self._var("h2h_bias"),
                                 num_hidden=self._num_hidden,
                                 name=f"{name}h2h")
        out = sym.Activation(i2h + h2h, act_type=self._activation,
                             name=f"{name}out")
        return out, [out]


class LSTMCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        h = self._num_hidden
        i2h = sym.FullyConnected(inputs, self._var("i2h_weight"),
                                 self._var("i2h_bias"), num_hidden=4 * h,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(states[0], self._var("h2h_weight"),
                                 self._var("h2h_bias"), num_hidden=4 * h,
                                 name=f"{name}h2h")
        gates = i2h + h2h
        slices = list(sym.split(gates, num_outputs=4, axis=1))
        i = sym.sigmoid(slices[0])
        f = sym.sigmoid(slices[1])
        g = sym.tanh(slices[2])
        o = sym.sigmoid(slices[3])
        c = f * states[1] + i * g
        out = o * sym.tanh(c)
        return out, [out, c]


class GRUCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        h = self._num_hidden
        i2h = sym.FullyConnected(inputs, self._var("i2h_weight"),
                                 self._var("i2h_bias"), num_hidden=3 * h,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(states[0], self._var("h2h_weight"),
                                 self._var("h2h_bias"), num_hidden=3 * h,
                                 name=f"{name}h2h")
        i2h_s = list(sym.split(i2h, num_outputs=3, axis=1))
        h2h_s = list(sym.split(h2h, num_outputs=3, axis=1))
        r = sym.sigmoid(i2h_s[0] + h2h_s[0])
        z = sym.sigmoid(i2h_s[1] + h2h_s[1])
        n = sym.tanh(i2h_s[2] + r * h2h_s[2])
        out = (1 - z) * n + z * states[0]
        return out, [out]


class FusedRNNCell(BaseRNNCell):
    """Maps to the fused RNN op (ref: rnn_cell.py FusedRNNCell/cuDNN)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 prefix=None, params=None):
        super().__init__(prefix if prefix is not None else f"{mode}_", params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state

    @property
    def state_info(self):
        d = 2 if self._bidirectional else 1
        shape = (self._num_layers * d, 0, self._num_hidden)
        if self._mode == "lstm":
            return [{"shape": shape}, {"shape": shape}]
        return [{"shape": shape}]

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        check(isinstance(inputs, sym.Symbol),
              "FusedRNNCell.unroll requires a single Symbol input")
        x = inputs
        if layout == "NTC":
            x = sym.swapaxes(x, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state(like=x)
        params = self._var("parameters")
        args = [x, params, begin_state[0]]
        if self._mode == "lstm":
            args.append(begin_state[1])
        outs = sym.RNN(*args, state_size=self._num_hidden,
                       num_layers=self._num_layers, mode=self._mode,
                       bidirectional=self._bidirectional, p=self._dropout,
                       state_outputs=self._get_next_state,
                       name=f"{self._prefix}rnn")
        if self._get_next_state:
            outs_list = list(outs)
            out = outs_list[0]
            states = outs_list[1:]
        else:
            out = outs if isinstance(outs, sym.Symbol) and len(outs) == 1 \
                else outs[0]
            states = []
        if layout == "NTC":
            out = sym.swapaxes(out, dim1=0, dim2=1)
        return out, states


class SequentialRNNCell(BaseRNNCell):
    def __init__(self, params=None):
        super().__init__("")
        self._cells: List[BaseRNNCell] = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        out = []
        for c in self._cells:
            out.extend(c.state_info)
        return out

    def begin_state(self, **kwargs):
        out = []
        for c in self._cells:
            out.extend(c.begin_state(**kwargs))
        return out

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = sym.Dropout(inputs, p=self._dropout)
        return inputs, states


class BidirectionalCell(BaseRNNCell):
    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(output_prefix)
        self._l = l_cell
        self._r = r_cell

    @property
    def state_info(self):
        return self._l.state_info + self._r.state_info

    def begin_state(self, **kwargs):
        return self._l.begin_state(**kwargs) + self._r.begin_state(**kwargs)

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        if begin_state is None:
            begin_state = self.begin_state()
        nl = len(self._l.state_info)
        l_out, l_states = self._l.unroll(length, inputs, begin_state[:nl],
                                         input_prefix, layout, False)
        if isinstance(inputs, sym.Symbol):
            axis = layout.find("T")
            seq = list(sym.split(inputs, num_outputs=length, axis=axis,
                                 squeeze_axis=True))
        else:
            seq = list(inputs)
        r_out, r_states = self._r.unroll(length, list(reversed(seq)),
                                         begin_state[nl:], input_prefix,
                                         layout, False)
        r_out = list(reversed(r_out))
        outputs = [sym.concat(l, r, dim=1, num_args=2)
                   for l, r in zip(l_out, r_out)]
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=layout.find("T"))
        return outputs, l_states + r_states


class ZoneoutCell(BaseRNNCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__("zoneout_")
        self.base_cell = base_cell
        self._zo = zoneout_outputs
        self._zs = zoneout_states

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)

    def __call__(self, inputs, states):
        return self.base_cell(inputs, states)


class ResidualCell(BaseRNNCell):
    def __init__(self, base_cell):
        super().__init__("residual_")
        self.base_cell = base_cell

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states
