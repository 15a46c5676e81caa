"""The fused multi-layer RNN op (ref: the JAX package's ``ops/rnn_op.py``;
src/operator/rnn.cc and rnn-inl.h in the reference).

Modes ``rnn_relu``, ``rnn_tanh``, ``lstm`` and ``gru``, any number of
layers, one-way or bidirectional, over one flat parameter vector packed
as the reference packs it: every layer's and direction's weights, then
every one's biases, layer-major and direction-minor, gates LSTM i, f, g,
o and GRU r, z, n (``rnn_param_size``, ``unpack``). A checkpoint of
either package shape-matches.

The JAX op's time loop is ``lax.scan``; here it is a Python loop in the
same structure: one input projection for the whole sequence of each
layer and direction, then per time step one recurrent matmul and the
cell's arithmetic. The reverse direction walks the projected sequence
from its end and returns the state after time step 0. Between layers,
and only in training, dropout with rate ``p`` draws its mask from the
``generator`` it is given, else the device's default generator (a CUDA
graph replays new masks from it); the recompute of a checkpointed
forward (``util.replayed``) takes the forward's masks.

Dtypes follow JAX's promotion: ``_state_zeros`` / ``_rnn_state_zeros``
give f32 states, and bf16 data with f32 states computes the recurrence,
the outputs and the final states in f32.

``projection_size``, ``lstm_state_clip_min`` / ``_max`` / ``_nan`` and
``use_sequence_length`` are taken and ignored, as the JAX op ignores
them.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..base import check
from ..random import default_generator
from ..util import replayed
from .registry import register

__all__ = ["rnn", "run_layers", "rnn_param_size", "unpack",
           "layer_weights"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


@register("_state_zeros")
def _state_zeros(x, num_hidden=1, batch_axis=0):
    """Zero cell state ``(batch, num_hidden)`` f32, its batch read from a
    data symbol (keeps symbolic shape inference forward-only)."""
    return torch.zeros((x.shape[int(batch_axis)], int(num_hidden)),
                       dtype=torch.float32, device=x.device)


@register("_rnn_state_zeros")
def _rnn_state_zeros(x, num_states=1, state_size=1):
    """Zero fused-RNN state ``(L * D, N, H)`` f32 from TNC data."""
    return torch.zeros((int(num_states), x.shape[1], int(state_size)),
                       dtype=torch.float32, device=x.device)


def rnn_param_size(num_layers: int, input_size: int, state_size: int,
                   bidirectional: bool, mode: str) -> int:
    """Total packed parameter count (ref: rnn-inl.h GetRnnParamSize)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * g * state_size * (in_sz + state_size + 2)
    return size


def layer_weights(num_layers, input_size, state_size, bidirectional,
                  mode) -> List[Tuple[Tuple[int, ...], ...]]:
    """``(offset, shape)`` of each (W, R, bW, bR) of each (layer,
    direction) in the flat vector: weights first, then biases."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    out = []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * d
        for _ in range(d):
            w = (off, (g * h, in_sz))
            off += g * h * in_sz
            r = (off, (g * h, h))
            off += g * h * h
            out.append([w, r, None, None])
    for item in out:
        item[2] = (off, (g * h,))
        off += g * h
        item[3] = (off, (g * h,))
        off += g * h
    return [tuple(item) for item in out]


def unpack(params, num_layers, input_size, state_size, bidirectional,
           mode) -> List[Tuple[torch.Tensor, ...]]:
    """The flat vector as per-(layer, direction) (W, R, bW, bR) views."""
    n = rnn_param_size(num_layers, input_size, state_size, bidirectional,
                       mode)
    check(params.numel() == n,
          f"RNN: parameters has {params.numel()} elements, the {mode} "
          f"configuration needs {n}")
    return [tuple(params[o:o + _numel(s)].reshape(s) for o, s in item)
            for item in layer_weights(num_layers, input_size, state_size,
                                      bidirectional, mode)]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _promote(*ts) -> torch.dtype:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _run_layer(mode, x, w, r, bw, br, h0, c0, reverse):
    """One direction of one layer over the whole sequence. x: (T, N, I)
    -> (T, N, H), the last h and c."""
    t_len, n, i_sz = x.shape
    dx = _promote(x, w, bw)
    # one input projection for the whole sequence
    x_proj = torch.addmm(bw.to(dx), x.reshape(-1, i_sz).to(dx),
                         w.to(dx).t()).reshape(t_len, n, -1)
    # the recurrence runs in JAX's promoted dtype (f32 states promote
    # bf16 data)
    dt = _promote(x_proj, h0, r, br)
    rt = r.to(dt).t()
    h, c = h0.to(dt), c0
    if mode == "gru":
        xs, hb = x_proj.to(dt), br.to(dt)
    else:
        xs = x_proj.to(dt) + br.to(dt)
        if mode == "lstm":
            c = c0.to(dt)
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    ys = []
    for t in steps:
        if mode == "gru":
            hr, hz, hn = torch.addmm(hb, h, rt).chunk(3, 1)
            xr, xz, xn = xs[t].chunk(3, 1)
            rg = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            nn_ = torch.tanh(xn + rg * hn)
            h = (1 - z) * nn_ + z * h
        else:
            gates = torch.addmm(xs[t], h, rt)
            if mode == "rnn_relu":
                h = torch.relu(gates)
            elif mode == "rnn_tanh":
                h = torch.tanh(gates)
            else:
                i, f, g, o = gates.chunk(4, 1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    if reverse:
        ys.reverse()
    return torch.stack(ys), h, c


def run_layers(data, layers: Sequence[Tuple[torch.Tensor, ...]], state,
               state_cell, mode, bidirectional, p=0.0, training=False,
               generator=None):
    """The fused RNN over per-(layer, direction) ``(W, R, bW, bR)``
    (``unpack``'s order): ``data`` (T, N, I), ``state`` (L * D, N, H),
    ``state_cell`` the LSTM cell state (else ignored). Returns (out,
    h, c); ``c`` is the initial zeros for the modes without a cell."""
    check(mode in _GATES, f"unknown RNN mode {mode}")
    d = 2 if bidirectional else 1
    num_layers = len(layers) // d
    x = data
    h_states: List[torch.Tensor] = []
    c_states: List[torch.Tensor] = []
    for layer in range(num_layers):
        outs = []
        for direction in range(d):
            idx = layer * d + direction
            w, r, bw, br = layers[idx]
            h0 = state[idx]
            c0 = state_cell[idx] if mode == "lstm" else torch.zeros_like(h0)
            ys, h_last, c_last = _run_layer(mode, x, w, r, bw, br, h0, c0,
                                            reverse=direction == 1)
            outs.append(ys)
            h_states.append(h_last)
            c_states.append(c_last)
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if p > 0 and training and layer < num_layers - 1:
            keep = 1.0 - p
            gen = generator if generator is not None \
                else default_generator(x.device)
            mask = replayed(lambda: (torch.rand(x.shape, generator=gen,
                                                device=x.device) < keep)
                            .to(x.dtype))
            x = x * mask / keep
    return x, torch.stack(h_states), torch.stack(c_states)


def _rnn_nout(n_inputs, params):
    if not params.get("state_outputs", False):
        return 1
    return 3 if params.get("mode", "lstm") == "lstm" else 2


@register("RNN", num_outputs=_rnn_nout, rng=True)
def rnn(data, parameters, state, *maybe_cell, state_size=0, num_layers=1,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
        projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        use_sequence_length=False, _training=False, generator=None):
    """Fused RNN (ref: src/operator/rnn.cc registration): data (T, N, I),
    the flat ``parameters``, state (L * D, N, H), and for ``lstm`` the
    cell state after it. Returns out (T, N, D * H), with
    ``state_outputs`` also h (and c for ``lstm``)."""
    check(mode in _GATES, f"unknown RNN mode {mode}")
    bidirectional = bool(bidirectional)
    layers = unpack(parameters, int(num_layers), data.shape[2],
                    int(state_size), bidirectional, mode)
    state_cell = maybe_cell[0] if mode == "lstm" and maybe_cell \
        else torch.zeros_like(state)
    out, h, c = run_layers(data, layers, state, state_cell, mode,
                           bidirectional, float(p), bool(_training),
                           generator)
    if not state_outputs:
        return out
    if mode == "lstm":
        return out, h, c
    return out, h
