"""Imperative control flow: ``foreach`` / ``while_loop`` / ``cond`` over
NDArrays (ref: the JAX package's ``contrib/control_flow.py``;
src/operator/control_flow.cc ``_foreach``, ``_while_loop``, ``_cond`` and
python/mxnet/ndarray/contrib.py).

The JAX package traces the body into ``lax.scan`` / ``lax.cond`` and
records the construct as one tape node whose backward is ``jax.vjp``,
finding the NDArrays the body closes over with a probe run
(``autograd.capture``). Here the body runs eagerly: ``foreach`` is a
Python loop over the data's leading axis that stacks the step outputs,
``while_loop`` a loop that reads its predicate on the host before each
step (one device sync a step on the card) and pads the step outputs with
zeros to ``max_iterations`` rows, as the JAX package's masked scan gives
them, and ``cond`` reads its predicate on the host once (a device sync
on the card) and runs the taken branch only. Under ``autograd.record()``
torch autograd records every op of every step, so gradients reach the
inputs and whatever NDArrays the body closes over, with no probe.
"""
from __future__ import annotations

from typing import Callable

from ..base import check

__all__ = ["foreach", "while_loop", "cond"]


def _nd():
    from ..ndarray import ndarray as nd
    return nd


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _host_bool(x) -> bool:
    """A predicate's value on the host (a device sync for a card
    array)."""
    if isinstance(x, _nd().NDArray):
        return bool(x._data.reshape(()).item())
    return bool(x)


def foreach(body: Callable, data, init_states):
    """Run ``body`` over the leading axis of ``data`` (ref:
    mx.nd.contrib.foreach). ``body(item, states) -> (out, new_states)``;
    returns ``(stacked_outs, final_states)`` in the structure given."""
    nd = _nd()
    single_data = not isinstance(data, (list, tuple))
    datas = _as_list(data)
    single_state = not isinstance(init_states, (list, tuple))
    states = _as_list(init_states)
    steps = datas[0].shape[0]
    check(steps > 0, "foreach over an empty axis")
    stacked = None
    for t in range(steps):
        items = [d[t] for d in datas]
        out, new_states = body(items[0] if single_data else items,
                               states[0] if single_state else states)
        outs = _as_list(out)
        if stacked is None:
            stacked = [[] for _ in outs]
        for acc, o in zip(stacked, outs):
            acc.append(o)
        states = _as_list(new_states)
    outs = [nd.stack(*acc, axis=0) for acc in stacked]
    return (outs[0] if len(outs) == 1 else outs), \
        (states[0] if single_state else states)


def while_loop(cond_fn: Callable, func: Callable, loop_vars,
               max_iterations: int):
    """A bounded while loop (ref: mx.nd.contrib.while_loop). While
    ``cond_fn(*loop_vars)`` holds and fewer than ``max_iterations`` steps
    ran, ``func(*loop_vars) -> (step_output(s), new_loop_vars)``. Returns
    the step outputs stacked into ``max_iterations`` rows (zeros after the
    last step) and the final loop vars."""
    nd = _nd()
    check(max_iterations is not None and max_iterations > 0,
          "while_loop requires max_iterations")
    single_var = not isinstance(loop_vars, (list, tuple))
    lvars = _as_list(loop_vars)
    steps, outs = [], None
    while len(steps) < max_iterations and _host_bool(cond_fn(*lvars)):
        outs, new_vars = func(*lvars)
        outs = _as_list(outs)
        steps.append(outs)
        lvars = _as_list(new_vars)
    if not steps:
        # no step ran: the step outputs' shapes from one call, kept out
        # of the record
        from .. import autograd
        with autograd.pause():
            outs = _as_list(func(*lvars)[0])
    bufs = []
    for i, o in enumerate(outs):
        parts = [nd.stack(*[s[i] for s in steps], axis=0)] if steps else []
        if len(steps) < max_iterations:
            parts.append(nd.zeros((max_iterations - len(steps),) + o.shape,
                                  ctx=o.context, dtype=o.dtype))
        bufs.append(parts[0] if len(parts) == 1
                    else nd.concatenate(parts, axis=0))
    return (bufs[0] if len(bufs) == 1 else bufs), \
        (lvars[0] if single_var else lvars)


def cond(pred, then_func: Callable, else_func: Callable, inputs=None):
    """Run ``then_func()`` if ``pred`` holds, else ``else_func()`` (ref:
    mx.nd.contrib.cond); the branches are closures over NDArrays. The
    predicate is read on the host once."""
    out = then_func() if _host_bool(pred) else else_func()
    outs = _as_list(out)
    return outs[0] if len(outs) == 1 else outs
