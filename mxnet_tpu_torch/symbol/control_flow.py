"""Symbolic control flow: ``foreach`` / ``while_loop`` / ``cond`` as graph
nodes (ref: the JAX package's ``symbol/control_flow.py``;
src/operator/control_flow.cc ``_foreach``, ``_while_loop``, ``_cond``).

The Python body is called once on proxy variables; the Symbol it returns
is stored on the node (``__subgraph__``, and ``__cf_else__`` for
``cond``'s second branch). Variables the body uses besides the proxies
(its weights, a BatchNorm's moving statistics) become inputs of the node,
so ``bind`` and ``simple_bind`` see them as arguments and aux states of
the enclosing graph. The executor (``executor._lower_control_flow``) runs
the node eagerly; ``tojson`` / ``load_json`` carry the bodies as embedded
JSON. Calling one of these ops imperatively raises: it runs only through
a bound executor (``mx.nd.contrib`` has the imperative versions).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

from ..base import MXNetError, check
from ..ops import registry as _reg
from ..ops.registry import register
from . import symbol as _sym

__all__ = ["foreach", "while_loop", "cond"]


def _cf_nout(n_inputs, params):
    return int(params.get("__num_outputs__", 1))


def _cf_stub(name):
    def fn(*a, **k):
        raise MXNetError(
            f"{name} is a symbolic control-flow op; execute it through a "
            "bound executor (sym.bind / Module), not imperatively")
    fn.__name__ = name
    return fn


for _name in ("_foreach", "_while_loop", "_cond"):
    register(_name, num_outputs=_cf_nout, variadic=True)(_cf_stub(_name))


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _free_vars(sub: _sym.Symbol, bound_names: set) -> List[str]:
    return [n for n in sub.list_arguments() + sub.list_auxiliary_states()
            if n not in bound_names]


def _free_var_syms(free: Sequence[str], subs: Sequence[_sym.Symbol]):
    """Outer-graph variables for the bodies' free names, keeping the aux
    marking (a BatchNorm's moving statistics in a body are aux states of
    the enclosing graph)."""
    aux = set()
    for s in subs:
        aux.update(s.list_auxiliary_states())
    out = []
    for n in free:
        v = _sym.var(n)
        if n in aux:
            v._outputs[0][0].extra["aux"] = True
        out.append(v)
    return out


def _make_node(op_name: str, attrs, input_syms, name):
    node = _sym._Node(_reg.get_op(op_name), name, attrs,
                      [s._outputs[0] for s in input_syms])
    return _sym.Symbol([(node, i) for i in range(node.num_outputs())])


def foreach(body: Callable, data, init_states, name: str = None):
    """Scan ``body`` over the leading axis of ``data`` (ref:
    control_flow.cc ``_foreach``). ``body(data_slice, states) -> (outs,
    new_states)``, all Symbols; returns ``(stacked_outs, final_states)``
    in the structure the body used."""
    name = name or _sym.new_node_name("foreach")
    datas = _as_list(data)
    states = _as_list(init_states)
    single_data = not isinstance(data, (list, tuple))
    single_state = not isinstance(init_states, (list, tuple))
    check(datas and all(isinstance(d, _sym.Symbol) for d in datas),
          "foreach: data must be Symbol(s)")
    slice_names = [f"{name}_in{i}" for i in range(len(datas))]
    state_names = [f"{name}_state{i}" for i in range(len(states))]
    slice_vars = [_sym.var(n) for n in slice_names]
    state_vars = [_sym.var(n) for n in state_names]
    out, new_states = body(
        slice_vars[0] if single_data else slice_vars,
        state_vars[0] if single_state else state_vars)
    single_out = not isinstance(out, (list, tuple))
    outs = _as_list(out)
    nstates = _as_list(new_states)
    check(len(nstates) == len(states),
          "foreach: body must return as many states as it was given")
    sub = _sym.Group([*outs, *nstates])
    free = _free_vars(sub, set(slice_names + state_names))
    attrs = {
        "__subgraph__": sub,
        "__cf_slice_names__": tuple(slice_names),
        "__cf_state_names__": tuple(state_names),
        "__cf_free_names__": tuple(free),
        "__cf_n_out__": len(outs),
        "__num_outputs__": len(outs) + len(states),
    }
    res = _make_node("_foreach", attrs,
                     datas + states + _free_var_syms(free, [sub]), name)
    stacked = [res[i] for i in range(len(outs))]
    finals = [res[len(outs) + i] for i in range(len(states))]
    return (stacked[0] if single_out else stacked), \
        (finals[0] if single_state else finals)


def while_loop(cond_fn: Callable, func: Callable, loop_vars,
               max_iterations: int, name: str = None):
    """A bounded while loop (ref: control_flow.cc ``_while_loop``).
    ``func(*loop_vars) -> (step_outputs, new_loop_vars)``; the step
    outputs land in buffers of ``max_iterations`` rows, zeros after the
    last step. Returns ``(buffered_outputs, final_loop_vars)``."""
    name = name or _sym.new_node_name("while_loop")
    check(max_iterations and max_iterations > 0,
          "while_loop requires max_iterations")
    single_var = not isinstance(loop_vars, (list, tuple))
    lvars = _as_list(loop_vars)
    var_names = [f"{name}_var{i}" for i in range(len(lvars))]
    var_syms = [_sym.var(n) for n in var_names]
    pred = cond_fn(*var_syms)
    outs, new_vars = func(*var_syms)
    outs = _as_list(outs)
    nvars = _as_list(new_vars)
    check(len(nvars) == len(lvars),
          "while_loop: func must return as many loop vars as it was given")
    sub = _sym.Group([pred, *outs, *nvars])
    free = _free_vars(sub, set(var_names))
    attrs = {
        "__subgraph__": sub,
        "__cf_state_names__": tuple(var_names),
        "__cf_free_names__": tuple(free),
        "__cf_n_out__": len(outs),
        "__cf_max_iter__": int(max_iterations),
        "__num_outputs__": len(outs) + len(lvars),
    }
    res = _make_node("_while_loop", attrs,
                     lvars + _free_var_syms(free, [sub]), name)
    buffered = [res[i] for i in range(len(outs))]
    finals = [res[len(outs) + i] for i in range(len(lvars))]
    return (buffered[0] if len(buffered) == 1 else buffered), \
        (finals[0] if single_var else finals)


def cond(pred, then_func: Callable, else_func: Callable, inputs=None,
         name: str = None):
    """Symbolic if / else (ref: control_flow.cc ``_cond``): both branches
    are called on the same proxy inputs and must give as many outputs;
    the executor runs the one the predicate picks."""
    name = name or _sym.new_node_name("cond")
    check(isinstance(pred, _sym.Symbol), "cond: pred must be a Symbol")
    ins = _as_list(inputs)
    in_names = [f"{name}_in{i}" for i in range(len(ins))]
    in_syms = [_sym.var(n) for n in in_names]
    then_out = _as_list(then_func(*in_syms) if ins else then_func())
    else_out = _as_list(else_func(*in_syms) if ins else else_func())
    check(len(then_out) == len(else_out),
          "cond: branches must produce the same number of outputs")
    sub_then = _sym.Group(then_out)
    sub_else = _sym.Group(else_out)
    bound = set(in_names)
    free = sorted(set(_free_vars(sub_then, bound))
                  | set(_free_vars(sub_else, bound)))
    attrs = {
        "__subgraph__": sub_then,
        "__cf_else__": sub_else,
        "__cf_in_names__": tuple(in_names),
        "__cf_free_names__": tuple(free),
        "__cf_n_out__": len(then_out),
        "__num_outputs__": len(then_out),
    }
    return _make_node("_cond", attrs,
                      [pred] + ins + _free_var_syms(free, [sub_then,
                                                           sub_else]),
                      name)
