"""Executor: bind a Symbol and run it over tensors (ref: the JAX package's
``symbol/executor.py``; src/executor/graph_executor.cc and
include/mxnet/executor.h).

:func:`_walk` evaluates the DAG op by op on tensors, in topological
order: every node is the registry op ``mx.nd`` runs, ops that act
differently in training get ``_training``, random ops draw from their
device's default generator (``mx.random.seed``). In a training walk the
BatchNorm nodes' moving statistics are blended as the reference's ops do
(``AUX_UPDATERS``) and handed back to the caller.

:class:`Executor` keeps the reference's surface: ``bind`` /
``simple_bind``, ``forward(is_train)``, ``backward(out_grads)``,
``outputs``, ``arg_dict`` / ``grad_dict`` / ``aux_dict``, ``reshape``
sharing the parameter arrays, and the monitor callback. A training
forward records the walk with torch autograd (the aux states are written
then, as a side effect of the forward, the reference's contract) and
``backward`` differentiates that record; head gradients default to ones.

The moving statistics of the fused BN ops (``_contrib_fused_bn_relu``,
``_contrib_fused_bn_add_relu``, the nodes ``HybridBlock.export`` writes
for ``gluon.nn.FusedBatchNorm*ReLU``) are blended too, as Gluon's fused
blocks blend them; the JAX package's executor knows only ``BatchNorm``
and leaves them as they were (ROADMAP, faults of the JAX package).

Control-flow nodes (``control_flow.py``) run eagerly
(:func:`_lower_control_flow`): ``_foreach`` a Python loop over the data's
leading axis that stacks the step outputs, ``_while_loop`` a loop that
reads its predicate on the host each step (one device sync a step) and
pads the step outputs to ``max_iterations``, ``_cond`` a predicate read
on the host and the taken branch only. Torch autograd records them like
any other op. The moving statistics of a BatchNorm inside a body are
carried from step to step and come out as the node's aux updates. A
``_subgraph`` node (``subgraph.py``) walks its sub-Symbol inline with the
enclosing walk's mode and aux states.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional

import numpy as _np
import torch

from ..base import MXNetError, check
from ..context import current_context
from ..ndarray import ndarray as _nd
from .symbol import CONTROL_FLOW_OPS, node_params

__all__ = ["Executor", "eval_symbol", "walk_inputs"]


def _bn_aux_blend(mean_slot: int) -> Callable:
    """The moving-statistic blend of a training BatchNorm whose moving
    mean and variance are inputs ``mean_slot`` and ``mean_slot + 1`` (ref:
    the in-op updates of src/operator/nn/batch_norm.cc; Gluon's
    ``BatchNorm._update_running_stats``)."""
    def update(in_arrays, out_arrays, params):
        momentum = float(params.get("momentum", 0.9))
        if bool(params.get("use_global_stats", False)):
            return {}
        _, mean, var = out_arrays
        mm, mv = in_arrays[mean_slot], in_arrays[mean_slot + 1]
        return {mean_slot: mm * momentum + mean.detach() * (1 - momentum),
                mean_slot + 1: mv * momentum
                + var.detach() * (1 - momentum)}
    return update


_bn_aux_update = _bn_aux_blend(3)
AUX_UPDATERS: Dict[str, Callable] = {
    "BatchNorm": _bn_aux_update,
    "_contrib_fused_bn_relu": _bn_aux_update,
    "_contrib_fused_bn_add_relu": _bn_aux_blend(4)}
_TAKES_TRAINING: Dict[int, bool] = {}


def _takes_training(opdef) -> bool:
    v = _TAKES_TRAINING.get(id(opdef))
    if v is None:
        try:
            v = "_training" in inspect.signature(opdef.fn).parameters
        except (TypeError, ValueError):
            v = False
        _TAKES_TRAINING[id(opdef)] = v
    return v


def _lower_control_flow(node, ins, is_train, collect_aux=None):
    """The outputs of a control-flow node (``control_flow.py``) from its
    inputs, run eagerly (ref: the JAX package's ``_lower_control_flow``,
    there ``lax.scan`` / ``lax.while_loop`` / ``lax.cond``). The final
    values of aux states used in a body (BatchNorm moving statistics) go
    to ``collect_aux``."""
    sub = node.attrs["__subgraph__"]
    free_names = node.attrs["__cf_free_names__"]
    n_out = node.attrs["__cf_n_out__"]
    # free variables marked aux route through the body walk's aux_map
    aux_names = set(sub.list_auxiliary_states())
    if "__cf_else__" in node.attrs:
        aux_names |= set(node.attrs["__cf_else__"].list_auxiliary_states())
    aux_free = [n for n in free_names if n in aux_names]

    def split(values):
        frees = dict(zip(free_names, values))
        return ({k: v for k, v in frees.items() if k not in aux_names},
                [frees[n] for n in aux_free])

    def run(body, bound, au):
        m = dict(frees)
        m.update(bound)
        am = dict(zip(aux_free, au))
        coll = {}
        res = _walk(body, m, am, is_train,
                    collect_aux=coll if is_train else None)
        return res, [coll.get(n, am[n]) for n in aux_free]

    def publish(values):
        if collect_aux is not None:
            collect_aux.update(zip(aux_free, values))

    op = node.op.name
    if op == "_foreach":
        slice_names = node.attrs["__cf_slice_names__"]
        state_names = node.attrs["__cf_state_names__"]
        n_d, n_s = len(slice_names), len(state_names)
        datas, states = ins[:n_d], list(ins[n_d:n_d + n_s])
        frees, au = split(ins[n_d + n_s:])
        steps = datas[0].shape[0]
        check(steps > 0, f"{node.name}: foreach over an empty axis")
        stacked = [[] for _ in range(n_out)]
        for t in range(steps):
            bound = dict(zip(slice_names, [d[t] for d in datas]))
            bound.update(zip(state_names, states))
            res, au = run(sub, bound, au)
            for acc, o in zip(stacked, res[:n_out]):
                acc.append(o)
            states = res[n_out:]
        publish(au)
        return [torch.stack(acc) for acc in stacked] + list(states)

    if op == "_while_loop":
        state_names = node.attrs["__cf_state_names__"]
        max_iter = node.attrs["__cf_max_iter__"]
        n_s = len(state_names)
        vars_ = list(ins[:n_s])
        frees, au = split(ins[n_s:])
        steps = []
        while len(steps) < max_iter:
            res, new_au = run(sub, dict(zip(state_names, vars_)), au)
            if not bool(res[0].reshape(())):   # the host reads it
                break
            steps.append(res[1:1 + n_out])
            vars_, au = res[1 + n_out:], new_au
        publish(au)
        # step outputs land in max_iterations buffers, zeros after the
        # last step the predicate allowed (the JAX package's shapes)
        bufs = []
        for i, o in enumerate(res[1:1 + n_out]):
            pad = o.new_zeros((max_iter - len(steps),) + tuple(o.shape))
            bufs.append(torch.cat([torch.stack([s[i] for s in steps]),
                                   pad]) if steps else pad)
        return bufs + list(vars_)

    # _cond: the predicate is read on the host; only the taken branch runs
    in_names = node.attrs["__cf_in_names__"]
    n_i = len(in_names)
    frees, au = split(ins[1 + n_i:])
    body = sub if bool(ins[0].reshape(())) else node.attrs["__cf_else__"]
    res, au = run(body, dict(zip(in_names, ins[1:1 + n_i])), au)
    publish(au)
    return list(res[:n_out])


def _walk_subgraph(node, ins, is_train, collect_aux):
    """A ``_subgraph`` node inline, in this walk's mode; the aux updates
    of its region go back under the outer graph's variable names."""
    sub = node.attrs["__subgraph__"]
    in_names = tuple(node.attrs["__subgraph_inputs__"])
    inner = {} if collect_aux is not None else None
    outs = _walk(sub, dict(zip(in_names, ins)), {}, is_train,
                 collect_aux=inner)
    for pname, val in (inner or {}).items():
        if pname in in_names:
            pname = node.inputs[in_names.index(pname)][0].name
        collect_aux[pname] = val
    return outs


def _walk(symbol, arg_map: Dict[str, Any], aux_map: Dict[str, Any],
          is_train: bool, collect_aux: Optional[dict] = None):
    """The symbol's outputs from tensors of its arguments and aux states;
    ``collect_aux`` receives the new aux values of a training walk."""
    cache: Dict[tuple, Any] = {}
    for node in symbol._topo():
        if node.is_variable:
            name = node.name
            if node.extra.get("aux", False):
                check(name in aux_map, f"missing aux state {name}")
                cache[(id(node), 0)] = aux_map[name]
            else:
                check(name in arg_map, f"missing argument {name}")
                cache[(id(node), 0)] = arg_map[name]
            continue
        ins = [cache[(id(i), k)] for i, k in node.inputs]
        if node.op.name in CONTROL_FLOW_OPS:
            outs = _lower_control_flow(node, ins, is_train,
                                       collect_aux=collect_aux)
        elif node.op.name == "_subgraph":
            outs = _walk_subgraph(node, ins, is_train, collect_aux)
        else:
            params = node_params(node)
            if _takes_training(node.op):
                params["_training"] = is_train
            out = node.op.fn(*ins, **params)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if is_train and collect_aux is not None and \
                    node.op.name in AUX_UPDATERS:
                for slot, val in AUX_UPDATERS[node.op.name](
                        ins, outs, params).items():
                    collect_aux[node.inputs[slot][0].name] = val
        for i, o in enumerate(outs):
            cache[(id(node), i)] = o
    return [cache[(id(n), i)] for n, i in symbol._outputs]


def walk_inputs(symbol, input_names, inputs, params):
    """The outputs of ``symbol`` (inference) from tensors: its inputs by
    position, its other variables by name; SymbolBlock's forward."""
    aux_names = set(symbol.list_auxiliary_states())
    arg_map = dict(zip(input_names, inputs))
    aux_map = {}
    for k, v in params.items():
        (aux_map if k in aux_names else arg_map)[k] = v
    outs = _walk(symbol, arg_map, aux_map, False)
    return outs[0] if len(outs) == 1 else outs


def eval_symbol(symbol, input_names, input_arrays, param_arrays):
    """The JAX package's ``eval_symbol``: NDArrays in (inputs by position,
    parameters by name), NDArrays out, inference mode."""
    with torch.no_grad():
        outs = walk_inputs(symbol, input_names,
                           [a._data for a in input_arrays],
                           {k: v._data for k, v in param_arrays.items()})
    if isinstance(outs, torch.Tensor):
        return _nd.NDArray(outs)
    return [_nd.NDArray(o) for o in outs]


def _as_nd(v, ctx):
    if isinstance(v, _nd.NDArray):
        return v
    return _nd.array(_np.asarray(v), ctx=ctx)


class Executor:
    """A bound symbol (ref: include/mxnet/executor.h)."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, group2ctx=None):
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        self._group2ctx = group2ctx or {}
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._out_names = symbol.list_outputs()
        self.arg_dict: Dict[str, _nd.NDArray] = self._index(
            args, self._arg_names, "argument")
        self.aux_dict: Dict[str, _nd.NDArray] = self._index(
            aux_states, self._aux_names, "aux state")
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self._arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self._arg_names}
        self.grad_dict: Dict[str, _nd.NDArray] = {}
        if args_grad is not None:
            self.grad_dict = self._index(args_grad, self._arg_names,
                                         "gradient", allow_missing=True)
        else:
            for n in self._arg_names:
                if self._grad_req.get(n, "null") != "null" and \
                        n in self.arg_dict:
                    a = self.arg_dict[n]
                    self.grad_dict[n] = _nd.NDArray(torch.zeros_like(
                        a._data))
        self._grad_names = [n for n in self._arg_names
                            if self._grad_req.get(n, "null") != "null"]
        self._outputs: Optional[List[_nd.NDArray]] = None
        self._pending = None
        self._monitor_callback = None

    # -- construction helpers ------------------------------------------
    def _index(self, arrays, names, what, allow_missing=False):
        out: Dict[str, _nd.NDArray] = {}
        if arrays is None:
            return out
        if isinstance(arrays, dict):
            for k, v in arrays.items():
                if k in names:
                    out[k] = _as_nd(v, self._ctx)
        else:
            check(len(arrays) == len(names) or allow_missing,
                  f"expected {len(names)} {what}s, got {len(arrays)}")
            for k, v in zip(names, arrays):
                if v is not None:
                    out[k] = _as_nd(v, self._ctx)
        return out

    @staticmethod
    def simple_bind(symbol, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """Allocate every array from the inferred shapes (ref:
        MXExecutorSimpleBind)."""
        arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
        type_dict = type_dict or {}
        args = {}
        for name, shape in zip(symbol.list_arguments(), arg_shapes):
            check(shape is not None, f"could not infer shape for {name}")
            if shared_exec is not None and name in shared_exec.arg_dict \
                    and shared_exec.arg_dict[name].shape == tuple(shape):
                args[name] = shared_exec.arg_dict[name]
            else:
                args[name] = _nd.zeros(shape, ctx=ctx, dtype=type_dict.get(
                    name, _np.float32))
        aux = {}
        for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
            if shared_exec is not None and name in shared_exec.aux_dict \
                    and shared_exec.aux_dict[name].shape == tuple(shape):
                aux[name] = shared_exec.aux_dict[name]
            else:
                aux[name] = _nd.zeros(shape, ctx=ctx)
        ex = Executor(symbol, ctx, args, None, grad_req, aux,
                      group2ctx=group2ctx)
        if shared_exec is not None:
            for name in ex._grad_names:
                g = shared_exec.grad_dict.get(name)
                if g is not None and g.shape == ex.arg_dict[name].shape:
                    ex.grad_dict[name] = g
        return ex

    # -- execution -------------------------------------------------------
    def _maps(self, leaves=None):
        for n in self._arg_names:
            check(n in self.arg_dict, f"argument {n} has no array bound")
        args = {n: self.arg_dict[n]._data for n in self._arg_names}
        if leaves:
            args.update(leaves)
        return args, {n: self.aux_dict[n]._data for n in self._aux_names}

    def forward(self, is_train: bool = False, **kwargs):
        """Run the graph; ``kwargs`` write into ``arg_dict`` first. A
        training forward updates the aux states and keeps the record for
        :meth:`backward`."""
        for k, v in kwargs.items():
            check(k in self.arg_dict, f"unknown argument {k}")
            v = v._data if isinstance(v, _nd.NDArray) else \
                torch.as_tensor(_np.asarray(v))
            self.arg_dict[k]._write(v.to(self.arg_dict[k]._data.device,
                                         self.arg_dict[k]._data.dtype))
        self._pending = None
        if is_train:
            leaves = {n: self.arg_dict[n]._data.detach().requires_grad_()
                      for n in self._grad_names
                      if self.arg_dict[n]._data.is_floating_point()}
            args, aux = self._maps(leaves)
            collect: Dict[str, Any] = {}
            with torch.enable_grad():
                outs = _walk(self._symbol, args, aux, True,
                             collect_aux=collect)
            self._write_aux(collect)
            self._pending = (outs, leaves)
        else:
            args, aux = self._maps()
            with torch.no_grad():
                outs = _walk(self._symbol, args, aux, False)
        self._outputs = [_nd.NDArray(o.detach()) for o in outs]
        self._fire_monitor()
        return self._outputs

    def _write_aux(self, collect) -> None:
        with torch.no_grad():
            for n, v in collect.items():
                self.aux_dict[n]._data.copy_(v)

    def _fire_monitor(self):
        """The monitor callback on every output after a forward (ref:
        MXExecutorSetMonitorCallback; internals come from Monitor.toc)."""
        if self._monitor_callback is None or self._outputs is None:
            return
        for name, out in zip(self._out_names, self._outputs):
            self._monitor_callback(name, out)

    @property
    def outputs(self) -> List[_nd.NDArray]:
        if self._outputs is None:
            raise MXNetError("run forward() first")
        return self._outputs

    def backward(self, out_grads=None, is_train: bool = True) -> None:
        """Gradients of the last training forward into ``grad_dict``
        (``write`` or ``add``); head gradients default to ones."""
        check(self._pending is not None,
              "backward() requires a prior forward(is_train=True)")
        outs, leaves = self._pending
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, _nd.NDArray):
                out_grads = [out_grads]
            cots = [g._data if isinstance(g, _nd.NDArray) else g
                    for g in out_grads]
        names = list(leaves)
        pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    [leaves[n] for n in names],
                                    [c for _, c in pairs],
                                    allow_unused=True) if pairs and names \
            else [None] * len(names)
        with torch.no_grad():
            for name, g in zip(names, grads):
                buf = self.grad_dict.get(name)
                if buf is None:
                    continue
                if g is None:
                    g = torch.zeros_like(buf._data)
                if self._grad_req.get(name, "write") == "add":
                    buf._data.add_(g)
                else:
                    buf._data.copy_(g)
        self._pending = None

    # -- misc API (ref: executor.h) --------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._out_names, self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False) -> None:
        for dst, src, what in ((self.arg_dict, arg_params or {}, "param"),
                               (self.aux_dict, aux_params or {}, "aux")):
            for k, v in src.items():
                if k in dst:
                    dst[k]._write(_as_nd(v, self._ctx)._data.to(
                        dst[k]._data.device, dst[k]._data.dtype))
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} {k}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new shapes, sharing the arrays whose shape
        is unchanged (ref: MXExecutorReshape)."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        args = {}
        for name, shape in zip(self._arg_names, arg_shapes):
            cur = self.arg_dict.get(name)
            args[name] = cur if cur is not None and \
                cur.shape == tuple(shape) else _nd.zeros(shape,
                                                         ctx=self._ctx)
        aux = {}
        for name, shape in zip(self._aux_names, aux_shapes):
            cur = self.aux_dict.get(name)
            aux[name] = cur if cur is not None and \
                cur.shape == tuple(shape) else _nd.zeros(shape,
                                                         ctx=self._ctx)
        return Executor(self._symbol, self._ctx, args, None,
                        self._grad_req, aux, group2ctx=self._group2ctx)

    def set_monitor_callback(self, callback, monitor_all=False) -> None:
        self._monitor_callback = callback

    def debug_str(self) -> str:
        lines = [f"Symbol outputs: {self._out_names}"]
        for n in self._symbol._topo():
            lines.append(f"  {n.name}: "
                         f"{'var' if n.is_variable else n.op.name}")
        return "\n".join(lines)
