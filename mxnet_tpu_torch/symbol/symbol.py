"""Symbol: the declarative graph IR (ref: the JAX package's
``symbol/symbol.py``; the NNVM Symbol surfaced through
python/mxnet/symbol/symbol.py and serialised as JSON by
src/nnvm/legacy_json_util.cc).

A Symbol is a list of outputs over a DAG of :class:`_Node`s, each an op
record of the same registry ``mx.nd`` uses (or a variable). The executor
(``executor.py``) walks the DAG over tensors. ``tojson`` writes the JAX
package's node-list format byte for byte for the same graph (node names,
attribute strings, input triples, ``indent=2``), so either package loads
the other's files.

Shape and type inference run each op on meta tensors (shapes and dtypes,
no data; an op that needs values runs on zeros on the host), with the
reference's backfill of unknown parameter shapes from the known ones
(``PARAM_SHAPE_HINTS``, ref: infer_graph_attr_pass.cc).

A control-flow node (``_foreach``, ``_while_loop``, ``_cond``;
``control_flow.py``) carries its body as a sub-Symbol attribute, which
``tojson`` writes as an embedded JSON string (``_SUBJSON_MARK``) and
``load_json`` reads back. ``optimize_for`` partitions the graph into
``_subgraph`` nodes (``subgraph.py``); a partitioned graph is not
serialised. ``var`` and ``create`` take the attributes of the open
``AttrScope``s (``attribute.py``).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..attribute import current as _attr_current
from ..base import MXNetError, check, coerce_param, torch_dtype
from ..ops import registry as _reg

# attrs value prefix marking an embedded (recursively serialised)
# sub-Symbol: the control-flow nodes' bodies in save / load
_SUBJSON_MARK = "__MXTPU_SUBGRAPH_JSON__:"

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "new_node_name", "create"]

# the control-flow node kinds (control_flow.py), which the executor
# lowers itself
CONTROL_FLOW_OPS = ("_foreach", "_while_loop", "_cond")

_NAME_COUNTER: Dict[str, int] = {}


_INT_PARAMS: Dict[int, frozenset] = {}


def node_params(node) -> Dict[str, Any]:
    """The node's attributes as the op function's parameters. JSON's "1"
    and "0" read as booleans (``coerce_param``, as in the JAX package);
    where the function's default is an int they are ints again (PyTorch
    takes no bool for ``groups``)."""
    op = node.op
    ints = _INT_PARAMS.get(id(op))
    if ints is None:
        import inspect
        try:
            sig = inspect.signature(op.fn).parameters.values()
        except (TypeError, ValueError):
            sig = ()
        ints = _INT_PARAMS[id(op)] = frozenset(
            p.name for p in sig if type(p.default) is int)
    params = _reg.normalize_params(node.attrs)
    for k in ints.intersection(params):
        if isinstance(params[k], bool):
            params[k] = int(params[k])
    return params


def new_node_name(hint: str) -> str:
    n = _NAME_COUNTER.get(hint, 0)
    _NAME_COUNTER[hint] = n + 1
    return f"{hint}{n}"


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "extra")

    def __init__(self, op: Optional[_reg.OpDef], name: str,
                 attrs: Dict[str, Any], inputs: List[Tuple["_Node", int]]):
        self.op = op          # None => variable (arg or aux)
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.extra: Dict[str, Any] = {}

    @property
    def is_variable(self) -> bool:
        return self.op is None

    def num_outputs(self) -> int:
        if self.op is None:
            return 1
        n = self.op.num_outputs
        return n(len(self.inputs), _reg.normalize_params(self.attrs)) \
            if callable(n) else n


class Symbol:
    """An output list over the node DAG (ref: nnvm::Symbol)."""

    def __init__(self, outputs: List[Tuple[_Node, int]]):
        self._outputs = outputs

    # -- composition helpers -------------------------------------------
    @property
    def name(self) -> str:
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return "grouped"

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            check(index in names, f"no output named {index}")
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __repr__(self):
        return f"<Symbol {self.name}>"

    # -- graph walks ----------------------------------------------------
    def _topo(self) -> List[_Node]:
        order: List[_Node] = []
        seen = set()
        stack = [(n, False) for n, _ in reversed(self._outputs)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for inp, _ in reversed(node.inputs):
                if id(inp) not in seen:
                    stack.append((inp, False))
        return order

    def _variables(self) -> List[_Node]:
        return [n for n in self._topo() if n.is_variable]

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._variables()
                if not n.extra.get("aux", False)]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self._variables() if n.extra.get("aux", False)]

    def list_outputs(self) -> List[str]:
        outs = []
        for node, idx in self._outputs:
            if node.num_outputs() == 1:
                outs.append(f"{node.name}_output")
            else:
                outs.append(f"{node.name}_output{idx}")
        return outs

    def list_inputs(self) -> List[str]:
        return [n.name for n in self._variables()]

    def get_internals(self) -> "Symbol":
        outs = []
        for node in self._topo():
            if node.is_variable:
                outs.append((node, 0))
            else:
                for i in range(node.num_outputs()):
                    outs.append((node, i))
        return Symbol(outs)

    def get_children(self) -> Optional["Symbol"]:
        node = self._outputs[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    # -- attributes -----------------------------------------------------
    def attr(self, key: str):
        node = self._outputs[0][0]
        v = node.extra.get("attr", {}).get(key)
        return v

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        out = {}
        for node in self._topo():
            d = dict(node.extra.get("attr", {}))
            if d:
                out[node.name] = d
        return out

    def _set_attr(self, **kwargs):
        node = self._outputs[0][0]
        node.extra.setdefault("attr", {}).update(kwargs)

    # -- shape/type inference (ref: infer_graph_attr_pass.cc) ------------
    def infer_shape(self, *args, **kwargs):
        try:
            return self._infer_shape_impl(False, *args, **kwargs)
        except MXNetError:
            raise

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known: Dict[str, Tuple[int, ...]] = {}
        if args:
            for name, shape in zip(arg_names, args):
                if shape is not None:
                    known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        # variable dtype defaults
        dtypes = {n.name: n.extra.get("dtype", _np.float32)
                  for n in self._variables()}
        shapes, _, aux_shapes, _, out_shapes, _ = _infer(
            self, known, dtypes, partial)
        arg_shapes = [shapes.get(n) for n in arg_names]
        aux = [aux_shapes.get(n) for n in self.list_auxiliary_states()]
        return arg_shapes, out_shapes, aux

    def infer_type(self, *args, **kwargs):
        arg_names = self.list_arguments()
        known_t: Dict[str, Any] = {}
        if args:
            for name, t in zip(arg_names, args):
                if t is not None:
                    known_t[name] = t
        known_t.update(kwargs)
        shapes = {n.name: n.extra.get("shape") for n in self._variables()}
        # require shapes declared on vars for type inference; fall back 1s
        known_s = {k: tuple(s if s else (1,)) for k, s in shapes.items()
                   if s is not None}
        dtypes = {n.name: known_t.get(n.name, n.extra.get("dtype", _np.float32))
                  for n in self._variables()}
        try:
            _, types, _, aux_t, _, out_t = _infer(self, known_s, dtypes,
                                                  True)
        except MXNetError:
            return [None] * len(arg_names), None, []
        return ([types.get(n) for n in arg_names], out_t,
                [aux_t.get(n) for n in self.list_auxiliary_states()])

    # -- eval / bind -----------------------------------------------------
    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_arg_names=None, shared_exec=None,
                    shared_buffer=None, **kwargs):
        from .executor import Executor
        return Executor.simple_bind(self, ctx, grad_req=grad_req,
                                    type_dict=type_dict, group2ctx=group2ctx,
                                    shared_exec=shared_exec, **kwargs)

    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx, args=kwargs)
        return ex.forward()

    def __call__(self, *args, **kwargs):
        """Compose: replace variables with given symbols (ref Symbol compose)."""
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def __copy__(self):
        # deep-copy of the DAG
        memo: Dict[int, _Node] = {}

        def copy_node(node: _Node) -> _Node:
            c = memo.get(id(node))
            if c is None:
                c = _Node(node.op, node.name, dict(node.attrs),
                          [(copy_node(i), k) for i, k in node.inputs])
                c.extra = dict(node.extra)
                memo[id(node)] = c
            return c

        return Symbol([(copy_node(n), i) for n, i in self._outputs])

    def _compose(self, *args, **kwargs):
        variables = self._variables()
        mapping: Dict[str, _Node] = {}
        if args:
            arg_vars = [n for n in variables if not n.extra.get("aux", False)]
            for v, s in zip(arg_vars, args):
                mapping[v.name] = s._outputs[0][0]
        for k, s in kwargs.items():
            mapping[k] = s._outputs[0][0]
        for node in self._topo():
            node.inputs = [(mapping.get(i.name, i) if i.is_variable else i, k)
                           for i, k in node.inputs]

    def optimize_for(self, backend: str, **kwargs) -> "Symbol":
        """Partition the graph with the subgraph property registered as
        ``backend`` (ref: Symbol.optimize_for, ``subgraph.py``)."""
        from ..subgraph import get_subgraph_property, partition_graph
        return partition_graph(self,
                               get_subgraph_property(backend, **kwargs))

    # -- serialization ---------------------------------------------------
    def tojson(self) -> str:
        for n in self._topo():
            if n.op is not None and n.op.name == "_subgraph":
                raise MXNetError(
                    "cannot serialize a partitioned graph: _subgraph "
                    "nodes are runtime artifacts; save the original "
                    "symbol and re-run optimize_for after loading")

        def ser_attr(v):
            # a control-flow node's body, as an embedded JSON string
            if isinstance(v, Symbol):
                return _SUBJSON_MARK + v.tojson()
            return str(v)

        nodes = []
        index: Dict[int, int] = {}
        order = self._topo()
        for node in order:
            index[id(node)] = len(nodes)
            attrs = {k: ser_attr(v) for k, v in node.attrs.items()}
            if node.is_variable and node.extra.get("aux", False):
                attrs["__aux__"] = "1"
            nodes.append({
                "op": "null" if node.is_variable else node.op.name,
                "name": node.name,
                "attrs": attrs,
                "inputs": [[index[id(i)], k, 0] for i, k in node.inputs],
            })
        arg_nodes = [index[id(n)] for n in order if n.is_variable]
        heads = [[index[id(n)], i, 0] for n, i in self._outputs]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10500]}},
                          indent=2)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- operator sugar --------------------------------------------------
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return create(op, [a, b], {})
        return create(scalar_op, [self],
                      {"scalar": float(other), "reverse": reverse})

    def __add__(self, o):  return self._binary(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self._binary(o, "broadcast_add", "_plus_scalar", True)
    def __sub__(self, o):  return self._binary(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binary(o, "broadcast_sub", "_rminus_scalar", True)
    def __mul__(self, o):  return self._binary(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binary(o, "broadcast_mul", "_mul_scalar", True)
    def __truediv__(self, o): return self._binary(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binary(o, "broadcast_div", "_rdiv_scalar", True)
    def __pow__(self, o): return self._binary(o, "broadcast_power", "_power_scalar")
    def __neg__(self): return create("negative", [self], {})

    def __getattr__(self, name):
        # method-style ops: sym.reshape(...), sym.sum(...)
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            _reg.get_op(name)
        except MXNetError:
            raise AttributeError(name) from None

        def method(**kwargs):
            return create(name, [self], kwargs)

        return method


# Backward/param shape inference hooks: the reference's per-op InferShape
# fills UNKNOWN input shapes from known ones (e.g. FullyConnected infers
# weight=(num_hidden, in_dim) from data). fn(in_shapes, params) -> {idx: shape}
def _fc_hint(in_shapes, params):
    out = {}
    data = in_shapes[0]
    if data is None:
        return out
    num_hidden = int(params.get("num_hidden", 1))
    flatten = params.get("flatten", True)
    in_dim = int(_np.prod(data[1:])) if flatten else data[-1]
    if len(in_shapes) > 1 and in_shapes[1] is None:
        out[1] = (num_hidden, in_dim)
    if len(in_shapes) > 2 and in_shapes[2] is None:
        out[2] = (num_hidden,)
    return out


def _conv_hint(in_shapes, params):
    out = {}
    data = in_shapes[0]
    if data is None:
        return out
    kernel = tuple(params.get("kernel", ()))
    nf = int(params.get("num_filter", 1))
    g = int(params.get("num_group", 1))
    layout = params.get("layout") or ""
    channel_last = layout.endswith("C")
    c = data[-1] if channel_last else data[1]
    if len(in_shapes) > 1 and in_shapes[1] is None:
        # channel-last follows the NHWC weight convention (O, *k, I/g)
        out[1] = (nf,) + kernel + (c // g,) if channel_last \
            else (nf, c // g) + kernel
    if len(in_shapes) > 2 and in_shapes[2] is None:
        out[2] = (nf,)
    return out


def _deconv_hint(in_shapes, params):
    out = {}
    data = in_shapes[0]
    if data is None:
        return out
    kernel = tuple(params.get("kernel", ()))
    nf = int(params.get("num_filter", 1))
    g = int(params.get("num_group", 1))
    # weight is (C_in, num_filter/g, *k) in EVERY layout; only where C
    # sits in the DATA depends on the layout (channel-last: last axis)
    layout = str(params.get("layout") or "")
    c_in = data[-1] if layout.endswith("C") else data[1]
    if len(in_shapes) > 1 and in_shapes[1] is None:
        out[1] = (c_in, nf // g) + kernel
    if len(in_shapes) > 2 and in_shapes[2] is None:
        out[2] = (nf,)
    return out


def _channel_vec_hint(in_shapes, params):
    data = in_shapes[0]
    if data is None:
        return {}
    axis = int(params.get("axis", 1))
    c = data[axis % len(data)]
    return {i: (c,) for i in range(1, len(in_shapes))
            if in_shapes[i] is None}


def _layernorm_hint(in_shapes, params):
    data = in_shapes[0]
    if data is None:
        return {}
    axis = int(params.get("axis", -1))
    c = data[axis % len(data)]
    return {i: (c,) for i in range(1, len(in_shapes))
            if in_shapes[i] is None}


def _fused_bn_hint(first_param):
    """The fused BN ops (channel axis -1 by default): gamma, beta and the
    moving statistics from data's channels, ``_contrib_fused_bn_add_relu``'s
    residual from data (the JAX package has no hint for them, so it cannot
    bind an exported NHWC ResNet by its data shape)."""
    def hint(in_shapes, params):
        data = in_shapes[0]
        if data is None:
            return {}
        c = data[int(params.get("axis", -1)) % len(data)]
        out = {i: (c,) for i in range(first_param, len(in_shapes))
               if in_shapes[i] is None}
        if first_param == 2 and in_shapes[1] is None:
            out[1] = tuple(data)
        return out
    return hint


def _embedding_hint(in_shapes, params):
    if len(in_shapes) > 1 and in_shapes[1] is None:
        return {1: (int(params.get("input_dim", 1)),
                    int(params.get("output_dim", 1)))}
    return {}


def _rnn_hint(in_shapes, params):
    data = in_shapes[0]
    if data is None:
        return {}
    from ..ops.rnn_op import rnn_param_size
    mode = params.get("mode", "lstm")
    nl = int(params.get("num_layers", 1))
    h = int(params.get("state_size", 1))
    bid = bool(params.get("bidirectional", False))
    out = {}
    if len(in_shapes) > 1 and in_shapes[1] is None:
        out[1] = (rnn_param_size(nl, data[2], h, bid, mode),)
    state_shape = (nl * (2 if bid else 1), data[1], h)
    for i in (2, 3):
        if len(in_shapes) > i and in_shapes[i] is None:
            out[i] = state_shape
    return out


def _samelike_hint(in_shapes, params):
    known = next((s for s in in_shapes if s is not None), None)
    if known is None:
        return {}
    return {i: known for i, s in enumerate(in_shapes) if s is None}


PARAM_SHAPE_HINTS: Dict[str, Any] = {
    "FullyConnected": _fc_hint,
    "RNN": _rnn_hint,
    "Convolution": _conv_hint,
    "Deconvolution": _deconv_hint,
    "BatchNorm": _channel_vec_hint,
    "InstanceNorm": _channel_vec_hint,
    "_contrib_fused_bn_relu": _fused_bn_hint(1),
    "_contrib_fused_bn_add_relu": _fused_bn_hint(2),
    "LayerNorm": _layernorm_hint,
    "Embedding": _embedding_hint,
    "SoftmaxOutput": lambda s, p: (
        {1: (s[0][0],)} if s[0] is not None and len(s) > 1 and s[1] is None
        else {}),
    "elemwise_add": _samelike_hint,
    "elemwise_sub": _samelike_hint,
    "elemwise_mul": _samelike_hint,
    "elemwise_div": _samelike_hint,
}



def _as_dtype(dt):
    return dt if isinstance(dt, torch.dtype) else torch_dtype(dt)


def _eval_shape(fn, ins, params):
    """Run ``fn`` on meta tensors of the inputs' shapes and dtypes, or, for
    an op that reads values, on zeros on the host."""
    for device in ("meta", "cpu"):
        try:
            args = [torch.zeros(s, dtype=d, device=device) for s, d in ins]
            with torch.no_grad():
                out = fn(*args, **params)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            return [(tuple(o.shape), o.dtype) for o in outs]
        except Exception as e:          # noqa: BLE001 - retried on the host
            err = e
    raise err


# nodes whose body is a sub-Symbol: shapes come from inferring the body
SUBGRAPH_OPS = CONTROL_FLOW_OPS + ("_subgraph",)


def _body_names(node):
    """``(names, sliced, bodies)``: the body's variable name for each of
    the node's inputs (None for ``_cond``'s predicate), the inputs the
    body sees one leading-axis slice of (``_foreach``'s data), and the
    bodies."""
    a, op = node.attrs, node.op.name
    if op == "_subgraph":
        return list(a["__subgraph_inputs__"]), 0, [a["__subgraph__"]]
    free = list(a["__cf_free_names__"])
    if op == "_foreach":
        sl = list(a["__cf_slice_names__"])
        return (sl + list(a["__cf_state_names__"]) + free, len(sl),
                [a["__subgraph__"]])
    if op == "_while_loop":
        return list(a["__cf_state_names__"]) + free, 0, [a["__subgraph__"]]
    return ([None] + list(a["__cf_in_names__"]) + free, 0,
            [a["__subgraph__"], a["__cf_else__"]])


def _body_known(names, sliced, in_avals):
    known, dts = {}, {}
    for i, (n, av) in enumerate(zip(names, in_avals)):
        if n is not None and av is not None:
            known[n] = av[0][1:] if i < sliced else av[0]
            dts[n] = av[1]
    return known, dts


def _sub_backfill(node, in_avals):
    """{input index: (shape, dtype)} for the node's unknown inputs that
    the bodies' own inference fills (their parameters)."""
    names, sliced, bodies = _body_names(node)
    known, dts = _body_known(names, sliced, in_avals)
    out = {}
    for body in bodies:
        sh, ty, ash, aty, _, _ = _infer(body, known, dts, True)
        for i, n in enumerate(names):
            if i < sliced or n is None or in_avals[i] is not None \
                    or i in out:
                continue
            if n in sh:
                out[i] = (sh[n], ty[n])
            elif n in ash:
                out[i] = (ash[n], aty[n])
    return out


def _sub_outputs(node, in_avals, partial):
    """The node's output avals from its body's: ``_foreach`` stacks the
    step outputs over the data's leading axis, ``_while_loop`` buffers
    them over ``max_iterations`` after the predicate."""
    names, sliced, bodies = _body_names(node)
    known, dts = _body_known(names, sliced, in_avals)
    _, _, _, _, shp, typ = _infer(bodies[0], known, dts, partial)
    outs = [None if s is None else (tuple(s), t) for s, t in zip(shp, typ)]
    op, a = node.op.name, node.attrs
    if op == "_foreach":
        n, steps = a["__cf_n_out__"], in_avals[0][0][0]
        return [None if o is None else ((steps,) + o[0], o[1])
                for o in outs[:n]] + outs[n:]
    if op == "_while_loop":
        n, steps = a["__cf_n_out__"], a["__cf_max_iter__"]
        return [None if o is None else ((steps,) + o[0], o[1])
                for o in outs[1:1 + n]] + outs[1 + n:]
    return outs


def _infer(symbol: Symbol, known_shapes, dtypes, partial):
    """Whole-graph shape and dtype propagation with the reference's
    backfill of unknown parameter shapes (``PARAM_SHAPE_HINTS``). Returns
    (arg shapes, arg types, aux shapes, aux types, out shapes, out
    types)."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    types: Dict[str, Any] = {}
    aux_shapes: Dict[str, Tuple[int, ...]] = {}
    aux_types: Dict[str, Any] = {}
    cache: Dict[Tuple[int, int], Any] = {}

    def var_aval(node: _Node, assigned_shape=None):
        shape = assigned_shape or known_shapes.get(node.name) \
            or node.extra.get("shape")
        if shape is None or any(s == 0 for s in shape):
            return None
        dt = dtypes.get(node.name, node.extra.get("dtype", _np.float32))
        return (tuple(shape), _as_dtype(dt))

    def record_var(node, aval):
        if node.extra.get("aux", False):
            aux_shapes[node.name], aux_types[node.name] = aval
        else:
            shapes[node.name], types[node.name] = aval
        cache[(id(node), 0)] = aval

    for node in symbol._topo():
        if node.is_variable:
            aval = var_aval(node)
            if aval is not None:
                record_var(node, aval)
            continue
        in_avals = [cache.get((id(i), k)) for i, k in node.inputs]
        nested = node.op.name in SUBGRAPH_OPS
        if nested and any(a is None for a in in_avals):
            # the body's own hints fill the node's unknown parameters
            for idx, aval in _sub_backfill(node, in_avals).items():
                inp, k = node.inputs[idx]
                if inp.is_variable and cache.get((id(inp), 0)) is None:
                    aval = var_aval(inp, assigned_shape=aval[0])
                    if aval is not None:
                        record_var(inp, aval)
            in_avals = [cache.get((id(i), k)) for i, k in node.inputs]
        elif any(a is None for a in in_avals):
            hint = PARAM_SHAPE_HINTS.get(node.op.name)
            if hint is not None:
                in_shapes = [a[0] if a is not None else None
                             for a in in_avals]
                proposed = hint(in_shapes,
                                _reg.normalize_params(node.attrs))
                for idx, shp in proposed.items():
                    inp, k = node.inputs[idx]
                    if inp.is_variable and cache.get((id(inp), 0)) is None:
                        aval = var_aval(inp, assigned_shape=tuple(shp))
                        if aval is not None:
                            record_var(inp, aval)
                in_avals = [cache.get((id(i), k)) for i, k in node.inputs]
        if any(a is None for a in in_avals):
            if partial:
                continue
            missing = [i.name for (i, k), a in zip(node.inputs, in_avals)
                       if a is None]
            raise MXNetError(
                f"cannot infer shape: inputs {missing} of node "
                f"{node.name} are unknown")
        try:
            outs = _sub_outputs(node, in_avals, partial) if nested else \
                _eval_shape(node.op.fn, in_avals, node_params(node))
        except MXNetError:
            raise
        except Exception as e:          # noqa: BLE001 - named below
            raise MXNetError(
                f"shape inference failed at {node.name} ({node.op.name}): "
                f"{e}") from None
        for i, o in enumerate(outs):
            if o is not None:
                cache[(id(node), i)] = o

    out_shapes, out_types = [], []
    for node, i in symbol._outputs:
        a = cache.get((id(node), i))
        out_shapes.append(a[0] if a is not None else None)
        out_types.append(a[1] if a is not None else None)
    return shapes, types, aux_shapes, aux_types, out_shapes, out_types


# ---------------------------------------------------------------------------
# construction API
# ---------------------------------------------------------------------------

def var(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
        dtype=None, init=None, stype=None, **kwargs) -> Symbol:
    """A variable (ref: mx.sym.var / Variable)."""
    node = _Node(None, name, {}, [])
    scope_attrs = _attr_current().get()
    if scope_attrs:
        node.extra["attr"] = dict(scope_attrs)
    if shape is not None:
        node.extra["shape"] = tuple(shape)
    if dtype is not None:
        node.extra["dtype"] = dtype
    if init is not None:
        node.extra["init"] = init
    if attr:
        node.extra["attr"] = dict(attr)
    for k, v in kwargs.items():
        node.extra.setdefault("attr", {})[k] = v
    if lr_mult is not None:
        node.extra.setdefault("attr", {})["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        node.extra.setdefault("attr", {})["__wd_mult__"] = wd_mult
    return Symbol([(node, 0)])


Variable = var


def Group(symbols: Sequence[Symbol]) -> Symbol:
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def create(op_name: str, input_syms: Sequence[Symbol], params: Dict[str, Any],
           name: Optional[str] = None) -> Symbol:
    """Create an op node (the generated sym.<op> functions call this)."""
    opdef = _reg.get_op(op_name)
    name = name or new_node_name(op_name.lower().strip("_"))
    inputs: List[Tuple[_Node, int]] = []
    for s in input_syms:
        check(isinstance(s, Symbol), f"{op_name}: inputs must be Symbols")
        check(len(s._outputs) == 1,
              f"{op_name}: cannot use a grouped symbol as input")
        inputs.append(s._outputs[0])
    # auto-create variables for MISSING op inputs, named {node}_{input}
    # (ref: nnvm Symbol::Compose — `sym.FullyConnected(data, num_hidden=8)`
    # yields fc_weight/fc_bias arguments exactly like the reference)
    from ..ops.opdoc import _split_params
    req_inputs, fn_params, variadic = _split_params(opdef)
    aux_set = set(opdef.aux_inputs)
    for idx in range(len(inputs), len(req_inputs)):
        v = _Node(None, f"{name}_{req_inputs[idx]}", {}, [])
        v.extra["auto"] = True  # placeholder: MXSymbolCompose may replace
        if idx in aux_set:
            v.extra["aux"] = True
        inputs.append((v, 0))
    # the bias slot of FC/Conv-style ops is variadic, gated on no_bias
    if variadic and len(input_syms) <= len(req_inputs) and \
            any(n == "no_bias" for n, _ in fn_params) and \
            not coerce_param(params.get("no_bias", False)):
        bias = _Node(None, f"{name}_bias", {}, [])
        bias.extra["auto"] = True
        inputs.append((bias, 0))
    # auto-create any aux-state variables beyond the fn's positional list
    # (ref: OperatorProperty::ListAuxiliaryStates)
    n_declared = len(inputs)
    for aux_i in opdef.aux_inputs:
        if aux_i >= n_declared:
            suffix = {3: "moving_mean", 4: "moving_var"}.get(aux_i, f"aux{aux_i}")
            aux_node = _Node(None, f"{name}_{suffix}", {}, [])
            aux_node.extra["aux"] = True
            inputs.append((aux_node, 0))
    node = _Node(opdef, name, dict(params), inputs)
    scope_attrs = _attr_current().get()
    if scope_attrs:
        node.extra["attr"] = dict(scope_attrs)
    # mark already-supplied aux inputs
    for aux_i in opdef.aux_inputs:
        if aux_i < len(node.inputs):
            inp = node.inputs[aux_i][0]
            if inp.is_variable:
                inp.extra["aux"] = True
    n_out = node.num_outputs()
    return Symbol([(node, i) for i in range(n_out)])


def load_json(json_str: str) -> Symbol:
    data = json.loads(json_str)
    nodes: List[_Node] = []
    for spec in data["nodes"]:
        raw = spec.get("attrs") or spec.get("param") or {}
        attrs = {k: load_json(v[len(_SUBJSON_MARK):])
                 if isinstance(v, str) and v.startswith(_SUBJSON_MARK)
                 else coerce_param(v) for k, v in raw.items()}
        if spec["op"] == "null":
            is_aux = attrs.pop("__aux__", None)
            node = _Node(None, spec["name"], {}, [])
            if is_aux:
                node.extra["aux"] = True
            if attrs:
                node.extra["attr"] = attrs
        else:
            opdef = _reg.get_op(spec["op"])
            inputs = [(nodes[i], k) for i, k, *_ in spec["inputs"]]
            node = _Node(opdef, spec["name"], attrs, inputs)
        nodes.append(node)
    # mark aux nodes from op definitions
    for node in nodes:
        if node.op is not None:
            for aux_i in node.op.aux_inputs:
                if aux_i < len(node.inputs) and node.inputs[aux_i][0].is_variable:
                    node.inputs[aux_i][0].extra["aux"] = True
    heads = [(nodes[i], k) for i, k, *_ in data["heads"]]
    return Symbol(heads)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())
