"""Graph partitioning (ref: the JAX package's ``subgraph.py``;
src/operator/subgraph/ in the reference: SubgraphProperty /
SubgraphSelector, MXNET_REGISTER_SUBGRAPH_PROPERTY and the partitioner of
partition_graph.cc).

:func:`partition_graph` grows maximal connected regions from the nodes a
property's selector accepts and replaces each with one ``_subgraph`` node
that carries the region as a sub-Symbol over proxy inputs
(``_sub{r}_in{i}``). ``Symbol.optimize_for(name)`` partitions with the
property registered under ``name``; the built-in names are the JAX
package's (``"XLA"``, every op but the random ones), so users' calls stay
as they are.

Where the JAX package compiles a region into one XLA program, the port
runs it as one node that walks its sub-Symbol op by op, in the enclosing
walk's mode and with its aux updates going back to the outer graph's
variables (``symbol/executor._walk_subgraph``): the same ops and kernels
as the unpartitioned graph, in the same order. The port's one-program
form is a hybridized block's CUDA graph (``cached_op.py``), which captures
a ``SymbolBlock`` over a partitioned graph whole. A partitioned graph is
a runtime artifact: ``tojson`` refuses it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Set, Tuple

from .base import MXNetError

__all__ = ["SubgraphSelector", "SubgraphProperty",
           "register_subgraph_property", "get_subgraph_property",
           "partition_graph", "list_subgraph_properties"]


class SubgraphSelector:
    """Decides which nodes join a region (ref: subgraph_property.h
    SubgraphSelector)."""

    def select(self, node) -> bool:
        """May this node seed a new region?"""
        return False

    def select_input(self, node, input_node) -> bool:
        """Grow from ``node`` to its producer ``input_node``?"""
        return self.select(input_node)

    def select_output(self, node, output_node) -> bool:
        """Grow from ``node`` to its consumer ``output_node``?"""
        return self.select(output_node)


class SubgraphProperty:
    """A partitioning strategy (ref: subgraph_property.h
    SubgraphProperty): ``create_selector`` and, optionally,
    ``create_subgraph_node`` for how a claimed region runs."""

    def create_selector(self) -> SubgraphSelector:
        raise NotImplementedError

    def create_subgraph_node(self, sub_sym, input_names: List[str],
                             index: int):
        """The replacement node's op name and attributes: by default a
        ``_subgraph`` node walking the region's sub-Symbol."""
        attrs = {"__subgraph__": sub_sym,
                 "__subgraph_inputs__": tuple(input_names)}
        return ("_subgraph", attrs)


_PROPERTIES: Dict[str, Callable[[], SubgraphProperty]] = {}


def register_subgraph_property(name: str):
    """(ref: MXNET_REGISTER_SUBGRAPH_PROPERTY)"""
    def deco(cls):
        _PROPERTIES[name] = cls
        return cls
    return deco


def get_subgraph_property(name: str, **kwargs) -> SubgraphProperty:
    if name not in _PROPERTIES:
        raise MXNetError(
            f"no subgraph property {name!r}; registered: "
            f"{sorted(_PROPERTIES)}")
    return _PROPERTIES[name](**kwargs)


def list_subgraph_properties() -> List[str]:
    return sorted(_PROPERTIES)


# ---------------------------------------------------------------------------
# the _subgraph op: a region's sub-Symbol as one node
# ---------------------------------------------------------------------------

def _register_subgraph_op():
    from .ops.registry import register

    # the executor walks _subgraph nodes itself, in its own mode and with
    # its aux states (executor._walk_subgraph); this function serves any
    # other caller, in inference mode
    @register("_subgraph", num_outputs=lambda n_in, params:
              len(params["__subgraph__"]._outputs))
    def _subgraph(*inputs, __subgraph__=None, __subgraph_inputs__=()):
        from .symbol.executor import _walk
        outs = _walk(__subgraph__, dict(zip(__subgraph_inputs__, inputs)),
                     {}, False)
        return outs[0] if len(outs) == 1 else tuple(outs)


_register_subgraph_op()


# ---------------------------------------------------------------------------
# partitioner (ref: partition_graph.cc)
# ---------------------------------------------------------------------------

def _grow_regions(order, consumers, selector):
    """Maximal regions, each grown from a seed the selector accepts across
    the edges it accepts."""
    assigned: Dict[int, int] = {}
    regions: List[List] = []
    for node in order:
        if node.is_variable or id(node) in assigned \
                or not selector.select(node):
            continue
        region = [node]
        assigned[id(node)] = len(regions)
        frontier = [node]
        while frontier:
            cur = frontier.pop()
            for inp, _ in cur.inputs:
                if not inp.is_variable and id(inp) not in assigned \
                        and selector.select_input(cur, inp):
                    assigned[id(inp)] = len(regions)
                    region.append(inp)
                    frontier.append(inp)
            for out in consumers.get(id(cur), []):
                if id(out) not in assigned \
                        and selector.select_output(cur, out):
                    assigned[id(out)] = len(regions)
                    region.append(out)
                    frontier.append(out)
        regions.append(region)
    return regions


def _acyclic(order, regions):
    """Each region in topological order, shrunk from its end until no
    path leaves it and comes back (ref: partition_graph.cc CheckCycle,
    which splits such regions)."""
    def is_cyclic(ids):
        reach: Set[int] = set()
        for node in order:
            if id(node) not in ids and any(
                    id(i) in ids or id(i) in reach for i, _ in node.inputs):
                reach.add(id(node))
        return any(id(i) in reach for n in order if id(n) in ids
                   for i, _ in n.inputs)

    out = []
    for region in regions:
        members = {id(r) for r in region}
        region = [n for n in order if id(n) in members]
        while len(region) > 1 and is_cyclic({id(n) for n in region}):
            region.pop()
        if region and not is_cyclic({id(n) for n in region}):
            out.append(region)
    return out


def partition_graph(symbol, prop: SubgraphProperty):
    """A copy of ``symbol`` with every region ``prop`` selects replaced by
    one ``_subgraph`` node; ``symbol`` itself is left as it is."""
    from .ops import registry as _reg
    from .symbol import var as sym_var
    from .symbol.symbol import Symbol, _Node, new_node_name

    sym = symbol.__copy__()
    order = sym._topo()
    consumers: Dict[int, List] = {}
    for node in order:
        for inp, _ in node.inputs:
            consumers.setdefault(id(inp), []).append(node)
    regions = _acyclic(order, _grow_regions(order, consumers,
                                            prop.create_selector()))
    if not regions:
        return sym

    head_ids = {(id(n), i) for n, i in sym._outputs}
    replaced: Dict[Tuple, Tuple] = {}   # (node id, slot) -> (fused, slot)
    fused_nodes: List = []
    for ridx, region in enumerate(regions):
        ids = {id(n) for n in region}
        # region inputs: edges from outside (variables included)
        input_entries: List[Tuple] = []
        seen = set()
        for n in region:
            for inp, slot in n.inputs:
                if id(inp) not in ids and (id(inp), slot) not in seen:
                    seen.add((id(inp), slot))
                    input_entries.append((inp, slot))
        input_names = [f"_sub{ridx}_in{i}"
                       for i in range(len(input_entries))]
        # region outputs: entries read outside it, or graph heads
        out_entries = [
            (n, i) for n in region for i in range(n.num_outputs())
            if (id(n), i) in head_ids or any(
                id(c) not in ids and any(ci is n and k == i
                                         for ci, k in c.inputs)
                for c in consumers.get(id(n), []))]
        if not out_entries:
            continue
        proxies = {(id(inp), slot): sym_var(name)._outputs[0][0]
                   for (inp, slot), name in zip(input_entries, input_names)}
        copies = {}
        for n in region:
            c = _Node(n.op, n.name, dict(n.attrs),
                      [(copies[id(inp)], slot) if id(inp) in ids
                       else (proxies[(id(inp), slot)], 0)
                       for inp, slot in n.inputs])
            c.extra = dict(n.extra)
            copies[id(n)] = c
        sub_sym = Symbol([(copies[id(n)], i) for n, i in out_entries])
        op_name, attrs = prop.create_subgraph_node(sub_sym, input_names,
                                                   ridx)
        # an input may be an earlier region's output: read it from that
        # region's node
        fused = _Node(_reg.get_op(op_name),
                      new_node_name(f"subgraph{ridx}_"), attrs,
                      [replaced.get((id(inp), slot), (inp, slot))
                       for inp, slot in input_entries])
        fused_nodes.append(fused)
        for j, (n, i) in enumerate(out_entries):
            replaced[(id(n), i)] = (fused, j)

    # rewrite the outer edges; fused nodes made before a later region
    # existed are rewritten too, so region-to-region edges resolve in any
    # seed order
    def rewrite(entry):
        return replaced.get((id(entry[0]), entry[1]), entry)

    for node in list(order) + fused_nodes:
        if any((id(i), s) in replaced for i, s in node.inputs):
            node.inputs = [rewrite(e) for e in node.inputs]
    sym._outputs = [rewrite(e) for e in sym._outputs]
    return sym


# ---------------------------------------------------------------------------
# built-in properties
# ---------------------------------------------------------------------------

@register_subgraph_property("XLA")
class XLAFuseProperty(SubgraphProperty):
    """Every op node except the random ones and ``_subgraph`` nodes, in
    maximal regions (the JAX package's property of this name, kept so
    that ``optimize_for("XLA")`` works as it does there)."""

    class _Sel(SubgraphSelector):
        def select(self, node):
            return node.op is not None and node.op.name != "_subgraph" \
                and not getattr(node.op, "rng", False)

    def create_selector(self):
        return self._Sel()


class NamedOpProperty(SubgraphProperty):
    """Regions of the given op names (conv + BN + ReLU style chains)."""

    def __init__(self, op_names):
        self._names = set(op_names)

    class _Sel(SubgraphSelector):
        def __init__(self, names):
            self._names = names

        def select(self, node):
            return node.op is not None and node.op.name in self._names

    def create_selector(self):
        return self._Sel(self._names)
