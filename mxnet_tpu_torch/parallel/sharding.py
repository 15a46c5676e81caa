"""Sharding rules: how global tensors map onto the ranks of a mesh (ref:
the JAX package's ``parallel/sharding.py``).

The JAX package places a global array on its mesh with a
``NamedSharding`` and GSPMD splits the program. The port holds, on each
rank, that rank's **local block** of every tensor: :func:`local_block`
cuts a global tensor into the block a :data:`P` spec gives this rank
(dimension ``i`` split evenly over the mesh axis ``spec[i]``; ``None``
or a missing entry keeps it whole), and :func:`gather` reassembles the
global tensor from every rank's block (for tests, checkpoints and
``convert``). A tensor replicated over an axis is the same block on each
rank of it. :func:`shard_batch` and :meth:`ShardingPlan.shard_params`
take global values and return this rank's blocks, on the current
context's device.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Sequence, Tuple

import torch

from ..base import check

__all__ = ["P", "PartitionSpec", "NamedSharding", "named_sharding",
           "shard_batch", "replicate", "local_block", "gather",
           "reduce_unsplit", "ShardingPlan", "MP_RULES_TRANSFORMER"]


class PartitionSpec(tuple):
    """The port's spec tuple: entry ``i`` names the mesh axis dimension
    ``i`` is split over (or None). ``P()`` is fully replicated."""

    def __new__(cls, *specs):
        return super().__new__(cls, specs)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


class NamedSharding:
    """A spec on a mesh (the JAX class's two fields)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def named_sharding(mesh, *specs) -> NamedSharding:
    return NamedSharding(mesh, P(*specs))


def _axes_of(entry):
    """The mesh axes one spec entry names (a name, a tuple of names, or
    None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def local_block(x, spec, mesh):
    """This rank's block of the global tensor ``x`` under ``spec``: each
    dimension named by ``spec`` is cut into equal chunks over its mesh
    axes (several axes: the first outermost) and this rank keeps its
    chunk. A spec longer than ``x``'s rank raises, as JAX's does."""
    spec = tuple(spec or ())
    check(len(spec) <= x.dim(),
          f"spec {spec} has more entries than the tensor has dims "
          f"({tuple(x.shape)})")
    out = x
    for dim, entry in enumerate(spec):
        for ax in _axes_of(entry):
            n = mesh.axis_size(ax)
            if n == 1:
                continue
            check(out.shape[dim] % n == 0,
                  f"dimension {dim} ({out.shape[dim]}) of {tuple(x.shape)} "
                  f"does not split over mesh axis {ax!r} of size {n}")
            out = out.chunk(n, dim=dim)[mesh.axis_index(ax)]
    return out.contiguous()


def gather(x, spec, mesh):
    """The global tensor from every rank's block ``x`` under ``spec``
    (the inverse of :func:`local_block`; every rank gets it). Not
    differentiable: model code gathers through
    ``collectives.allgather``."""
    from .collectives import _raw_allgather
    spec = tuple(spec or ())
    out = x.detach()
    for dim in reversed(range(len(spec))):
        for ax in reversed(_axes_of(spec[dim])):
            n = mesh.axis_size(ax)
            g = mesh.group(ax)
            if n == 1 or g is None:
                continue
            out = _raw_allgather(out.contiguous(), g, n, dim)
    return out


def reduce_unsplit(grads, specs, mesh):
    """Each gradient summed over the mesh axes its spec does not split (a
    replicated parameter's over every axis): the gradients of rank-local
    shares of one loss (``parallel/collectives.py``). One flat all-reduce
    per axis and dtype; returns the list in order."""
    from .collectives import device_allreduce
    out = list(grads)
    for ax in mesh.axis_names:
        if mesh.axis_size(ax) == 1:
            continue
        groups: Dict[Any, list] = {}
        for j, spec in enumerate(specs):
            if ax not in {a for e in tuple(spec) for a in _axes_of(e)}:
                groups.setdefault(out[j].dtype, []).append(j)
        for idx in groups.values():
            red = device_allreduce([out[j] for j in idx], mesh, axis=ax)
            for j, g in zip(idx, red):
                out[j] = g
    return out


def shard_batch(x, mesh, axis: str = "dp", batch_dim: int = 0,
                device=None):
    """This rank's block of a global host batch, split along
    ``batch_dim`` over ``axis`` and moved to ``device`` (default: the
    current context's)."""
    from ..context import resolve_device
    from ..ndarray.ndarray import NDArray
    data = x._data if isinstance(x, NDArray) else x
    if not isinstance(data, torch.Tensor):
        import numpy as np
        data = torch.as_tensor(np.asarray(data))
    spec = [None] * data.dim()
    spec[batch_dim] = axis
    return local_block(data, P(*spec), mesh).to(resolve_device(device))


def replicate(tree, mesh, device=None):
    """Every rank holds the whole value: each tensor of the (nested dict
    or list) ``tree`` moved to ``device`` (default the current
    context's)."""
    from ..context import resolve_device
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


class ShardingPlan:
    """Regex name -> spec rules (the group2ctx analog: declarative
    placement). The first rule whose pattern matches and whose spec fits
    the shape wins; else ``default`` (replicated)."""

    def __init__(self, rules: Sequence[Tuple[str, Any]], default=None):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.default = default if default is not None else P()

    def spec_for(self, name: str, shape: Tuple[int, ...]):
        for pat, spec in self.rules:
            if pat.search(name):
                if len(spec) > len(shape):
                    continue
                return spec
        return self.default

    def shard_params(self, named_arrays: Dict[str, Any], mesh):
        """Global tensors -> this rank's blocks, by name."""
        return {name: local_block(arr, self.spec_for(name, arr.shape), mesh)
                for name, arr in named_arrays.items()}


# Megatron-style tensor-parallel rules for transformer weights:
# column-parallel qkv/up projections, row-parallel out/down projections.
MP_RULES_TRANSFORMER = [
    (r"(wq|wk|wv|w_qkv|query|key|value|up_proj|fc1|ffn_in)", P(None, "tp")),
    (r"(wo|out_proj|down_proj|fc2|ffn_out)", P("tp", None)),
    (r"(embed|embedding|lm_head)", P(None, "tp")),
]
