"""Device meshes over the ranks of a process group (ref: the JAX package's
``parallel/mesh.py``).

The JAX package declares a ``jax.sharding.Mesh`` of devices and lets
GSPMD place the collectives. The port has no GSPMD: a :class:`Mesh` here
is a grid of the launched group's **ranks** (one process a mesh slot),
with one ``torch.distributed`` subgroup per mesh axis and position, and
the collectives of ``parallel/collectives.py`` run explicitly over those
subgroups. A tensor a rank holds under a mesh is its **local block**
(``parallel/sharding.py`` cuts a global array into blocks and gathers
them back), where a JAX array under a mesh is global.

Axis names, as in the JAX package: ``dp`` data, ``tp`` tensor, ``pp``
pipeline stage, ``sp`` sequence, ``ep`` expert parallel. The rank at mesh
coordinate ``(i0, i1, ...)`` is ``i0 * s1 * s2 ... + i1 * s2 ... + ...``
(row-major, the last axis innermost), as ``np.reshape`` lays the JAX
package's device list out.

A world of one process needs no group: every axis of size 1, no
subgroup, and every collective the identity its definition gives at one
rank.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as _np

from ..base import check

__all__ = ["Mesh", "make_mesh", "auto_mesh", "local_devices", "MeshScope",
           "current_mesh", "axis_size"]

_CURRENT = threading.local()


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _world() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


def _rank() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def local_devices():
    """The ranks of the group, ``[0, world)`` (the JAX package lists its
    devices)."""
    return list(range(_world()))


class Mesh:
    """A named grid of the group's ranks.

    ``axis_names`` and ``devices`` (an integer array of ranks whose shape
    is the mesh shape) match the JAX ``Mesh``'s attributes, so code that
    reads ``dict(zip(mesh.axis_names, mesh.devices.shape))`` reads the
    same sizes. :meth:`group` is this rank's subgroup along an axis
    (``None`` at size 1 or outside a group), :meth:`axis_index` its
    position there, :meth:`axis_ranks` the global ranks of that line."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        self.devices = _np.asarray(ranks, dtype=_np.int64)
        self.axis_names = tuple(axis_names)
        check(self.devices.ndim == len(self.axis_names),
              f"mesh: {self.devices.ndim}-d rank grid for axes "
              f"{self.axis_names}")
        check(len(set(self.axis_names)) == len(self.axis_names),
              f"mesh: repeated axis name in {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        me = _rank()
        check(me in set(self.devices.reshape(-1).tolist()),
              f"mesh: rank {me} is not in the mesh's ranks")
        self._coord = {a: int(i) for a, i in zip(
            self.axis_names, _np.argwhere(self.devices == me)[0])}
        self._groups: Dict[str, object] = {}
        self._lines: Dict[str, list] = {}
        self._build_groups()

    def _build_groups(self) -> None:
        """One subgroup per axis line. ``new_group`` is collective over
        the whole world: every rank creates every line's group, in the
        same order, and keeps the one it belongs to."""
        d = _dist()
        world = _world()
        for ax_i, ax in enumerate(self.axis_names):
            moved = _np.moveaxis(self.devices, ax_i, -1)
            lines = moved.reshape(-1, moved.shape[-1]).tolist()
            mine = next(ln for ln in lines if _rank() in ln)
            self._lines[ax] = [int(r) for r in mine]
            if d is None or len(mine) == 1:
                self._groups[ax] = None
                continue
            if len(mine) == world and len(lines) == 1:
                self._groups[ax] = d.group.WORLD
                continue
            for ln in lines:
                g = d.new_group([int(r) for r in ln])
                if _rank() in ln:
                    self._groups[ax] = g

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 for an axis the mesh
        lacks)."""
        return self._coord.get(axis, 0)

    def axis_ranks(self, axis: str) -> list:
        """The global ranks of this rank's line along ``axis``, in axis
        order."""
        return list(self._lines.get(axis, [_rank()]))

    def group(self, axis: str):
        """The subgroup of this rank's line along ``axis``; None when the
        axis has size 1 (or is absent): nothing to communicate."""
        return self._groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """A mesh from ``{axis_name: size}`` over the group's ranks (or the
    given rank list). Sizes multiply to at most the rank count; one axis
    may be -1, inferred from the rest."""
    ranks = list(devices if devices is not None else local_devices())
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    n = len(ranks)
    if -1 in sizes:
        known = int(_np.prod([s for s in sizes if s != -1]))
        check(n % known == 0, f"cannot infer mesh axis: {n} devices, {axes}")
        sizes[sizes.index(-1)] = n // known
    total = int(_np.prod(sizes))
    check(total <= n,
          f"mesh {dict(zip(names, sizes))} needs {total} devices, have {n}")
    check(total == n or _world() == 1 or total == _world(),
          f"mesh {dict(zip(names, sizes))} covers {total} of the group's "
          f"{_world()} ranks: a mesh spans the whole group")
    return Mesh(_np.asarray(ranks[:total]).reshape(sizes), names)


def auto_mesh(n_devices: Optional[int] = None,
              prefer: Sequence[str] = ("dp", "tp")) -> Mesh:
    """Split the ranks between dp and tp, tp innermost (the JAX rule)."""
    ranks = local_devices()
    n = n_devices or len(ranks)
    tp = 1
    for cand in (4, 2):
        if n % cand == 0 and len(prefer) > 1:
            tp = cand
            break
    axes = {prefer[0]: n // tp}
    if len(prefer) > 1:
        axes[prefer[1]] = tp
    return make_mesh(axes, ranks[:n])


class MeshScope:
    """Context manager installing a mesh as current (per thread)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        stack = getattr(_CURRENT, "stack", None)
        if stack is None:
            stack = _CURRENT.stack = []
        stack.append(self.mesh)
        return self.mesh

    def __exit__(self, *a):
        _CURRENT.stack.pop()


def current_mesh():
    stack = getattr(_CURRENT, "stack", None)
    return stack[-1] if stack else None


def axis_size(mesh, axis: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(axis, 1)
