"""``shard_map`` for rank-local code (ref: the JAX package's
``parallel/compat.py``).

The JAX ``shard_map`` takes global arrays, hands ``f`` each device's
blocks per ``in_specs`` and reassembles the outputs per ``out_specs``.
In the port every rank already holds its blocks, so :func:`shard_map`
runs ``f`` on them directly, with the mesh installed as the current one
(``mesh.MeshScope``) so that :func:`axis_index` and the mesh collectives
of ``parallel/collectives.py`` (``allreduce``, ``allgather``,
``reduce_scatter``, ``ppermute_ring``, ``all_to_all``, ``broadcast``)
reach it. The specs are checked for form only; ``check_vma`` and
``axis_names`` are accepted for the JAX signature and have no effect
(there is no replication checker and no automatic axis).
"""
from __future__ import annotations

from ..base import check
from .mesh import MeshScope, current_mesh

__all__ = ["shard_map", "HAVE_SHARD_MAP", "axis_index"]

HAVE_SHARD_MAP = True


def axis_index(axis: str, mesh=None) -> int:
    """This rank's index along ``axis`` of ``mesh`` (default: the current
    mesh), ``jax.lax.axis_index``'s counterpart."""
    mesh = mesh if mesh is not None else current_mesh()
    check(mesh is not None, "axis_index outside a mesh (shard_map or "
          "MeshScope)")
    return mesh.axis_index(axis)


def shard_map(f, mesh, in_specs, out_specs, check_vma=None,
              axis_names=None):
    """``f`` over this rank's blocks, with ``mesh`` current."""
    names = set(mesh.axis_names)
    for spec in (in_specs if isinstance(in_specs, (tuple, list))
                 else (in_specs,)):
        for entry in tuple(spec or ()):
            for ax in (entry if isinstance(entry, (tuple, list))
                       else (entry,)):
                check(ax is None or ax in names,
                      f"shard_map: spec names axis {ax!r}, mesh has "
                      f"{mesh.axis_names}")

    def run(*args):
        check(not isinstance(in_specs, (tuple, list)) or
              len(in_specs) == len(args),
              f"shard_map: {len(args)} inputs for {len(in_specs)} specs")
        with MeshScope(mesh):
            return f(*args)
    return run
