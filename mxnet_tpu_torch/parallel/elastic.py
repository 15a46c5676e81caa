"""Elastic world-size training, the one-process half (ref: the JAX
package's ``parallel/elastic.py``).

Every checkpoint's ``meta.json`` carries a ``topology`` record
(:func:`topology_record`): world size and rank, the data-shard layout
(``num_parts`` / ``part_index`` / per-rank batch size), the run's global
sample position and whether the trainer states are in the
topology-portable format. On resume ``fit.FitLoop`` holds the record
against :func:`current_topology` before any state is loaded
(``fault.CheckpointManager.restore(meta_check=...)``): a layout change
re-splits the data position (:func:`resplit_batches`), and a world
change raises :class:`TopologyMismatchError` unless
``MXTPU_ELASTIC=on``.

The world is the kvstore's group (``num_workers`` > 1), else a simulated
ZeRO world (``MXTPU_ZERO_WORLD``), else 1. A world change under
``MXTPU_ELASTIC=on`` is honoured by :func:`begin_resize`: the relaunched
group (a ``torch.distributed`` group cannot change its size, so a resize
is always a relaunch, by hand or by ``parallel/supervisor.py``) exchanges
its membership roster (:func:`reform_group`, through
``collectives.cross_process_reform``: a wrong-sized roster raises at
resume, not at the first training collective), the comm planes reset
(:func:`reset_comm_state`) and ``mxtpu_elastic_resizes_total`` counts the
resize.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..base import MXNetError, env_switch

__all__ = ["TopologyMismatchError", "elastic_enabled", "current_topology",
           "topology_record", "check_restore", "resplit_batches",
           "reform_group", "reset_comm_state", "begin_resize",
           "resize_request", "world_for_fingerprint"]


class TopologyMismatchError(MXNetError):
    """A checkpoint's recorded topology is incompatible with the resuming
    process: the trainer states on disk are rank-sharded (not the
    gather-on-save portable format) and the world size changed, the
    world changed without ``MXTPU_ELASTIC=on``, or the recorded data
    position cannot be re-split across the new rank count. Raised BEFORE
    any parameter or optimizer state is loaded — a topology-incompatible
    artifact must never be silently loaded as the wrong shard."""


def elastic_enabled() -> bool:
    """Strict ``MXTPU_ELASTIC`` parse — a typo'd opt-in must not silently
    resume a resized run mis-split (the MXTPU_ZERO discipline)."""
    return env_switch("MXTPU_ELASTIC")


def _shard_source(data_iter):
    """The iterator actually carrying the shard layout: unwrap the
    common single-base wrapper chains (``DeviceStagingIter._base``,
    ``ResizeIter.data_iter``) until an object exposing ``num_parts`` is
    found — a staged sharded NDArrayIter must not record num_parts=1
    and silently skip the elastic re-split."""
    it, hops = data_iter, 0
    while it is not None and hops < 8:
        if hasattr(it, "num_parts"):
            return it
        it = getattr(it, "_base", None) or getattr(it, "data_iter", None)
        hops += 1
    return data_iter


def current_topology(trainer=None, data_iter=None) -> Dict[str, Any]:
    """The RESUMING process's topology: collective world/rank (a real
    group when the trainer's kvstore spans >1 worker, else the simulated
    ``MXTPU_ZERO_WORLD``, else 1) and the data-shard layout read off the
    iterator (``num_parts``/``part_index``/``batch_size``; 1/0/0 for
    iterators without sharding; wrappers are unwrapped to the sharded
    base). Forces the trainer's lazy kvstore up — a world-size
    comparison against an uninitialized store would read a multi-worker
    resume as world 1."""
    kv = getattr(trainer, "_kvstore", None) if trainer is not None else None
    if kv is None and trainer is not None and \
            getattr(trainer, "_kvstore_arg", None) is not None and \
            not getattr(trainer, "_kv_initialized", True):
        trainer._init_kvstore()
        kv = getattr(trainer, "_kvstore", None)
    world, rank, distributed = 1, 0, False
    nw = int(getattr(kv, "num_workers", 1) or 1)
    if nw > 1:
        world, rank, distributed = nw, int(kv.rank), True
    else:
        from . import zero as _zero
        world = _zero.simulated_world() or 1
    src = _shard_source(data_iter)
    return {
        "world": world,
        "rank": rank,
        "distributed": distributed,
        "num_parts": int(getattr(src, "num_parts", 1) or 1),
        "part_index": int(getattr(src, "part_index", 0) or 0),
        "batch_size": int(getattr(src, "batch_size", 0) or 0),
    }


def topology_record(trainer=None, data_iter=None, batches: int = 0,
                    resize_to: Optional[int] = None) -> Dict[str, Any]:
    """The ``meta.json`` topology record written with every checkpoint.
    ``batches`` is the LOCAL batch count consumed this epoch (FitLoop's
    per-rank counter); the record converts it to the world-independent
    global sample position ``batches × num_parts × batch_size`` — the
    number a resume at ANY rank count re-splits from. ``portable_states``
    marks whether the trainer serializes through the gather-on-save
    topology-portable format (``get_states_bytes``); a record without it
    pins the checkpoint to its birth world."""
    cur = current_topology(trainer, data_iter)
    rec: Dict[str, Any] = dict(cur)
    rec["global_samples"] = (int(batches) * cur["num_parts"] *
                             cur["batch_size"]) \
        if cur["batch_size"] else None
    rec["batches"] = int(batches)
    # True for every checkpoint this framework's Trainer writes (its
    # serialization IS gather-on-save); the guard exists for artifacts
    # from other writers — forged/legacy meta carrying False, or
    # rank-local dumps a foreign tool stamped as sharded. No trainer =
    # no trainer states on disk = nothing shard-shaped to mis-load.
    rec["portable_states"] = bool(
        trainer is None or
        getattr(trainer, "get_states_bytes", None) is not None)
    if resize_to is not None:
        rec["resize_to"] = int(resize_to)
    return rec


def resize_request(meta: Optional[Dict[str, Any]]) -> Optional[int]:
    """The world size a checkpoint ASKS to be resumed at, or None.

    A chaos/operator ``resize@N:M`` run exits resumably after stamping
    ``resize_to: M`` into its final checkpoint's topology record — this
    is the supervisor-facing read of that request (it relaunches the
    group at M instead of the old world). A record without a topology,
    or one whose ``resize_to`` is absent/unparseable, is 'no request'
    (resume at the surviving world) rather than an error: the supervisor
    consumes checkpoints it did not write."""
    if not isinstance(meta, dict):
        return None
    topo = meta.get("topology")
    if not isinstance(topo, dict):
        return None
    rz = topo.get("resize_to")
    try:
        rz = int(rz) if rz is not None else None
    except (TypeError, ValueError):
        return None
    return rz if rz and rz >= 1 else None


def check_restore(topo: Optional[Dict[str, Any]],
                  cur: Dict[str, Any]) -> bool:
    """The restore-time gate (``fault.CheckpointManager.restore``'s
    ``meta_check`` hook runs this BEFORE any state is loaded). Returns
    True when the checkpoint's world differs from the resuming world and
    the resume may proceed elastically; False when the topology is
    unchanged (or unrecorded — legacy checkpoints resume as before).
    Raises :class:`TopologyMismatchError` when the change is one this
    process must not silently honor."""
    if not topo:
        return False
    old_world = int(topo.get("world", cur["world"]))
    if old_world == int(cur["world"]):
        return False
    if not topo.get("portable_states", True):
        raise TopologyMismatchError(
            f"checkpoint was saved at world {old_world} with NON-portable "
            f"(rank-sharded) trainer states; restoring it at world "
            f"{cur['world']} would load the wrong shard. Re-save it "
            "through the gather-on-save path (Trainer.get_states_bytes) "
            "or resume at the original world size.")
    if not elastic_enabled():
        raise TopologyMismatchError(
            f"checkpoint topology is world {old_world} but this process "
            f"is world {cur['world']}; set MXTPU_ELASTIC=on to resume "
            "across a world-size change (or relaunch at the original "
            "size). Refusing to silently resume mis-split.")
    return True


def resplit_batches(topo: Dict[str, Any], cur: Dict[str, Any],
                    restored_batches: int) -> int:
    """LOCAL batches each new rank fast-forwards in the restored epoch.

    The per-rank stream is defined over GLOBAL batch indices (local
    batch ``t`` of rank ``r`` = global batch ``t·P + r``, ``P`` data
    shards), so the union of all ranks' streams is the plain seeded
    (seed, epoch) order whatever ``P`` is. When the shard layout is
    unchanged the restored local count is already correct; otherwise the
    recorded global sample position must split evenly over the new
    ``P × batch_size`` stride — a position mid-global-batch cannot be
    resumed without duplicating or dropping samples, so it raises."""
    old_parts = int(topo.get("num_parts", 1) or 1)
    old_bs = int(topo.get("batch_size", 0) or 0)
    if old_parts == cur["num_parts"] and \
            (not old_bs or old_bs == cur["batch_size"]):
        return int(restored_batches)
    gs = topo.get("global_samples")
    stride = cur["num_parts"] * cur["batch_size"]
    if gs is None or stride <= 0:
        raise TopologyMismatchError(
            "elastic resume: the checkpoint carries no global sample "
            "position (or the resuming iterator has no batch size) — "
            "the data stream cannot be re-split across "
            f"{cur['num_parts']} shard(s).")
    gs = int(gs)
    if gs % stride != 0:
        raise TopologyMismatchError(
            f"elastic resume: global sample position {gs} does not "
            f"split over the new stride {cur['num_parts']} shards x "
            f"{cur['batch_size']} samples = {stride}; resuming would "
            "duplicate or drop samples. Pick a per-rank batch size "
            "whose global batch divides the old one's positions.")
    return gs // stride


def reform_group(cur: Dict[str, Any], tag: str = "") -> Dict[str, Any]:
    """Re-form the collective group after a resize: every rank of a real
    group publishes its membership record and reads the roster back
    (``collectives.cross_process_reform``); the exchange is the
    rendezvous, and a roster of another size than ``cur["world"]``
    raises here. A simulated world (one process playing every rank)
    re-forms trivially."""
    if cur["distributed"]:
        from .collectives import cross_process_reform
        roster = cross_process_reform(tag or "elastic",
                                      expect=cur["world"])
        return {"reformed": True,
                "members": [int(m["rank"]) for m in roster]}
    return {"reformed": True, "members": list(range(cur["world"]))}


def reset_comm_state() -> None:
    """Drop the per-fit comm-health and clock-sync state across a resize:
    rank indices name other processes after it, so a skew table or clock
    offset from before would fabricate stragglers. FitLoop re-runs the
    clock handshake for the new group at fit start."""
    from ..telemetry import collective as _coll
    from ..telemetry.tracer import tracer as _tr
    _coll.reset_health()
    _coll.ledger.clock_offset_ms = 0.0
    _tr.clock_offset_ms = 0.0


def _resize_counter():
    from ..telemetry import default_registry
    return default_registry().counter(
        "mxtpu_elastic_resizes_total",
        "Elastic resumes honored across a world-size change.")


def begin_resize(topo: Dict[str, Any], cur: Dict[str, Any]) -> Dict[str, Any]:
    """Honour a detected world-size change (``check_restore`` returned
    True): re-form the group, reset the comm planes, count the resize.
    Returns the ``FitResult.elastic`` summary."""
    membership = reform_group(cur, tag=f"rz{topo.get('world')}")
    reset_comm_state()
    _resize_counter().inc()
    return {
        "from_world": int(topo.get("world", 0)),
        "world": int(cur["world"]),
        "rank": int(cur["rank"]),
        "members": membership["members"],
        "resize_to": topo.get("resize_to"),
    }


def world_for_fingerprint() -> int:
    """The world size stamped into the run report's fingerprint: the
    group's size when this process is in one, else the simulated ZeRO
    world, else 1."""
    from . import collectives as _c
    if _c.world() > 1:
        return _c.world()
    from . import zero as _zero
    return _zero.simulated_world() or 1
