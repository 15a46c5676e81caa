"""Cross-process collectives over ``torch.distributed`` (ref: the JAX
package's ``parallel/collectives.py``, its cross-process half; the
reference's kvstore comm stack, src/kvstore/comm.h, kvstore_nccl.h and
the ps-lite push/pull of kvstore_dist.h).

Every function here works on the default process group that
``kvstore_server.join_group`` joined, on torch tensors in place, on the
tensors' own device: NCCL on the card; gloo on the host, or on the card
where ranks share one (PyTorch 2.11's gloo takes CUDA tensors for every
collective this module calls on it: all-reduce, all-gather, all-to-all,
broadcast, so nothing stages through a host copy of its own). Outside a
group (world 1, no group joined) each collective is the identity its
definition gives at one rank.

- :func:`cross_process_allreduce` sums (or averages, or maxes) a
  per-process tensor in place: the dist kvstore's push.
- :func:`cross_process_allgather` stacks every rank's equal-shaped
  tensor: the wire hop of compressed gradients (packed 2-bit codes).
- :func:`cross_process_reduce_scatter` reduces a flat buffer and returns
  only the ``[lo, hi)`` segments this rank owns: ZeRO-1's gradient
  plane. With every rank's segments (``all_parts``) it takes the true
  reduce-scatter: on NCCL the rank-major tiled layout of
  :func:`_tile_layout` and one ``reduce_scatter_tensor``, when the
  padding costs less than the allreduce it replaces (``world*T < 2n``);
  on gloo :func:`_coord_segment_reduce`, which sends each peer only the
  segments it owns. Otherwise allreduce and slice.
- :func:`cross_process_allgather_ragged` gathers 1-d tensors whose
  lengths differ by rank: ZeRO-1's weight allgather.
- :func:`cross_process_exchange_bytes`, :func:`cross_process_allgather_object`
  carry ragged byte payloads (pickled optimizer-state shards);
  :func:`cross_process_reform` is the membership roster of a group.
- :func:`barrier`; :func:`loopback_psum` is the in-graph collective site
  of a simulated (one-process) group.

Sums at world 2 are ``g0 + g1`` bit for bit in any order; at a larger
world the order of addition is the backend's.

The mesh-taking functions (``allreduce(x, mesh, axis)``,
``ppermute_ring``, ``all_to_all``, ``measure_allreduce_bandwidth``...)
need ``parallel/mesh.py``, the second half of ROADMAP A10, and raise
``NotPortedError``.
"""
from __future__ import annotations

import itertools
import os
import pickle
import socket
from typing import List, Optional

import numpy as np
import torch

from ..base import check
from ..ops.registry import NotPortedError

__all__ = ["world", "rank", "backend", "cross_process_allreduce",
           "cross_process_allgather", "cross_process_allgather_ragged",
           "cross_process_reduce_scatter",
           "cross_process_exchange_bytes", "cross_process_allgather_object",
           "cross_process_reform", "barrier", "loopback_psum",
           "allreduce", "allgather", "reduce_scatter", "broadcast",
           "ppermute_ring", "all_to_all", "device_allreduce",
           "measure_allreduce_bandwidth", "make_host_mesh"]

_seq = itertools.count()

#: how many reductions each route took (tests and chip_smoke.py read it)
routes = {"tiled": 0, "segments": 0, "allreduce_slice": 0}


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def world() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


def rank() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def backend() -> Optional[str]:
    """``"nccl"``, ``"gloo"``, or None outside a group."""
    d = _dist()
    return str(d.get_backend()) if d is not None else None


_OPS = {"sum": "SUM", "mean": "SUM", "max": "MAX", "min": "MIN"}


def cross_process_allreduce(local: torch.Tensor, op: str = "sum"):
    """Reduce ``local`` across the ranks, in place, and return it: the
    dist kvstore's push (each worker holds its merged gradient; every
    worker gets the sum)."""
    check(op in _OPS, f"unknown reduce op {op}")
    d = _dist()
    if d is None:
        return local
    d.all_reduce(local, op=getattr(d.ReduceOp, _OPS[op]))
    if op == "mean":
        local.div_(d.get_world_size())
    return local


def cross_process_allgather(local: torch.Tensor) -> torch.Tensor:
    """Every rank's equal-shaped ``local``, stacked ``(world, ...)`` in
    rank order, on ``local``'s device."""
    d = _dist()
    if d is None:
        return local.unsqueeze(0).clone()
    out = [torch.empty_like(local) for _ in range(d.get_world_size())]
    d.all_gather(out, local.contiguous())
    return torch.stack(out)


def cross_process_allgather_ragged(local: torch.Tensor,
                                   sizes=None) -> List[torch.Tensor]:
    """Every rank's 1-d ``local`` (lengths may differ), rank-indexed, on
    ``local``'s device: ZeRO-1's weight allgather, whose per-rank
    segments are parameter-granular. ``sizes`` (every rank's length,
    when the caller knows them) saves the length exchange."""
    d = _dist()
    if d is None:
        return [local]
    nproc = d.get_world_size()
    if sizes is None:
        n = torch.tensor([local.numel()], dtype=torch.int64,
                         device=local.device)
        got = [torch.empty_like(n) for _ in range(nproc)]
        d.all_gather(got, n)
        sizes = [int(g.item()) for g in got]
    sizes = [int(s) for s in sizes]
    check(sizes[d.get_rank()] == local.numel(),
          f"allgather: this rank's payload has {local.numel()} elements, "
          f"the layout says {sizes[d.get_rank()]}")
    cap = max(sizes + [1])
    buf = local.new_zeros(cap)
    buf[:local.numel()] = local.reshape(-1)
    bufs = [torch.empty_like(buf) for _ in range(nproc)]
    d.all_gather(bufs, buf)
    return [b[:n] for b, n in zip(bufs, sizes)]


def _tile_layout(all_parts, n: int):
    """Rank-major tiled permutation for a ragged reduce-scatter.

    ``all_parts[r]`` is rank r's ``[lo, hi)`` segments of an
    ``n``-element flat buffer (parameter-granular, so per-rank totals
    differ). A tiled reduce-scatter needs EQUAL tiles: the tile size
    ``T`` is the largest per-rank element count, and output slot
    ``r*T + k`` holds the k-th element of rank r's concatenated segments
    (pad slots point at index ``n``, a zero the caller appends). Returns
    ``(counts, T, perm)``, ``perm`` an int64 vector of ``world*T``. The
    tiled path costs ``world*T`` elements on the wire against the
    allreduce's ``~2n``, so callers take it only when ``world*T < 2n``."""
    counts = [sum(hi - lo for lo, hi in ap) for ap in all_parts]
    T = max(counts) if counts else 0
    perm = np.full(len(all_parts) * T, n, dtype=np.int64)
    for r, ap in enumerate(all_parts):
        off = r * T
        for lo, hi in ap:
            perm[off:off + (hi - lo)] = np.arange(lo, hi, dtype=np.int64)
            off += hi - lo
    return counts, T, perm


def loopback_psum(x, contributions=None):
    """In-graph ``psum`` of a loopback (one-process, simulated) group:
    the site where the megastep's graph holds the simulated world's
    gradient reduction, where a real group would run its collective. A
    simulated world plays every rank over shared buffers, so there is
    one contribution and its sum is the identity: no arithmetic node is
    emitted (``-0.0 + 0.0`` would flip sign bits)."""
    parts = [x] if contributions is None else list(contributions)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _segments(t: torch.Tensor, parts) -> List[torch.Tensor]:
    out, off = [], 0
    for lo, hi in parts:
        out.append(t[off:off + (hi - lo)])
        off += hi - lo
    return out


def _coord_segment_reduce(local: torch.Tensor, all_parts) -> List:
    """Gloo's reduce-scatter: each rank sends every peer only the
    segments that peer owns (one all-to-all of per-peer blobs, ``~n``
    elements a rank instead of the full buffer's ``world*n``), then sums
    the blobs it received in rank order. Returns this rank's reduced
    segments in ``all_parts[rank]`` order."""
    d = _dist()
    me, nproc = d.get_rank(), d.get_world_size()
    send = torch.cat([local[lo:hi] for r in range(nproc)
                      for lo, hi in all_parts[r]] or [local[:0]])
    counts = [sum(hi - lo for lo, hi in all_parts[r]) for r in range(nproc)]
    mine = counts[me]
    recv = local.new_empty(mine * nproc)
    d.all_to_all_single(recv, send, output_split_sizes=[mine] * nproc,
                        input_split_sizes=counts)
    blobs = recv.view(nproc, mine)
    total = blobs[0].clone()
    for s in range(1, nproc):
        total = total + blobs[s]
    routes["segments"] += 1
    return _segments(total, all_parts[me])


def cross_process_reduce_scatter(local: torch.Tensor, parts,
                                 op: str = "sum", all_parts=None):
    """Reduce the per-process flat buffer ``local`` element-wise across
    the ranks and return only the ``[lo, hi)`` slices named by ``parts``
    (this rank's segments). Every rank calls with a buffer of the same
    shape and its own ``parts``; ``all_parts`` (every rank's segments,
    the same on all callers) selects the true reduce-scatter (module
    docstring)."""
    check(op == "sum", f"unsupported reduce-scatter op {op!r}")
    d = _dist()
    if d is None:
        return [local[lo:hi] for lo, hi in parts]
    nproc, me = d.get_world_size(), d.get_rank()
    n = int(local.numel())
    if all_parts is not None:
        check(len(all_parts) == nproc,
              f"all_parts covers {len(all_parts)} ranks, world is {nproc}")
        check([tuple(p) for p in parts] ==
              [tuple(p) for p in all_parts[me]],
              "cross_process_reduce_scatter: parts != all_parts[rank] — "
              "the caller's own segments must match the shared layout")
        if backend() == "gloo":
            return _coord_segment_reduce(local, all_parts)
        counts, T, perm = _tile_layout(all_parts, n)
        if T > 0 and nproc * T < 2 * n:
            padded = torch.cat([local, local.new_zeros(1)])
            wire = padded.index_select(
                0, torch.from_numpy(perm).to(local.device))
            tile = local.new_empty(T)
            d.reduce_scatter_tensor(tile, wire)
            routes["tiled"] += 1
            return _segments(tile, parts)
    routes["allreduce_slice"] += 1
    full = cross_process_allreduce(local.clone(), op=op)
    return [full[lo:hi] for lo, hi in parts]


def _byte_device():
    return torch.device("cuda", torch.cuda.current_device()) \
        if backend() == "nccl" else torch.device("cpu")


def cross_process_exchange_bytes(payload: bytes, tag: str = "") -> List:
    """Every rank's byte payload, rank-indexed: the transport for ragged
    payloads (pickled optimizer-state shards) that fixed-shape tensors
    cannot carry. Every rank calls it, in the same order."""
    d = _dist()
    if d is None:
        return [payload]
    nproc, dev = d.get_world_size(), _byte_device()
    size = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(nproc)]
    d.all_gather(sizes, size)
    sizes = [int(s.item()) for s in sizes]
    cap = max(sizes + [1])
    buf = torch.zeros(cap, dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    buf = buf.to(dev)
    bufs = [torch.empty_like(buf) for _ in range(nproc)]
    d.all_gather(bufs, buf)
    return [bytes(b[:n].cpu().numpy().tobytes()) for b, n in
            zip(bufs, sizes)]


def cross_process_allgather_object(obj, tag_prefix: str = "obj") -> List:
    """Ragged allgather of one picklable object a rank (rank-indexed)."""
    blobs = cross_process_exchange_bytes(
        pickle.dumps(obj), f"{tag_prefix}{next(_seq)}")
    return [pickle.loads(b) for b in blobs]


def cross_process_reform(tag: str = "", expect: Optional[int] = None):
    """Membership roster of the group: every rank's ``{rank, pid,
    host}``, sorted by rank. ``expect``: the world size the caller
    resumes at; a group of another size raises here, not at the first
    training collective."""
    rec = {"rank": rank(), "pid": os.getpid(), "host": socket.gethostname()}
    roster = cross_process_allgather_object(rec, tag_prefix=f"rf_{tag}_")
    if expect is not None:
        check(len(roster) == int(expect),
              f"cross_process_reform: {len(roster)} member(s) joined but "
              f"the resume expects world {expect}")
    return sorted(roster, key=lambda m: int(m["rank"]))


def barrier(mesh=None) -> None:
    """Global sync point (ref: ps::Postoffice::Barrier). One process:
    wait for the card's queued work."""
    check(mesh is None, "barrier over a mesh needs parallel/mesh.py "
          "(ROADMAP A10)")
    d = _dist()
    if d is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    if backend() == "nccl":
        d.barrier(device_ids=[torch.cuda.current_device()])
    else:
        d.barrier()


def _needs_mesh(name: str):
    def fn(*args, **kwargs):
        raise NotPortedError(
            f"parallel.collectives.{name} runs over a device mesh, which "
            "is not ported yet (ROADMAP.md, queue A10)")
    fn.__name__ = name
    return fn


allreduce = _needs_mesh("allreduce")
allgather = _needs_mesh("allgather")
reduce_scatter = _needs_mesh("reduce_scatter")
broadcast = _needs_mesh("broadcast")
ppermute_ring = _needs_mesh("ppermute_ring")
all_to_all = _needs_mesh("all_to_all")
device_allreduce = _needs_mesh("device_allreduce")
measure_allreduce_bandwidth = _needs_mesh("measure_allreduce_bandwidth")
make_host_mesh = _needs_mesh("make_host_mesh")
