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

While the collective ledger is on (``MXTPU_COLL_HEALTH`` /
``MXTPU_COLL_TIMEOUT_S``, ``telemetry/collective.py``) every function
above is one ledger record, and inside a group it starts with an arrival
handshake over the group's ``TCPStore`` (:func:`_arrive`): each rank sets
its key for the call and waits for every peer's in rank order, stamping
the peer it waits on, so a hung collective's flight record names the
rank that never arrived. Off, the cost is one flag check a call.

**The mesh collectives** (:func:`allreduce`, :func:`allgather`,
:func:`reduce_scatter`, :func:`broadcast`, :func:`ppermute_ring`,
:func:`all_to_all`, :func:`device_allreduce`,
:func:`measure_allreduce_bandwidth`, ``barrier(mesh)``) take a
``parallel/mesh.py`` mesh and run over the subgroup of one of its axes,
on this rank's **local block** (the JAX functions take global arrays and
split them by their specs). Each differentiable one is a
``torch.autograd.Function`` whose backward is its transpose, as JAX
differentiates its collectives: a rank's loss is its own contribution
and the group's loss is their sum, so the sum all-reduce's backward is
the sum all-reduce of the gradients, the all-gather's the reduce-scatter,
the reduce-scatter's the all-gather, a ring shift's the inverse shift
and an all-to-all's the all-to-all with the split and concat axes
swapped. Over gloo a CUDA block is staged through a host copy, explicitly
(gloo's point-to-point calls take host tensors only), and
:data:`wire_bytes` counts the bytes each rank hands the backend.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import pickle
import socket
import time
from typing import List, Optional

import numpy as np
import torch

from ..base import check

__all__ = ["world", "rank", "backend", "cross_process_allreduce",
           "cross_process_allgather", "cross_process_allgather_ragged",
           "cross_process_reduce_scatter",
           "cross_process_exchange_bytes", "cross_process_allgather_object",
           "cross_process_reform", "barrier", "loopback_psum",
           "allreduce", "allgather", "reduce_scatter", "broadcast",
           "ppermute_ring", "all_to_all", "device_allreduce",
           "measure_allreduce_bandwidth", "make_host_mesh", "wire_bytes",
           "reset_wire_bytes"]

_seq = itertools.count()

#: how many reductions each route took (tests and chip_smoke.py read it)
routes = {"tiled": 0, "segments": 0, "allreduce_slice": 0}

#: bytes this rank handed the backend in the mesh collectives, by op, and
#: the bytes staged through host memory (gloo with CUDA blocks)
wire_bytes = {"allreduce": 0, "allgather": 0, "reduce_scatter": 0,
              "ppermute": 0, "all_to_all": 0, "host_staged": 0}

_arrive_seq = itertools.count()


def reset_wire_bytes() -> None:
    for k in wire_bytes:
        wire_bytes[k] = 0


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


def _store():
    from .. import kvstore_server
    return kvstore_server._group.get("store")


def _arrive(tok, n: int) -> None:
    """The arrival handshake of cross-process call ``n`` (ledger on, in a
    group): set this rank's key, then wait for every peer's in rank
    order, stamping the peer waited on into the ledger record. Each rank
    deletes its key of call ``n - 2``: every peer read it before setting
    its own key of call ``n - 1``, which this rank has seen."""
    from ..telemetry import collective as _cl
    st = _store()
    if st is None:
        return
    me, nproc = rank(), world()
    st.set(f"mxc/{n}/{me}", "1")
    for r in range(nproc):
        if r == me:
            continue
        _cl.note_waiting(tok, r)
        st.wait([f"mxc/{n}/{r}"])
    if n >= 2:
        st.delete_key(f"mxc/{n - 2}/{me}")


@contextlib.contextmanager
def _collective(kind: str, nbytes: int = 0):
    """One cross-process collective under the ledger (module docstring);
    a bare ``yield`` when the plane is off."""
    from ..telemetry import collective as _cl
    if not _cl.enabled():
        yield
        return
    n = next(_arrive_seq)
    tok = _cl.enter(kind, f"c{n}", int(nbytes), rank())
    try:
        if _dist() is not None:
            _arrive(tok, n)
            _cl.note_waiting(tok, "backend")
        yield
    finally:
        _cl.exit_(tok)


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size())


_OPS = {"sum": "SUM", "mean": "SUM", "max": "MAX", "min": "MIN"}


def cross_process_allreduce(local: torch.Tensor, op: str = "sum"):
    """Reduce ``local`` across the ranks, in place, and return it: the
    dist kvstore's push (each worker holds its merged gradient; every
    worker gets the sum)."""
    check(op in _OPS, f"unknown reduce op {op}")
    d = _dist()
    if d is None:
        return local
    with _collective("allreduce", _nbytes(local)):
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
    with _collective("allgather", _nbytes(local)):
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
    with _collective("allgather", _nbytes(buf)):
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
    with _collective("reduce_scatter", _nbytes(send)):
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
            with _collective("reduce_scatter", _nbytes(wire)):
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
    with _collective("exchange", len(payload)):
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
    wait for the card's queued work. ``mesh``: every rank of the mesh
    (the group it spans) meets."""
    d = _dist()
    if d is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    with _collective("barrier"):
        if backend() == "nccl":
            d.barrier(device_ids=[torch.cuda.current_device()])
        else:
            d.barrier()


# ---------------------------------------------------------------------------
# Mesh collectives: over one axis of a parallel/mesh.py mesh, on local blocks
# ---------------------------------------------------------------------------

def _axis(mesh, axis: str):
    """``(group, size, index)`` of this rank along ``axis``."""
    check(mesh is not None and hasattr(mesh, "axis_size"),
          f"a mesh collective needs a parallel/mesh.py Mesh, got "
          f"{type(mesh).__name__}")
    check(axis in mesh.axis_names,
          f"mesh {mesh.shape} has no axis {axis!r}")
    return mesh.group(axis), mesh.axis_size(axis), mesh.axis_index(axis)


def _staged(group, t: torch.Tensor):
    """``t`` as the backend of ``group`` takes it: a host copy under gloo
    when ``t`` is on the card (counted), else ``t`` itself."""
    if t.is_cuda and _group_backend(group) == "gloo":
        wire_bytes["host_staged"] += _nbytes(t)
        return t.detach().cpu()
    return t


def _group_backend(group) -> str:
    d = _dist()
    return str(d.get_backend(group))


def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return host.to(like.device, non_blocking=False) \
        if host.device != like.device else host


def _raw_allreduce(x, group, op="sum", kind="allreduce"):
    d = _dist()
    wire_bytes[kind] += _nbytes(x)
    buf = _staged(group, x.contiguous().clone())
    with _collective(kind, _nbytes(x)):
        d.all_reduce(buf, op=getattr(d.ReduceOp, _OPS[op]), group=group)
    return _back(buf, x)


def _raw_allgather(x, group, n, dim):
    d = _dist()
    wire_bytes["allgather"] += _nbytes(x)
    src = _staged(group, x.contiguous())
    parts = [torch.empty_like(src) for _ in range(n)]
    with _collective("allgather", _nbytes(x)):
        d.all_gather(parts, src, group=group)
    return _back(torch.cat(parts, dim=dim), x)


def _raw_reduce_scatter(x, group, n, idx, dim):
    check(x.shape[dim] % n == 0,
          f"reduce_scatter: dimension {dim} of {tuple(x.shape)} does not "
          f"split over {n} ranks")
    full = _raw_allreduce(x, group, kind="reduce_scatter")
    return full.chunk(n, dim=dim)[idx].contiguous()


def _raw_ppermute(x, mesh, axis, shift):
    """Rank at axis index i sends to i + shift, receives from i - shift
    (mod n): one paired isend / irecv a rank."""
    d = _dist()
    group, n, idx = _axis(mesh, axis)
    ranks = mesh.axis_ranks(axis)
    dst, src = ranks[(idx + shift) % n], ranks[(idx - shift) % n]
    send = _staged(group, x.contiguous())
    recv = torch.empty_like(send)
    wire_bytes["ppermute"] += _nbytes(x)
    with _collective("ppermute", _nbytes(x)):
        if dst == src == d.get_rank():
            recv.copy_(send)
        else:
            reqs = d.batch_isend_irecv([
                d.P2POp(d.isend, send, dst, group=group),
                d.P2POp(d.irecv, recv, src, group=group)])
            for r in reqs:
                r.wait()
    return _back(recv, x)


def _raw_all_to_all(x, group, n, split_axis, concat_axis):
    check(x.shape[split_axis] % n == 0,
          f"all_to_all: dimension {split_axis} of {tuple(x.shape)} does "
          f"not split over {n} ranks")
    d = _dist()
    src = _staged(group, x)
    ins = [c.contiguous() for c in src.chunk(n, dim=split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    wire_bytes["all_to_all"] += _nbytes(x)
    with _collective("all_to_all", _nbytes(x)):
        if src.is_cuda or _group_backend(group) != "gloo":
            d.all_to_all(outs, ins, group=group)
        else:
            # gloo has no all_to_all of tensor lists on every build: one
            # paired isend / irecv per peer, in rank order
            ranks = d.get_process_group_ranks(group)
            me = ranks.index(d.get_rank())
            ops = []
            for j, r in enumerate(ranks):
                if j == me:
                    outs[j].copy_(ins[j])
                    continue
                ops.append(d.P2POp(d.isend, ins[j], r, group=group))
                ops.append(d.P2POp(d.irecv, outs[j], r, group=group))
            if ops:
                for req in d.batch_isend_irecv(ops):
                    req.wait()
    return _back(torch.cat(outs, dim=concat_axis), x)


class _AllReduce(torch.autograd.Function):
    """Sum (or mean) over the group; backward: the same reduction of the
    gradients (JAX's psum transpose)."""

    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        n = _dist().get_world_size(group)
        out = _raw_allreduce(x, group, "sum" if op == "mean" else op)
        return out / n if op == "mean" else out

    @staticmethod
    def backward(ctx, g):
        check(ctx.op in ("sum", "mean"),
              f"allreduce op {ctx.op!r} has no gradient")
        return _AllReduce.apply(g, ctx.group, ctx.op), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, idx, dim):
        ctx.args = (group, n, idx, dim)
        return _raw_allgather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, idx, dim = ctx.args
        return _ReduceScatter.apply(g, group, n, idx, dim), None, None, \
            None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, idx, dim):
        ctx.args = (group, n, idx, dim)
        return _raw_reduce_scatter(x, group, n, idx, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, idx, dim = ctx.args
        return _AllGather.apply(g, group, n, idx, dim), None, None, None, \
            None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.args = (mesh, axis, shift)
        return _raw_ppermute(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.args
        return _PPermute.apply(g, mesh, axis, -shift), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, split_axis, concat_axis)
        return _raw_all_to_all(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis = ctx.args
        return _AllToAll.apply(g, group, n, concat_axis, split_axis), \
            None, None, None, None


def allreduce(x, mesh, axis: str = "dp", op: str = "sum"):
    """AllReduce this rank's value over ``axis`` (ref: the kvstore
    push + pull round trip): every rank of the line gets the sum (mean,
    max, min). Differentiable for sum and mean."""
    check(op in _OPS, f"unknown reduce op {op}")
    group, n, _ = _axis(mesh, axis)
    if group is None:
        return x
    if op in ("max", "min"):
        return _raw_allreduce(x.detach(), group, op)
    return _AllReduce.apply(x, group, op)


def device_allreduce(arrays, mesh, axis: str = "dp", op: str = "sum"):
    """Fused allreduce of a list of tensors: one flat buffer, one
    collective (the reference's grouped NCCL launches)."""
    check(op in ("sum", "mean"), f"device_allreduce: op {op!r}")
    arrays = list(arrays)
    group, n, _ = _axis(mesh, axis)
    if group is None or not arrays:
        return tuple(arrays)
    flat = torch.cat([a.reshape(-1) for a in arrays])
    flat = _AllReduce.apply(flat, group, op)
    out, off = [], 0
    for a in arrays:
        out.append(flat[off:off + a.numel()].view(a.shape))
        off += a.numel()
    return tuple(out)


def allgather(x, mesh, axis: str = "dp", tiled_axis: int = 0):
    """Concatenate the line's blocks along ``tiled_axis`` (every rank gets
    the whole); backward: a reduce-scatter."""
    group, n, idx = _axis(mesh, axis)
    if group is None:
        return x
    return _AllGather.apply(x, group, n, idx, tiled_axis % x.dim())


def reduce_scatter(x, mesh, axis: str = "dp", scatter_axis: int = 0):
    """Sum the line's values and keep this rank's chunk along
    ``scatter_axis``; backward: an all-gather."""
    group, n, idx = _axis(mesh, axis)
    if group is None:
        return x
    return _ReduceScatter.apply(x, group, n, idx, scatter_axis % x.dim())


def broadcast(x, mesh, axis: str = "dp", root: int = 0):
    """Every rank of the line gets the value of axis index ``root`` (ref:
    kvstore pull): the masked sum of the JAX function (an all-reduce on
    the wire), and its gradient."""
    group, n, idx = _axis(mesh, axis)
    if group is None:
        return x
    masked = x if idx == root else x * 0
    return _AllReduce.apply(masked, group, "sum")


def ppermute_ring(x, mesh, axis: str = "sp", shift: int = 1):
    """Ring rotation along ``axis``: the block of axis index i moves to
    i + shift (the building block of ring attention); backward: the
    inverse rotation."""
    group, n, _ = _axis(mesh, axis)
    if group is None or shift % n == 0:
        return x
    return _PPermute.apply(x, mesh, axis, int(shift))


def all_to_all(x, mesh, axis: str = "sp", split_axis: int = 1,
               concat_axis: int = 0):
    """Tiled all-to-all over ``axis``: this block splits into n chunks
    along ``split_axis``, chunk j goes to axis index j, and the received
    chunks are concatenated along ``concat_axis`` in axis order
    (DeepSpeed-Ulysses' exchange, the expert dispatch of
    ``parallel/moe.py``); backward: the swapped all-to-all."""
    group, n, _ = _axis(mesh, axis)
    if group is None:
        return x
    return _AllToAll.apply(x, group, n, split_axis % x.dim(),
                           concat_axis % x.dim())


def make_host_mesh():
    """A 1-D ``hosts`` mesh of every rank of the group: the communication
    domain of per-process values."""
    from .mesh import Mesh, local_devices
    return Mesh(np.asarray(local_devices()), ("hosts",))


def measure_allreduce_bandwidth(mesh, size_mb: float = 64.0,
                                axis: str = "dp", iters: int = 10,
                                shapes=None, device=None):
    """Allreduce bandwidth in GB/s a rank with the reference's formula
    ``2(n-1)/n * size / t`` (ref: tools/bandwidth/measure.py:138), over
    one flat ``size_mb`` f32 buffer or one buffer per shape in
    ``shapes`` (fused into one collective). ``device``: where the
    buffers live (default the current context's)."""
    from ..context import resolve_device
    dev = resolve_device(device)
    group, n, _ = _axis(mesh, axis)
    if shapes is None:
        arrays = [torch.ones(int(size_mb * 1e6 / 4), device=dev)]
    else:
        arrays = [torch.ones(s, device=dev) for s in shapes]
    total = sum(_nbytes(a) for a in arrays)
    with torch.no_grad():
        device_allreduce(arrays, mesh, axis=axis)    # warm
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = device_allreduce(arrays, mesh, axis=axis)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / iters
    del out
    if n <= 1:
        return 0.0
    return 2 * (n - 1) / n * total / dt / 1e9
