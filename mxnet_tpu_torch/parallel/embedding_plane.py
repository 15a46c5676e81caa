"""The sparse embedding plane: a giant embedding table trained row-sharded
(ref: the JAX package's ``parallel/embedding_plane.py``; in the reference,
row_sparse storage, KVStore::PullRowSparse and the lazy row-sparse
optimizer updates behind a server-sharded table).

- **Row sharding.** The table is split into contiguous row blocks, one
  per rank (:func:`row_partition`, a pure function of rows and world).
  The world is simulated: this process holds every rank's shard, so the
  whole protocol, the 1/world ledger bytes included, runs on one device.
  The full table is drawn once from a seeded generator on the device and
  then split, so ``plane(world=N).todense()`` is bitwise
  ``plane(world=1).todense()``. (The JAX package draws it with
  ``jax.random``; those bits cannot be drawn without JAX, so a table
  carried across comes through ``convert.load_embedding_plane``.)
- **Deduplicated gradients in a bounded bucket.** A step's ids are
  deduplicated on the host (``np.unique``), their gradient rows summed
  in a fixed order (``ndarray/sparse.segment_sum``) and packed into a
  ``(bucket, dim)`` buffer, the bucket the next power of two capped by
  ``MXTPU_SPARSE_MAX_ROWS``. PyTorch retraces nothing, but the cap and
  its error stay the contract a user sees: a step that touches more
  unique rows raises. The buffer goes through the store's
  ``sparse_plane_exchange`` (the retry and chaos entry of a push; a pure
  read, so a retried flake never applies twice).
- **The row-gathered update.** Each rank whose shard owns a touched row
  steps it through ``optimizer.grouped.sparse_rows_update`` (the SAME
  rule kernel as the dense buckets, on the gathered rows, written back
  with ``index_copy_``), so a step is bitwise the dense-gather reference
  update on the touched rows. A rank's optimizer state is created the
  first time a step touches it, beside its shard: the ledger's
  ``params`` + ``optimizer`` bytes a rank are exactly 1/world of the
  unsharded plane's (owners ``emb<r>/<N>:<table>``).
- **Sentinel and rollback.** A finiteness flag guards every row write
  (``where(flag, new, old)``); :meth:`EmbeddingPlane.rollback_step` undoes
  the host half of a skipped step (the update count, and any rank state
  that step created, with its ledger bytes).

Creating a plane needs ``MXTPU_SPARSE_PLANE=on``. The plane lives outside
``Trainer``: dense towers train through the Trainer, the table through
the plane, in one loop (``examples/recsys/two_tower.py``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as _np
import torch

from ..base import MXNetError, check, env, torch_dtype
from ..context import current_context, resolve_device

__all__ = ["sparse_plane_requested", "sparse_max_rows", "row_partition",
           "row_bucket", "masked_gather", "EmbeddingPlane"]


def sparse_plane_requested() -> bool:
    """Strict ``MXTPU_SPARSE_PLANE`` parse: a typo raises rather than
    falling back."""
    raw = str(env.get("MXTPU_SPARSE_PLANE") or "").strip().lower()
    if raw in ("", "0", "off", "false"):
        return False
    if raw in ("1", "on", "true"):
        return True
    raise MXNetError(
        f"MXTPU_SPARSE_PLANE: unknown value {raw!r} (known: on, off)")


def sparse_max_rows() -> int:
    """``MXTPU_SPARSE_MAX_ROWS``, the bucket ceiling; unparseable or < 1
    raises."""
    try:
        n = int(env.get("MXTPU_SPARSE_MAX_ROWS"))
    except (TypeError, ValueError) as e:
        raise MXNetError(
            f"MXTPU_SPARSE_MAX_ROWS: not an integer: "
            f"{env.raw('MXTPU_SPARSE_MAX_ROWS')!r}") from e
    if n < 1:
        raise MXNetError(f"MXTPU_SPARSE_MAX_ROWS must be >= 1, got {n}")
    return n


def row_partition(rows: int, world: int) -> List[Tuple[int, int]]:
    """Contiguous ``[start, stop)`` rows of each rank: a pure function of
    (rows, world), so every rank and every restart derives the same
    shards."""
    check(world >= 1, "sparse plane world size must be >= 1")
    check(rows % world == 0,
          f"embedding rows {rows} must divide the world {world} "
          "(pad the vocabulary — the contiguous row partition is the "
          "shard-layout invariant)")
    per = rows // world
    return [(r * per, (r + 1) * per) for r in range(world)]


def row_bucket(n: int, cap: Optional[int] = None) -> int:
    """The next power of two >= ``n`` (min 8), capped at ``cap`` (default
    ``MXTPU_SPARSE_MAX_ROWS``); ``n`` above the cap raises."""
    cap = sparse_max_rows() if cap is None else int(cap)
    if n > cap:
        raise MXNetError(
            f"sparse plane: minibatch touches {n} unique rows, above the "
            f"MXTPU_SPARSE_MAX_ROWS bucket ceiling {cap}; raise the cap "
            "(one recompile per new bucket) or shrink the batch")
    b = 8
    while b < n:
        b <<= 1
    return min(b, cap)


def masked_gather(shards, ids) -> torch.Tensor:
    """Rows ``ids`` from the per-rank shards (each ``(rows/world, dim)``):
    each shard contributes the rows it owns and zeros elsewhere, and the
    sum assembles the batch (the sharded lookup with its all-reduce
    unrolled over the simulated ranks; exact, one owner a row)."""
    dev = shards[0].device
    ids = torch.as_tensor(_np.asarray(ids, _np.int64).reshape(-1)).to(dev)
    per = int(shards[0].shape[0])
    out = None
    for r, t in enumerate(shards):
        local = ids - r * per
        mine = (local >= 0) & (local < per)
        got = t.index_select(0, local.clamp(0, per - 1))
        contrib = torch.where(mine.unsqueeze(1), got, torch.zeros_like(got))
        out = contrib if out is None else out + contrib
    return out


def _ids_host(ids) -> _np.ndarray:
    if hasattr(ids, "asnumpy"):
        ids = ids.asnumpy()
    elif isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return _np.asarray(ids, _np.int64).reshape(-1)


class EmbeddingPlane:
    """One row-sharded embedding table and its sharded training step.

    >>> opt = mx.optimizer.Adam(learning_rate=0.01)
    >>> plane = EmbeddingPlane("items", rows=4096, dim=32, world=4,
    ...                        optimizer=opt)
    >>> vecs = plane.lookup(ids)            # (batch, dim) NDArray
    >>> ...backward through the dense tower...
    >>> plane.step(ids, vecs.grad)          # sharded row-sparse update

    The optimizer belongs to the plane (its update count drives this
    table's bias correction). ``device``: where the shards live (default
    the current context)."""

    def __init__(self, name: str, rows: int, dim: int, world: int,
                 optimizer, dtype="float32", seed: int = 0,
                 init_scale: float = 0.01, kvstore=None, device=None):
        check(sparse_plane_requested(),
              "EmbeddingPlane requires MXTPU_SPARSE_PLANE=on (the "
              "explicit opt-in the grouped dense path's sparse raise "
              "names); refusing to build a sharded table behind a "
              "disabled plane")
        from ..optimizer import grouped as _grouped
        check(_grouped._rule_for(optimizer) is not None,
              f"sparse plane: optimizer {type(optimizer).__name__} has "
              "no grouped-update rule (the plane steps shards through "
              "the row-gathered grouped path)")
        check(not getattr(optimizer, "multi_precision", False) or
              str(dtype) == "float32",
              "sparse plane: multi_precision only composes with an f32 "
              "table (per-row f32 masters are not sharded yet)")
        self.name = str(name)
        self.rows, self.dim, self.world = int(rows), int(dim), int(world)
        self.parts = row_partition(self.rows, self.world)
        self.rows_per = self.rows // self.world
        self.optimizer = optimizer
        self._opt_index = 0
        self._kv = kvstore
        self.device = resolve_device(device if device is not None
                                     else current_context())
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        full = torch.randn((self.rows, self.dim), generator=gen,
                           dtype=torch_dtype(dtype), device=self.device)
        full.mul_(init_scale)
        # the shards are views of the one full table: the same bits at
        # every world size, and no second copy of it
        self._shards: List[torch.Tensor] = [full[lo:hi]
                                            for lo, hi in self.parts]
        self._state: List[Optional[Tuple]] = [None] * self.world
        self._last_created: List[int] = []
        self._last_stepped = False
        #: unique rows and bucket of the last step
        self.last_unique_rows = 0
        self.last_bucket = 0
        from ..telemetry import memory as _memory
        self._memory = _memory
        for r, s in enumerate(self._shards):
            _memory.track_plane_shard(self.name, r, self.world, s)

    # -- lookup ---------------------------------------------------------
    def lookup(self, ids):
        """The rows of ``ids`` as a ``(batch, dim)`` NDArray (attach_grad
        on it to collect the dense tower's gradient for :meth:`step`)."""
        from ..ndarray.ndarray import NDArray
        ids_np = _ids_host(ids)
        check(ids_np.size == 0 or
              (int(ids_np.min()) >= 0 and int(ids_np.max()) < self.rows),
              f"sparse plane {self.name!r}: lookup ids outside "
              f"[0, {self.rows})")
        return NDArray(masked_gather(self._shards, ids_np))

    def todense(self) -> _np.ndarray:
        """The assembled table on the host."""
        return torch.cat([s for s in self._shards]).cpu().numpy()

    # -- training -------------------------------------------------------
    def _ensure_kv(self):
        if self._kv is None:
            from .. import kvstore as _kvs
            self._kv = _kvs.create("device")
        return self._kv

    def _ensure_state(self, r: int) -> bool:
        """Create rank ``r``'s optimizer state (the rule's zeros, shaped
        like its shard) if it has none; True when this call made it."""
        if self._state[r] is not None:
            return False
        from ..ndarray.ndarray import NDArray
        from ..optimizer.grouped import _flatten_inner
        st = self.optimizer.create_state(self._opt_index,
                                         NDArray(self._shards[r]))
        self._state[r] = tuple(s._data for s in _flatten_inner(st))
        self._memory.track_plane_state(self.name, r, self.world,
                                       self._state[r])
        return True

    def step(self, ids, grad_rows, flag=None):
        """One sharded row-sparse update: deduplicate and pack the
        gradient of :meth:`lookup`'s output (``(batch, dim)``, NDArray or
        tensor) for ``ids``, exchange it, then the row-gathered update on
        every rank whose shard owns a touched row. ``flag``: an optional
        0-d bool device tensor; when it is false no row of any shard or
        state changes, and :meth:`rollback_step` undoes the host half."""
        from ..ndarray.sparse import segment_sum
        from ..optimizer import grouped as _grouped
        opt = self.optimizer
        g = getattr(grad_rows, "_data", grad_rows)
        ids_np = _ids_host(ids)
        check(g.shape[0] == ids_np.shape[0],
              f"sparse plane {self.name!r}: {ids_np.shape[0]} ids vs "
              f"{g.shape[0]} gradient rows")
        _, summed, uids_np = segment_sum(g.to(self.device), ids_np)
        n = int(uids_np.shape[0])
        bucket = row_bucket(n)
        self.last_unique_rows, self.last_bucket = n, bucket
        packed_ids = _np.full((bucket,), -1, _np.int64)
        packed_ids[:n] = uids_np
        packed = torch.zeros((bucket, self.dim), dtype=summed.dtype,
                             device=self.device)
        packed[:n] = summed
        packed_ids, packed = self._ensure_kv().sparse_plane_exchange(
            f"embplane:{self.name}", packed_ids, packed)
        # the host half first, in the per-parameter order: count, then
        # lr / wd
        opt._update_count(self._opt_index)
        self._last_stepped = True
        lr = opt._get_lr(self._opt_index)
        wd = opt._get_wd(self._opt_index)
        if _grouped._rule_for(opt).name == "Adam":
            t = opt._index_update_count[self._opt_index]
            lr = lr * math.sqrt(1 - opt.beta2 ** t) / (1 - opt.beta1 ** t)
        self._last_created = []
        for r, (lo, hi) in enumerate(self.parts):
            mine = (packed_ids >= lo) & (packed_ids < hi)
            if not mine.any():
                continue            # an untouched shard costs nothing
            if self._ensure_state(r):
                self._last_created.append(r)
            local = _np.where(mine, packed_ids - lo, 0)
            _grouped.sparse_rows_update(opt, self._shards[r], self._state[r],
                                        packed, local, mine, lr, wd,
                                        flag=flag)
        return flag

    def rollback_step(self):
        """Undo the host half of the last (sentinel-skipped) step: the
        update count, and any rank state that step created, with its
        ledger bytes."""
        from ..optimizer import grouped as _grouped
        if self._last_stepped:
            _grouped.rollback_counts(self.optimizer, [self._opt_index])
            self._last_stepped = False
        for r in self._last_created:
            self._state[r] = None
            self._memory.drop_plane_state(self.name, r, self.world)
        self._last_created = []

    # -- accounting -----------------------------------------------------
    def rank_bytes(self, rank: int) -> int:
        """This rank's ``params`` + ``optimizer`` ledger bytes."""
        led = self._memory.ledger()
        own = self._memory.plane_owner
        return (led.live_bytes("params",
                               owner_prefix=own(rank, self.world,
                                                self.name)) +
                led.live_bytes("optimizer",
                               owner_prefix=own(rank, self.world,
                                                self.name, state=True)))

    def describe(self) -> dict:
        return {"name": self.name, "rows": self.rows, "dim": self.dim,
                "world": self.world, "rows_per_rank": self.rows_per,
                "ranks_with_state":
                    sum(1 for s in self._state if s is not None)}

    # -- carrying a table across ----------------------------------------
    def save_npz(self, path: str) -> None:
        """The shards and their layout (``meta``: rows, dim, world), the
        JAX package's format."""
        arrays = {f"shard_{r}": s.cpu().numpy()
                  for r, s in enumerate(self._shards)}
        _np.savez(path, meta=_np.array([self.rows, self.dim, self.world],
                                       _np.int64), **arrays)

    def load_arrays(self, shards, states=None) -> None:
        """Take these shard values (numpy, one per rank) and, where given,
        each rank's state arrays (a tuple per rank, or None) in place."""
        check(len(shards) == self.world,
              f"sparse plane {self.name!r}: {len(shards)} shards for a "
              f"world of {self.world}")
        with torch.no_grad():
            for r, s in enumerate(shards):
                self._shards[r].copy_(torch.from_numpy(
                    _np.array(s, copy=True)).to(self._shards[r].dtype))
        for r, st in enumerate(states or [None] * self.world):
            if st is None:
                continue
            self._state[r] = tuple(torch.from_numpy(
                _np.array(a, copy=True)).to(self.device,
                                            self._shards[r].dtype)
                for a in st)
            self._memory.track_plane_state(self.name, r, self.world,
                                           self._state[r])

    def close(self) -> None:
        """Drop the plane's ledger entries."""
        self._memory.drop_plane(self.name)
