"""Failure detection + restart-from-checkpoint (SURVEY §5.3; the JAX
package's ``fault.py``).

Reference analog: ps-lite heartbeats surfaced as
``ps::Postoffice::GetDeadNodes(timeout)`` through the dist kvstore
(src/kvstore/kvstore_dist.h:121-126) and the ``is_recovery`` rejoin branch
(kvstore_dist.h:52,138,206). Collectives cannot tolerate a membership
change mid-program, so the story (SURVEY §5.3 design note) is:

1. **Liveness**: every worker process beats a per-rank heartbeat file under
   a shared directory (works across the processes tools/launch.py forks);
   ``dead_nodes(timeout)`` lists ranks whose beat is stale — the
   GetDeadNodes equivalent for the coordinator to act on.
2. **Recovery**: restart the whole job from the latest complete checkpoint.
   ``CheckpointManager`` writes atomic, versioned checkpoints (params +
   optimizer/trainer state + step counter) and ``restore_latest`` resumes;
   ``is_recovery()`` mirrors ps-lite's rejoin flag via MXNET_IS_RECOVERY.

The port updates parameters *in place* (the JAX package's arrays are
immutable), so an asynchronous save could otherwise write the weights of
a later step under an earlier step's name. ``save()`` therefore copies
every tensor to the host, synchronously, before it returns — the next
``trainer.step`` cannot reach the snapshot — and only the file IO (the
``params`` file, the optimizer states, ``meta.json``, the SHA-256
manifest, ``DONE``, the rename and pruning) runs on one writer thread, in
submission order. ``wait()`` joins it and re-raises a failed write.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import pickle
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from .base import MXNetError, check, env
from .context import cpu
from .log import get_logger
from . import ndarray as nd

__all__ = ["Heartbeat", "dead_nodes", "is_recovery", "CheckpointManager",
           "CheckpointCorruptError", "write_manifest", "verify_manifest",
           "ManifestError", "latest_checkpoint_meta"]

_LOG = get_logger("mxnet_tpu_torch.fault")


class ManifestError(MXNetError):
    """A directory of artifacts failed content verification against its
    SHA-256 manifest (hash mismatch, truncated file, missing file,
    unreadable manifest). Base class shared by checkpoint restore and the
    serving model registry — both quarantine on it."""


class CheckpointCorruptError(ManifestError):
    """A checkpoint failed content verification (manifest hash mismatch,
    truncated/unreadable payload, missing file). ``restore_latest``
    quarantines such checkpoints and falls back to the newest one that
    verifies; a direct ``restore(step)`` surfaces it to the caller."""


def write_manifest(dir_path: str, exclude: Tuple[str, ...] = (),
                   name: str = "manifest.json") -> Dict[str, dict]:
    """Write a per-file SHA-256 manifest over every regular file in
    ``dir_path`` (non-recursive, ``exclude`` and the manifest itself
    skipped). A completion marker alone proves the writer got to the end,
    not that the bytes on disk are the bytes it wrote (torn write, forged
    marker, bit rot) — the manifest is the content proof. Shared by
    :class:`CheckpointManager` and ``serving.ModelRegistry``."""
    manifest: Dict[str, dict] = {}
    skip = set(exclude) | {name}
    for fname in sorted(os.listdir(dir_path)):
        fpath = os.path.join(dir_path, fname)
        if fname in skip or not os.path.isfile(fpath):
            continue
        if ".tmp" in fname or fname.endswith(".stage"):
            continue  # in-flight staging artifacts are not content
        manifest[fname] = {"sha256": _sha256_file(fpath),
                           "bytes": os.path.getsize(fpath)}
    # tmp+rename: registry sidecar attachment rewrites the manifest of a
    # LIVE published version — a concurrent resolve() catching an
    # in-place truncation would quarantine a healthy version
    path = os.path.join(dir_path, name)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)
    return manifest


def verify_manifest(dir_path: str, label: str = "",
                    name: str = "manifest.json",
                    error_cls: type = ManifestError,
                    required: bool = False) -> Optional[Dict[str, dict]]:
    """Verify every file listed in ``dir_path``'s manifest by size and
    SHA-256; raises ``error_cls`` on any mismatch/missing file. Returns the
    parsed manifest, or None when no manifest exists and ``required`` is
    False (legacy layouts carry no content proof to check)."""
    label = label or dir_path
    man_path = os.path.join(dir_path, name)
    if not os.path.exists(man_path):
        if required:
            raise error_cls(f"{label}: missing {name}")
        return None
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise error_cls(f"{label}: unreadable manifest: {e}") from e
    for fname, rec in manifest.items():
        fpath = os.path.join(dir_path, fname)
        if not os.path.exists(fpath):
            raise error_cls(f"{label}: file {fname!r} listed in manifest "
                            "is missing")
        try:
            ok = os.path.getsize(fpath) == rec["bytes"] and \
                _sha256_file(fpath) == rec["sha256"]
        except OSError as e:
            # a concurrent quarantine (os.replace of the whole dir by
            # another replica) can yank the file between the exists
            # check and the hash — that is corruption-shaped for THIS
            # reader, not a crash
            raise error_cls(f"{label}: file {fname!r} unreadable during "
                            f"verification: {e}") from e
        if not ok:
            raise error_cls(f"{label}: file {fname!r} fails content "
                            "verification (size/sha256 mismatch with "
                            "manifest)")
    return manifest


def _hb_path(dir_path: str, rank: int) -> str:
    return os.path.join(dir_path, f"heartbeat-{rank}")


class Heartbeat:
    """Per-rank liveness beacon: touches ``heartbeat-<rank>`` every
    ``interval`` seconds on a daemon thread. Use as a context manager
    around the training loop."""

    def __init__(self, dir_path: str, rank: Optional[int] = None,
                 interval: float = 5.0):
        self._dir = dir_path
        if rank is None:
            rank = int(env.get("DMLC_RANK"))
        self._rank = int(rank)
        self._interval = float(interval)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(dir_path, exist_ok=True)

    @property
    def rank(self) -> int:
        return self._rank

    def beat(self) -> None:
        # Atomic write (tmp + rename): a plain open("w") truncates first,
        # so a concurrent dead_nodes() read could see an empty file, parse
        # the stamp as 0 and report a live rank dead.
        path = _hb_path(self._dir, self._rank)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, path)

    def start(self) -> "Heartbeat":
        self._stop.clear()  # allow restart after stop()
        self.beat()
        if self._thread is None:
            def loop():
                while not self._stop.wait(self._interval):
                    try:
                        self.beat()
                    except OSError:
                        pass
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 1)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def dead_nodes(dir_path: str, timeout: float = 60.0,
               margin: float = 1.0) -> List[int]:
    """Ranks whose heartbeat is older than ``timeout + margin`` seconds —
    the ``GetDeadNodes`` analog (ref: kvstore_dist.h:121-126). A rank that
    never wrote a heartbeat is not listed (it may not have started).

    Stamps are wall-clock (the only clock comparable across hosts sharing
    the heartbeat directory); ``margin`` absorbs NTP adjustments and
    scheduler jitter so a loaded-but-live rank is not declared dead at the
    boundary. The file mtime serves as a fallback stamp if the content is
    unreadable."""
    out = []
    now = time.time()
    if not os.path.isdir(dir_path):
        return out
    for name in sorted(os.listdir(dir_path)):
        if not name.startswith("heartbeat-") or ".tmp." in name:
            continue
        path = os.path.join(dir_path, name)
        try:
            rank = int(name.split("-", 1)[1])
        except ValueError:
            continue
        try:
            with open(path) as f:
                last = float(f.read().strip())
        except (ValueError, OSError):
            try:
                last = os.path.getmtime(path)
            except OSError:
                continue
        if now - last > timeout + margin:
            out.append(rank)
    return sorted(out)


def latest_checkpoint_meta(dir_path: str
                           ) -> Optional[Tuple[int, Dict]]:
    """Read the newest complete checkpoint's ``meta.json`` WITHOUT
    constructing a :class:`CheckpointManager` — the fleet supervisor's
    view into a worker checkpoint directory it does not own (e.g. to
    honor the ``resize_to`` a chaos ``resize@N:M`` stamped into the
    final checkpoint's topology record). Returns ``(step, meta)`` of the
    newest ``DONE``-marked checkpoint whose meta parses, or None when
    the directory holds none. Read-only: an unreadable meta is skipped
    (the worker's own restore path owns quarantine), never raised —
    the supervisor treats 'no readable meta' as 'no resize request'."""
    if not os.path.isdir(dir_path):
        return None
    steps = []
    for name in os.listdir(dir_path):
        if not name.startswith("ckpt-") or "." in name:
            continue
        try:
            step = int(name.split("-", 1)[1])
        except ValueError:
            continue
        if os.path.exists(os.path.join(dir_path, name, "DONE")):
            steps.append(step)
    for step in sorted(steps, reverse=True):
        try:
            with open(os.path.join(dir_path, f"ckpt-{step}",
                                   "meta.json")) as f:
                return step, json.load(f)
        except (OSError, ValueError):
            continue
    return None


def is_recovery() -> bool:
    """Rejoin-after-failure flag (ref: ps::Postoffice::is_recovery, set on
    relaunched nodes; here via the MXNET_IS_RECOVERY env the relauncher
    sets)."""
    # the registry's bool rule: "0", "", "false" and "False" are unset
    return bool(env.get("MXNET_IS_RECOVERY"))


class CheckpointManager:
    """Atomic, versioned training checkpoints for restart-based recovery.

    Layout: ``<dir>/ckpt-<step>/params`` (nd.save format, same container
    the reference's save_checkpoint uses — src/c_api/c_api.cc:313
    MXNDArraySave), ``trainer`` (optimizer states when given), and a
    ``DONE`` marker written last so partially-written checkpoints are
    never restored. ``max_keep`` old checkpoints are pruned.
    """

    def __init__(self, dir_path: str, max_keep: int = 3,
                 async_write: bool = False):
        check(max_keep >= 1, "max_keep must be >= 1")
        self._dir = dir_path
        self._max_keep = max_keep
        os.makedirs(dir_path, exist_ok=True)
        # async_write: save() snapshots to the host, then a writer thread
        # does the file IO in submission order; readers
        # (steps/restore/wait) fence on it first. The thread lives while
        # writes are pending and exits when the queue drains.
        self._async = bool(async_write)
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._thread: Optional[threading.Thread] = None
        self._pinned: Dict[tuple, List] = {}   # reusable snapshot buffers
        self._errors: List[BaseException] = []
        #: seconds each write took on the writer (or calling) thread:
        #: files, SHA-256 manifest, DONE, rename, prune
        self.write_seconds: List[float] = []

    def _submit(self, task) -> None:
        """Queue one write; start the writer thread if none is running."""
        with self._lock:
            self._pending.append(task)
            if self._thread is None:
                self._thread = threading.Thread(target=self._drain,
                                                name="ckpt-writer")
                self._thread.start()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._thread = None
                    return
                task = self._pending.popleft()
            try:
                task()
            except BaseException as e:  # noqa: B902 — surfaced by wait()
                self._errors.append(e)

    def wait(self) -> None:
        """Block until all scheduled checkpoint writes hit disk; a write
        that failed raises here."""
        while True:
            with self._lock:
                t = self._thread
            if t is None or t is threading.current_thread():
                break
            t.join()
        if self._errors:
            err = self._errors.pop(0)
            self._errors.clear()
            raise MXNetError(f"checkpoint write failed: {err}") from err

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt-{step}")

    def steps(self) -> List[int]:
        """Completed checkpoint steps, ascending (fences async writes)."""
        self.wait()
        return self._steps_nowait()

    def _steps_nowait(self) -> List[int]:
        out = []
        for name in os.listdir(self._dir):
            if name.startswith("ckpt-"):
                try:
                    step = int(name.split("-", 1)[1])
                except ValueError:
                    continue
                if os.path.exists(os.path.join(self._dir, name, "DONE")):
                    out.append(step)
        return sorted(out)

    def save(self, step: int, params: Optional[Dict[str, "nd.NDArray"]] = None,
             trainer=None, extra: Optional[dict] = None, net=None) -> str:
        """Write checkpoint ``step``. Pass ``net`` (a gluon Block) to save
        its parameters under structural names that survive re-instantiation
        (same naming as Block.save_parameters), or ``params`` as an explicit
        name->NDArray map; ``trainer`` may be a gluon Trainer (optimizer
        states included)."""
        check(params is not None or net is not None,
              "save() needs params or net")
        if net is not None:
            params = {k: p.data()
                      for k, p in net._collect_params_with_prefix().items()}
        path = self._ckpt_dir(step)
        if not self._async:
            self._write(step, dict(params), trainer, extra)
            return path
        # async: copy every tensor to the host NOW, synchronously (the
        # consistency point: parameters are updated in place, so the next
        # step must not reach the snapshot), then let the writer thread
        # pickle the optimizer states and do the file IO
        payload = None
        updater = (getattr(trainer, "_updaters", None) or [None])[0]
        if updater is not None and hasattr(updater, "states_payload"):
            payload = updater.states_payload()
        leaves: List = []
        _map_arrays((params, payload), leaves.append)
        copies, release = self._host_copies([a._data for a in leaves])
        it = iter(copies)
        host_params, host_payload = _map_arrays(
            (params, payload), lambda _: nd.NDArray(next(it)))
        trainer_states = None
        if trainer is not None and payload is None:
            trainer_states = trainer.get_states_bytes()

        def task():
            try:
                states = trainer_states if payload is None else \
                    pickle.dumps(host_payload)
                self._write(step, host_params, None, extra,
                            trainer_states=states)
            finally:
                release()

        self._submit(task)
        return path

    def _host_copies(self, tensors):
        """Host copies of ``tensors``, all taken before this returns, and a
        function giving their buffers back. The card's tensors of one
        device and dtype go through one flat device buffer and ONE
        device-to-host copy into a page-locked buffer, reused by later
        saves once its write is done; host tensors are cloned."""
        out = [None] * len(tensors)
        groups: Dict[tuple, List[int]] = {}
        for i, t in enumerate(tensors):
            if t.is_cuda:
                groups.setdefault((t.device, t.dtype), []).append(i)
            else:
                out[i] = t.detach().clone()
        taken = []
        for (_, dt), idx in groups.items():
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
            key = (dt, flat.numel())
            with self._lock:
                free = self._pinned.get(key)
                host = free.pop() if free else None
            if host is None:
                host = torch.empty(flat.numel(), dtype=dt, pin_memory=True)
            host.copy_(flat)           # blocking: on the host on return
            taken.append((key, host))
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = host[off:off + n].view(tensors[i].shape)
                off += n

        def release():
            with self._lock:
                for key, host in taken:
                    self._pinned.setdefault(key, []).append(host)
        return out, release

    def _write(self, step, params, trainer, extra,
               trainer_states=None) -> None:
        t0 = time.perf_counter()
        path = self._ckpt_dir(step)
        tmp = path + ".tmp"
        if os.path.isdir(tmp):
            import shutil
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        nd.save(os.path.join(tmp, "params"), dict(params))
        if trainer is not None:
            trainer.save_states(os.path.join(tmp, "trainer"))
        elif trainer_states is not None:
            with open(os.path.join(tmp, "trainer"), "wb") as f:
                f.write(trainer_states)
        meta = {"step": int(step), "time": time.time()}
        if extra:
            meta.update(extra)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        # per-file SHA-256 manifest, verified on restore (shared helper
        # with serving.ModelRegistry — one integrity discipline everywhere)
        write_manifest(tmp)
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
        if os.path.isdir(path):
            import shutil
            shutil.rmtree(path)
        os.replace(tmp, path)
        self._prune()
        self.write_seconds.append(time.perf_counter() - t0)
        from .contrib import chaos
        plan = chaos.active()
        if plan is not None:
            plan.on_checkpoint_complete(int(step), path)

    def _prune(self) -> None:
        # _steps_nowait: _prune runs on the writer thread when async —
        # fencing there would wait for its own task
        steps = self._steps_nowait()
        for step in steps[:-self._max_keep]:
            import shutil
            shutil.rmtree(self._ckpt_dir(step), ignore_errors=True)

    def latest(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def verify(self, step: int) -> None:
        """Check checkpoint ``step`` against its SHA-256 manifest; raises
        :class:`CheckpointCorruptError` on any mismatch/missing file.
        Pre-manifest checkpoints (no ``manifest.json``) are accepted as
        legacy — they carry no content proof to check."""
        path = self._ckpt_dir(step)
        if not os.path.exists(os.path.join(path, "DONE")):
            raise CheckpointCorruptError(
                f"checkpoint {step} is missing or incomplete (no DONE)")
        # legacy (manifest-less) checkpoints are accepted: required=False
        verify_manifest(path, label=f"checkpoint {step}",
                        error_cls=CheckpointCorruptError)

    def _quarantine(self, step: int, reason: str = "") -> str:
        """Rename a corrupt/incomplete checkpoint to ``ckpt-<step>.bad``
        (suffixed if taken) so it is never restored again but stays on
        disk for post-mortem."""
        path = self._ckpt_dir(step)
        bad = path + ".bad"
        i = 0
        while os.path.exists(bad):
            i += 1
            bad = f"{path}.bad{i}"
        os.replace(path, bad)
        _LOG.warning("quarantined corrupt checkpoint %s -> %s (%s)",
                     path, bad, reason)
        return bad

    def restore(self, step: int, net=None, trainer=None,
                allow_missing: bool = False, meta_check=None
                ) -> Tuple[int, Dict[str, "nd.NDArray"], dict]:
        """Load checkpoint ``step`` (content-verified against its
        manifest); when ``net``/``trainer`` are given, their
        parameters/optimizer states are set in place.

        The net restore is strict in BOTH directions: checkpoint keys
        missing from the net raise, and net parameters absent from the
        checkpoint raise too (they would silently keep their current
        values) — pass ``allow_missing=True` to opt out of the latter.

        ``meta_check``: optional callable run on the parsed ``meta.json``
        BEFORE any parameter or optimizer state touches the net/trainer —
        the elastic-resume topology gate (``parallel/elastic.py``): a
        checkpoint whose recorded world is incompatible with this
        process must raise here, never load as the wrong shard. Its
        exceptions propagate verbatim (an incompatible checkpoint is not
        a corrupt one — ``restore_latest`` quarantines only the
        latter)."""
        self.wait()  # fence pending async writes
        path = self._ckpt_dir(step)
        self.verify(step)  # typed CheckpointCorruptError on missing/bad
        try:
            # onto the host: set_data copies each value to its parameter's
            # device, in place
            params = nd.load(os.path.join(path, "params"), ctx=cpu())
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except MXNetError:
            raise
        except Exception as e:
            # legacy (manifest-less) checkpoints can still be truncated;
            # surface it as corruption so restore_latest quarantines it
            raise CheckpointCorruptError(
                f"checkpoint {step}: payload unreadable: {e}") from e
        if meta_check is not None:
            meta_check(meta)
        if net is not None:
            # structural names first (instance-independent, the save(net=)
            # format), falling back to collect_params naming; unmatched
            # keys are an error, not a silent skip. BOTH key-set checks
            # run before any set_data so a failed restore leaves the net
            # untouched, never half-restored.
            structural = net._collect_params_with_prefix()
            flat = net.collect_params()
            assign = []
            for k, v in params.items():
                if k in structural:
                    assign.append((structural[k], v))
                elif k in flat:
                    assign.append((flat[k], v))
                else:
                    raise MXNetError(
                        f"checkpoint parameter {k!r} not found in net "
                        f"(known: {sorted(structural)[:5]}...)")
            if not allow_missing:
                covered = {id(p) for p, _ in assign}
                stale = [k for k, p in structural.items()
                         if id(p) not in covered]
                if stale:
                    raise MXNetError(
                        f"net parameters absent from checkpoint {step} "
                        f"would keep their current values: {stale[:8]}"
                        f"{'...' if len(stale) > 8 else ''} — pass "
                        "allow_missing=True to accept a partial restore")
            for p, v in assign:
                p.set_data(v)
        tr_path = os.path.join(path, "trainer")
        if trainer is not None and os.path.exists(tr_path):
            trainer.load_states(tr_path)
        return int(meta["step"]), params, meta

    def restore_latest(self, net=None, trainer=None,
                       allow_missing: bool = False, meta_check=None
                       ) -> Optional[Tuple[int, Dict, dict]]:
        """Resume point for restart-based recovery: returns None on a
        fresh start, else (step, params, meta) of the newest checkpoint
        that passes content verification (optionally loading net/trainer
        in place). Corrupt/incomplete checkpoints are quarantined
        (renamed ``ckpt-<step>.bad``) and the next-newest is tried —
        a truncated latest never takes down recovery. A ``meta_check``
        raise (topology-incompatible, see :meth:`restore`) propagates —
        an intact checkpoint this process must not load is an operator
        decision, not a fall-back-and-quarantine."""
        self.wait()
        for step in reversed(self._steps_nowait()):
            try:
                return self.restore(step, net=net, trainer=trainer,
                                    allow_missing=allow_missing,
                                    meta_check=meta_check)
            except CheckpointCorruptError as e:
                self._quarantine(step, str(e))
        return None


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)



def _map_arrays(obj, fn):
    """``obj`` with every NDArray leaf replaced by ``fn(leaf)`` (tuples,
    lists and dicts rebuilt, in a fixed order; anything else kept)."""
    if isinstance(obj, nd.NDArray):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_map_arrays(o, fn) for o in obj)
    if isinstance(obj, list):
        return [_map_arrays(o, fn) for o in obj]
    if isinstance(obj, dict):
        return {k: _map_arrays(v, fn) for k, v in obj.items()}
    return obj
