"""Resilient training loop: FitLoop (SURVEY §5.3, hardened; the JAX
package's ``fit.py``).

The reference survives worker death by detection + restart-from-checkpoint
(ps-lite heartbeats, kvstore_dist.h is_recovery); ``fault.py`` reproduces
the detection half. This module owns the *survival* half end to end:

- **NaN sentinel**: after backward + allreduce, every gradient is checked
  for global finiteness. A non-finite step is *skipped* — optimizer state
  and parameters untouched — and the dynamic loss scale backs off, so an
  overflow step costs N recovery steps instead of a poisoned run.
- **Verified periodic checkpoints**: async `CheckpointManager` saves every
  ``ckpt_every`` steps with the data-iterator position (epoch, batches
  consumed, seed) in ``meta.json``; resume fast-forwards the iterator so
  the resumed run replays the exact fault-free batch (and loss) sequence.
- **Preemption-safe exit**: SIGTERM/SIGINT (the preemption signal) is
  trapped at a step boundary, a final synchronous verified checkpoint is
  written, and the process exits with a distinct resumable code
  (``MXTPU_RESUMABLE_EXIT_CODE``, default 75 = EX_TEMPFAIL) so the
  relauncher can tell "resume me" from a real failure.
- **Heartbeat**: a per-rank liveness beacon runs for the whole fit, so the
  coordinator's ``dead_nodes`` sees this worker.
- **Chaos hooks**: an installed ``contrib.chaos`` plan gets its step clock
  driven from here (``begin_step``) and may kill/preempt/poison at exact,
  reproducible steps — every claim above is regression-tested by
  injection, not assumed.

In the port the finiteness flag and the loss come to the host in one
device-to-host copy a step (the JAX package's ``jax.device_get((flag,
loss))``). Under ``MXTPU_MEGASTEP=on`` the step (forward, backward,
sentinel, grouped update) is one replay of a CUDA graph per input
signature (``megastep.py``), timed as the breakdown's ``megastep``
segment; the fetch, the rollback and the loss-scale backoff stay as
they are.

The telemetry planes, as in the JAX package: ``MXTPU_NUMERICS`` (the
sampled steps' stats matrices ride the step's one flag+loss transfer; a
skipped step gets its provenance pass), ``MXTPU_EFFICIENCY`` (each step
is an efficiency window), ``MXTPU_AUTOTUNE`` (the probe-then-lock tuner;
the environment and the staging depth are restored when ``fit()``
returns) and ``MXTPU_RUN_REPORT_DIR`` (a run report written at fit end).
They fill ``FitResult.numerics``, ``.efficiency``, ``.tuning_report`` and
``.run_report``. Not ported, each raising ``NotPortedError`` naming
ROADMAP A10 when its environment variable asks for it, at ``fit()``
start — before any step runs and before the signal handlers install:
``MXTPU_COLL_HEALTH`` / ``MXTPU_COLL_TIMEOUT_S`` (the comm planes) and
``MXTPU_ZERO``.
"""
from __future__ import annotations

import contextlib
import signal
import sys
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from .base import MXNetError, check, env
from .base import env_switch as _switch
from .log import get_logger
from . import fault
from . import megastep as _megastep
from .contrib import chaos as _chaos
from .ops.registry import NotPortedError
from .parallel import elastic as _elastic
from .telemetry import autotune as _autotune
from .telemetry import efficiency as _efficiency
from .telemetry import memory as _memory
from .telemetry import numerics as _numerics
from .telemetry import run_report as _run_report
from .telemetry.step_breakdown import StepBreakdown, segment as _segment

__all__ = ["FitLoop", "FitResult", "resumable_exit_code"]

_LOG = get_logger("mxnet_tpu_torch.fit")


def _number(name: str, typ) -> float:
    try:
        v = typ(env.get(name))
    except (TypeError, ValueError) as e:
        raise MXNetError(f"{name}: not a number: {env.raw(name)!r}") from e
    if v < 0:
        raise MXNetError(f"{name} must be >= 0, got {v}")
    return v


def _not_ported(what: str, item: str) -> NotPortedError:
    return NotPortedError(f"FitLoop: {what} is not ported yet "
                          f"(ROADMAP.md, queue {item})")


def _refuse_unported_planes() -> None:
    """The environment flags of parts the port lacks, parsed where the JAX
    package parses them (at fit start): a flag that asks for one raises
    ``NotPortedError`` naming its ROADMAP item, a malformed value raises
    ``MXNetError``; unset or off, nothing happens. The planes' own flags
    get their strict parse here too, before any step runs."""
    _autotune.requested()
    if _number("MXTPU_COLL_HEALTH", int) > 0 or \
            _number("MXTPU_COLL_TIMEOUT_S", float) > 0:
        raise _not_ported("the comm-health planes (MXTPU_COLL_HEALTH / "
                          "MXTPU_COLL_TIMEOUT_S)", "A10")
    if _switch("MXTPU_ZERO"):
        raise _not_ported("ZeRO-1 sharded optimizer state (MXTPU_ZERO)",
                          "A10")
    _numerics.spec()
    _efficiency.spec()


def resumable_exit_code() -> int:
    """The 'killed but resumable' exit code (MXTPU_RESUMABLE_EXIT_CODE,
    default 75 = BSD EX_TEMPFAIL). Shared contract: FitLoop's preemption
    path AND serving.ModelServer.serve_forever's SIGTERM drain both exit
    with this code, so one relauncher policy covers trainers and
    servers."""
    return int(env.get("MXTPU_RESUMABLE_EXIT_CODE"))


@dataclass
class FitResult:
    status: str                      # "done" (preemption exits the process)
    step: int                        # completed optimization steps, total
    epoch: int                       # epochs fully completed
    losses: List[float] = field(default_factory=list)   # this run only
    skipped_steps: List[int] = field(default_factory=list)
    loss_scale: float = 1.0
    resumed_from: Optional[int] = None  # checkpoint step, None = fresh
    step_breakdown: Optional[dict] = None  # telemetry summary (shares)
    tuning_report: Optional[dict] = None  # autotune protocol (MXTPU_AUTOTUNE)
    memory: Optional[dict] = None  # live-byte ledger summary + step peaks
    zero: Optional[dict] = None  # ZeRO-1 plane summary (MXTPU_ZERO=1)
    comm_health: Optional[dict] = None  # collective skew/desync/watchdog
    # summary (MXTPU_COLL_HEALTH / MXTPU_COLL_TIMEOUT_S)
    numerics: Optional[dict] = None  # tensor-stat window + loss-scale
    # timeline + non-finite provenance (MXTPU_NUMERICS; the loss-scale
    # timeline is recorded even with the plane off)
    efficiency: Optional[dict] = None  # MFU/goodput rollup: attributed
    # program FLOPs/bytes vs wall and the device peak table
    # (MXTPU_EFFICIENCY / MXTPU_DEVICE_PEAK)
    run_report: Optional[str] = None  # path of the persistent run
    # report written at fit end (MXTPU_RUN_REPORT_DIR; None = off)
    elastic: Optional[dict] = None  # elastic-resume summary when this
    # run resumed across a world-size change (MXTPU_ELASTIC=on):
    # from_world/world/rank/members and the checkpoint's resize_to


class FitLoop:
    """Stitches net + trainer + loss + data into a run that survives
    kills, preemptions, NaN steps and corrupt checkpoints.

    Parameters
    ----------
    net, trainer, loss_fn : gluon Block, gluon Trainer, callable(pred, label)
    train_iter : DataIter yielding DataBatch (``set_epoch`` support — e.g.
        seeded NDArrayIter — makes resume batch-exact)
    ckpt_dir : checkpoint/heartbeat directory; None disables persistence
        (and therefore resume + preemption checkpointing)
    ckpt_every : periodic checkpoint cadence in steps
    on_step_end : optional ``f(step, loss)`` called after each step fully
        completes (after its periodic checkpoint, when due, is on disk)
    loss_scale / scale_backoff / scale_growth_interval : dynamic loss
        scaling — scale multiplies the loss before backward, updates are
        un-scaled via the step batch size; a non-finite step multiplies the
        scale by ``scale_backoff``, ``scale_growth_interval`` consecutive
        good steps double it (capped at ``max_loss_scale``)
    """

    def __init__(self, net, trainer, loss_fn: Callable, train_iter,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
                 max_keep: int = 3, async_ckpt: bool = True,
                 heartbeat: bool = True, heartbeat_interval: float = 5.0,
                 loss_scale: float = 1.0, scale_backoff: float = 0.5,
                 scale_growth_interval: int = 200,
                 max_loss_scale: float = 2.0 ** 16,
                 skip_nonfinite: bool = True, seed: Optional[int] = None,
                 ignore_stale_grad: bool = False,
                 collect_breakdown: bool = True,
                 tokens_per_sample: Optional[float] = None,
                 on_step_end: Optional[Callable] = None):
        check(ckpt_every >= 1, "ckpt_every must be >= 1")
        self._net = net
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._iter = train_iter
        self._ckpt_dir = ckpt_dir
        self._ckpt_every = int(ckpt_every)
        self._max_keep = max_keep
        self._async_ckpt = async_ckpt
        self._heartbeat = heartbeat
        self._hb_interval = heartbeat_interval
        self._loss_scale = float(loss_scale)
        self._scale_backoff = float(scale_backoff)
        self._scale_growth = int(scale_growth_interval)
        self._max_scale = float(max_loss_scale)
        self._skip_nonfinite = skip_nonfinite
        self._seed = seed
        # passthrough to Trainer.update for nets with trainable params the
        # loss never reaches (auxiliary heads, conditional branches)
        self._ignore_stale_grad = ignore_stale_grad
        # per-step telemetry (data_wait/h2d/compute/optimizer/comm/
        # checkpoint + the input-bound/comm-bound detector); the summary
        # lands in FitResult.step_breakdown. A dozen clock reads per step
        # — leave on unless the step loop is sub-millisecond.
        self._collect_breakdown = collect_breakdown
        # tokens per training sample (sequence length x packing), for
        # the efficiency plane's tokens/s goodput — the number a
        # transformer recipe is graded on. None = samples/s only.
        self._tokens_per_sample = tokens_per_sample
        # on_step_end(step, loss): invoked after a step fully completes —
        # AFTER its periodic checkpoint (if due) lands, so anything the
        # callback records about step N is backed by durable state at
        # least that fresh. This is the hook the self-healing soak logs
        # per-step sample ids through: a line for step N implies a
        # checkpoint covering N, so a kill can never leave the log ahead
        # of what a resume will re-train. Exceptions propagate (it is
        # caller code, not telemetry).
        self._on_step_end = on_step_end
        self._preempted: Optional[int] = None  # signum once trapped
        self._old_handlers = {}

    # -- signals --------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        # flag only: the loop reacts at the next step boundary, where
        # model/optimizer state is consistent enough to checkpoint
        self._preempted = signum

    def _install_handlers(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return  # signal.signal is main-thread-only
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old_handlers[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):
                pass

    def _restore_handlers(self) -> None:
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_handlers = {}

    # -- checkpoint helpers ---------------------------------------------
    def _save(self, cm: "fault.CheckpointManager", step: int, epoch: int,
              batches_in_epoch: int,
              resize_to: Optional[int] = None) -> None:
        extra = {"data_state": {"epoch": int(epoch),
                                "batch": int(batches_in_epoch),
                                "seed": self._seed},
                 "loss_scale": self._loss_scale,
                 # topology record (parallel/elastic.py): world/rank,
                 # data-shard layout and the world-independent global
                 # sample position — what a resume at a DIFFERENT world
                 # size re-splits from
                 "topology": _elastic.topology_record(
                     self._trainer, self._iter,
                     batches=batches_in_epoch, resize_to=resize_to)}
        cm.save(step, net=self._net, trainer=self._trainer, extra=extra)

    def _grads_finite_flag(self, like):
        """Device-resident all-grads-finite scalar (no host sync here —
        the caller fetches it together with the loss in one transfer)."""
        checks = []
        for p in self._trainer._params:
            if p.grad_req == "null" or p.tensor is None:
                continue
            checks.append(torch.isfinite(p.grad()._data).all())
        return torch.stack(checks).all() if checks else \
            torch.ones((), dtype=torch.bool, device=like.device)

    @staticmethod
    def _fetch(flag, loss_dev, nstats=None):
        """The flag, the loss and a numerics sampled step's stats matrices
        in ONE device-to-host copy (float64 holds them exactly). Returns
        ``(finite, loss, matrices or None)``."""
        parts = [flag.to(torch.float64).reshape(1),
                 loss_dev.to(torch.float64).reshape(1)]
        if nstats:
            parts += [m.to(torch.float64).reshape(-1) for _, m in nstats]
        vals = torch.cat([p.to(parts[0].device) for p in parts]).tolist()
        nvals = None
        if nstats is not None:
            nvals, off = [], 2
            for _, m in nstats:
                n = m.shape[0]
                nvals.append([vals[off + 6 * r:off + 6 * r + 6]
                              for r in range(n)])
                off += 6 * n
        return vals[0] != 0.0, vals[1], nvals

    def _record_late_numerics(self, step: int, finite: bool) -> None:
        """Publish sampled stats a classic (non-sentinel) update produced
        after the step's transfer (``skip_nonfinite=False``): the grouped
        buckets' when they covered the step, else the per-parameter
        fallback's."""
        nstats = getattr(self._trainer, "last_numerics_stats", None)
        if not nstats:
            nstats = _numerics.fallback_collect(self._trainer)
        if not nstats:
            return
        try:
            _numerics.record_step(
                step, [(names, m.double().cpu().numpy())
                       for names, m in nstats],
                loss_scale=self._loss_scale, finite=finite,
                trainer=self._trainer)
        except Exception as e:
            _LOG.warning("numerics record failed: %s", e)

    def _composed_step(self, x, y, bs, plan, overlap_scope, step):
        """Forward, backward, chaos poison, allreduce and (where the
        grouped path covers every parameter) the guarded update; returns
        ``(flag or None, loss_dev)``."""
        from . import autograd
        # the overlap scope goes inactive for a step whose grads the chaos
        # plan will poison AFTER backward: pass OUR chaos clock (the
        # trainer's step() counter never advances under FitLoop)
        ov = overlap_scope(chaos_step=step) \
            if overlap_scope is not None else contextlib.nullcontext()
        with _segment("compute"):
            with autograd.record():
                out = self._net(x)
                loss = self._loss_fn(out, y) \
                    if y is not None else self._loss_fn(out)
                scaled = loss * self._loss_scale \
                    if self._loss_scale != 1.0 else loss
            with ov:
                scaled.backward()
        if plan is not None:
            plan.poison_grads(self._trainer._params)
        with _segment("comm"):
            self._trainer.allreduce_grads()
        with _segment("compute"):
            loss_dev = loss.mean()._data
        fused_flag = None
        if self._skip_nonfinite and \
                hasattr(self._trainer, "update_with_sentinel"):
            # aggregated fast path: one on-device finiteness flag, the
            # update where-guarded on device; a non-finite step left
            # params/state untouched and only the host counters need
            # rolling back
            with _segment("optimizer"):
                fused_flag = self._trainer.update_with_sentinel(
                    bs * self._loss_scale,
                    ignore_stale_grad=self._ignore_stale_grad)
        return fused_flag, loss_dev

    def _position_iter(self, epoch: int, skip_batches: int = 0) -> int:
        """Position the iterator at (epoch, skip_batches). Iterators
        with ``set_position`` (NDArrayIter) land there in O(1) — the
        elastic-resume fast-forward — and the count is returned as
        already-consumed; others are set to the epoch start and the
        caller fetch-replays the skip (return 0)."""
        setpos = getattr(self._iter, "set_position", None)
        if skip_batches and setpos is not None:
            stride = int(getattr(self._iter, "num_parts", 1) or 1) * \
                int(getattr(self._iter, "batch_size", 0) or 0)
            if stride > 0:
                setpos(epoch, skip_batches * stride)
                return int(skip_batches)
        set_epoch = getattr(self._iter, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)
        else:
            self._iter.reset()
        return 0

    # -- the loop -------------------------------------------------------
    def fit(self, epochs: int, batch_size: Optional[int] = None,
            resume: bool = True) -> FitResult:
        """Train for ``epochs`` epochs, resuming from the newest verified
        checkpoint in ``ckpt_dir`` when one exists (``resume=False`` forces
        a fresh start). Returns a :class:`FitResult`; on SIGTERM/SIGINT the
        process instead exits with :func:`resumable_exit_code` after a
        final synchronous checkpoint."""
        # the planes the port lacks: a flag asking for one raises HERE,
        # before any state loads, any step runs and the handlers install
        _refuse_unported_planes()
        cm = None
        if self._ckpt_dir is not None:
            cm = fault.CheckpointManager(self._ckpt_dir,
                                         max_keep=self._max_keep,
                                         async_write=self._async_ckpt)
        result = FitResult(status="done", step=0, epoch=0,
                           loss_scale=self._loss_scale)
        start_epoch, skip_batches = 0, 0
        if cm is not None and resume:
            # the topology gate runs INSIDE restore, before any state is
            # loaded: an incompatible checkpoint raises instead of loading
            # (parallel/elastic.py)
            gate: dict = {}

            def _topo_gate(meta):
                topo = meta.get("topology")
                if not topo:
                    gate.clear()  # legacy checkpoint: nothing to compare
                    return
                cur = _elastic.current_topology(self._trainer, self._iter)
                _elastic.check_restore(topo, cur)
                # the data re-split is validated here too, before any
                # parameter or optimizer state loads
                skip = _elastic.resplit_batches(
                    topo, cur,
                    int((meta.get("data_state") or {}).get("batch", 0)))
                # restore_latest may fall back across checkpoints: the
                # surviving (last) call's verdict is the one acted on
                gate.update(skip=skip)
            restored = cm.restore_latest(net=self._net,
                                         trainer=self._trainer,
                                         meta_check=_topo_gate)
            if restored is not None:
                step, _, meta = restored
                result.step = step
                result.resumed_from = step
                ds = meta.get("data_state") or {}
                start_epoch = int(ds.get("epoch", 0))
                skip_batches = int(ds.get("batch", 0))
                self._loss_scale = float(
                    meta.get("loss_scale", self._loss_scale))
                if gate:
                    # the recorded global sample position over the current
                    # layout (unchanged layouts pass the count through)
                    skip_batches = int(gate["skip"])
                _LOG.warning("resuming from checkpoint step %d "
                             "(epoch %d, %d batches consumed)",
                             step, start_epoch, skip_batches)

        result.epoch = start_epoch
        # last known iterator position, written into every checkpoint; on
        # a resume where no new steps run this must stay the restored
        # position, not reset to (0, 0)
        pos_epoch, pos_batch = start_epoch, skip_batches
        steps_before = result.step
        plan = _chaos.active()
        # memory axis: re-arm the budget-watermark edge detector (one
        # forensics dump per run per breach) and open a fresh ledger window
        _memory.reset_pressure_state()
        _memory.ledger().begin_window()
        # the numerics and efficiency planes: strict parse before any step
        # runs and before the handlers install; the loss-scale timeline
        # re-arms per fit
        _numerics.reset_run()
        _efficiency.reset_run()
        # the megastep, constructed HERE so every knob it cannot compose
        # with raises before any step runs and before the handlers install
        megastep = None
        if _megastep.megastep_requested():
            megastep = _megastep.Megastep(
                self._net, self._trainer, self._loss_fn,
                skip_nonfinite=self._skip_nonfinite,
                ignore_stale_grad=self._ignore_stale_grad)
        good_streak = 0
        hb = None
        if self._heartbeat and self._ckpt_dir is not None:
            hb = fault.Heartbeat(self._ckpt_dir,
                                 interval=self._hb_interval).start()
        self._install_handlers()
        # the tuner scores candidates with the step breakdown, so probing
        # forces one on; it is dropped at the lock if the caller opted out
        tuner = None
        if _autotune.requested():
            tuner = _autotune.AutoTuner(trainer=self._trainer,
                                        data_iter=self._iter)
        bd = StepBreakdown().install() \
            if (self._collect_breakdown or tuner is not None) else None
        # comm/backward overlap: brackets backward; inactive scopes are free
        overlap_scope = getattr(self._trainer, "overlap_scope", None)
        try:
            for epoch in range(start_epoch, epochs):
                # direct positioning consumes the skip in O(1) when the
                # iterator supports it; otherwise consumed starts at 0
                # and the loop below fetch-replays skip_batches batches
                consumed = self._position_iter(epoch, skip_batches)
                data_it = iter(self._iter)
                while True:
                    if bd is not None:
                        bd.begin_step(result.step)
                    _efficiency.begin_step()
                    # data_wait: blocked on the input pipeline (staging
                    # iterators emit nested h2d spans; exclusive-time
                    # accounting charges each second once)
                    try:
                        with _segment("data_wait"):
                            batch = next(data_it)
                    except StopIteration:
                        break
                    if consumed < skip_batches:
                        consumed += 1  # fast-forward: replayed, not trained
                        continue
                    if plan is not None:
                        plan.begin_step(result.step)
                        plan.maybe_kill()  # ChaosKilled propagates (abrupt)
                        rz = plan.resize_target()
                        if rz is not None:
                            # resize@N[:M]: graceful kill with a resumable
                            # exit; the final checkpoint's topology record
                            # carries the target world
                            self._final_resize(cm, result, epoch,
                                               consumed, rz["world"])
                    _numerics.mark_step(result.step)
                    if self._preempted is not None:
                        self._final_exit(cm, result, epoch, consumed)
                    if tuner is not None:
                        tuner.on_step_begin(result.step)
                    x = batch.data[0]
                    y = batch.label[0] if batch.label else None
                    bs = batch_size if batch_size is not None \
                        else x.shape[0]
                    if megastep is not None:
                        # one graph: compute, comm and optimizer are one
                        # segment
                        with _segment("megastep"):
                            fused_flag, loss_dev = megastep.run(
                                x, y, bs, self._loss_scale, plan)
                    else:
                        fused_flag, loss_dev = self._composed_step(
                            x, y, bs, plan, overlap_scope, result.step)
                    # the blocking fetch realizes the whole async step
                    # (forward/backward dominate): charged to compute, or
                    # to the megastep's one segment. The flag, the loss
                    # and a sampled step's numerics stats come back in
                    # ONE transfer.
                    nstats = getattr(self._trainer, "last_numerics_stats",
                                     None)
                    nvals = None
                    if fused_flag is not None:
                        with _segment("megastep" if megastep is not None
                                      else "compute"):
                            finite, loss_val, nvals = self._fetch(
                                fused_flag, loss_dev, nstats)
                        if not finite:
                            self._trainer.rollback_step()
                    elif self._skip_nonfinite:
                        # fused path declined: the per-parameter check and
                        # fallback stats, still one transfer
                        nstats = _numerics.fallback_collect(self._trainer)
                        with _segment("compute"):
                            finite, loss_val, nvals = self._fetch(
                                self._grads_finite_flag(loss_dev), loss_dev,
                                nstats)
                    else:
                        finite, nstats = True, None
                        with _segment("compute"):
                            loss_val = float(loss_dev.item())
                    if nvals is not None:
                        try:
                            _numerics.record_step(
                                result.step,
                                [(names, v) for (names, _), v
                                 in zip(nstats, nvals)],
                                loss_scale=self._loss_scale,
                                finite=finite, trainer=self._trainer)
                        except Exception as e:
                            _LOG.warning("numerics record failed: %s", e)
                    if not finite:
                        # sentinel: skip the update entirely — params and
                        # optimizer state stay at the pre-step values —
                        # and back off the loss scale
                        result.skipped_steps.append(result.step)
                        # provenance before the grads are zeroed below:
                        # the extra syncs land only on this lost step
                        if _numerics.enabled():
                            try:
                                _numerics.nonfinite_step(
                                    result.step, self._trainer,
                                    loss_scale=self._loss_scale)
                            except Exception as e:
                                _LOG.warning(
                                    "numerics provenance failed: %s", e)
                        old_scale = self._loss_scale
                        self._loss_scale = max(
                            self._loss_scale * self._scale_backoff, 2e-5)
                        _numerics.note_loss_scale(
                            result.step, old_scale, self._loss_scale,
                            "backoff")
                        good_streak = 0
                        # zero (not just mark stale) the grad buffers: a
                        # grad_req='add' buffer would otherwise accumulate
                        # onto the NaN/Inf bytes next backward and stall
                        # the sentinel forever
                        for p in self._trainer._params:
                            p.zero_grad()
                        _LOG.warning(
                            "step %d: non-finite gradients — update "
                            "skipped, loss scale -> %g",
                            result.step, self._loss_scale)
                    else:
                        if fused_flag is None:  # fused path already updated
                            with _segment("optimizer"):
                                self._trainer.update(
                                    bs * self._loss_scale,
                                    ignore_stale_grad=self._ignore_stale_grad)
                            if not self._skip_nonfinite:
                                self._record_late_numerics(result.step,
                                                           finite)
                        good_streak += 1
                        if self._scale_growth and \
                                good_streak % self._scale_growth == 0 and \
                                self._loss_scale < self._max_scale:
                            old_scale = self._loss_scale
                            self._loss_scale = min(self._loss_scale * 2.0,
                                                   self._max_scale)
                            _numerics.note_loss_scale(
                                result.step, old_scale, self._loss_scale,
                                "growth")
                    result.losses.append(loss_val)
                    consumed += 1
                    result.step += 1
                    if cm is not None and \
                            result.step % self._ckpt_every == 0:
                        with _segment("checkpoint"):
                            self._save(cm, result.step, epoch, consumed)
                    if self._on_step_end is not None:
                        self._on_step_end(result.step - 1, loss_val)
                    _efficiency.end_step(
                        step=result.step - 1, samples=int(bs),
                        useful=finite,
                        tokens_per_sample=self._tokens_per_sample)
                    if bd is not None:
                        rec = bd.end_step()
                        if tuner is not None:
                            # the step that ran (result.step - 1)
                            tuner.on_step_end(result.step - 1, rec,
                                              breakdown=bd)
                            if tuner.locked and \
                                    not self._collect_breakdown:
                                # the breakdown existed only to score the
                                # probes: the caller's opt-out resumes
                                bd.uninstall()
                                bd = None
                    # memory pressure: the mem_pressure chaos event and the
                    # MXTPU_MEM_BUDGET watermark both fire a ranked
                    # forensics dump; a dump failure must not take down
                    # the training step that still works
                    try:
                        _memory.check_pressure(step=result.step - 1,
                                               plan=plan)
                    except Exception as e:
                        _LOG.warning("memory pressure check failed: %s", e)
                skip_batches = 0
                result.epoch = epoch + 1
                pos_epoch, pos_batch = epoch + 1, 0
                if self._preempted is not None:
                    self._final_exit(cm, result, epoch + 1, 0)
            if cm is not None and result.step > steps_before and \
                    result.step % self._ckpt_every != 0:
                self._save(cm, result.step, pos_epoch, pos_batch)
            if cm is not None:
                cm.wait()
        except Exception as e:
            # allocation failure: write the memory black box while the
            # evidence is still live, then let the error propagate
            _memory.maybe_dump_oom(e, step=result.step)
            raise
        finally:
            if tuner is not None:
                # the decision persists in the report; the env mutation
                # must not leak past this fit() call
                tuner.restore_env()
            if bd is not None:
                bd.uninstall()
            if hb is not None:
                hb.stop()
            self._restore_handlers()
        result.loss_scale = self._loss_scale
        if bd is not None and bd.steps and self._collect_breakdown:
            result.step_breakdown = bd.summary()
        # memory summary: ledger category snapshot + per-step watermarks
        result.memory = _memory.ledger().summary()
        if bd is not None and bd.mem_steps:
            result.memory.update(bd.memory_summary())
        if tuner is not None:
            result.tuning_report = tuner.report()
        # the numbers axis: sampled-stat window, loss-scale timeline,
        # non-finite provenance (None when the plane is off and no
        # loss-scale event fired)
        result.numerics = _numerics.summary()
        # the efficiency axis: MFU / roofline / goodput (None when off)
        result.efficiency = _efficiency.summary(
            tokens_per_sample=self._tokens_per_sample)
        # the run report, written last so it holds every summary above; a
        # failed write is diagnosed, never fatal
        if _run_report.report_dir() is not None:
            try:
                result.run_report = _run_report.write_run_report(result)
                _LOG.info("run report: %s", result.run_report)
            except Exception as e:
                _LOG.warning("run report failed: %s", e)
        return result

    def _final_resize(self, cm, result: FitResult, epoch: int,
                      consumed: int, to_world: Optional[int]) -> None:
        """Chaos ``resize@N[:M]`` path: final verified checkpoint whose
        topology record names the target world, then the resumable exit
        — the same contract as preemption, but the relauncher is TOLD to
        come back at a different size. Under a real group every rank's
        plan fires at the same step, so the (collective) gather-on-save
        checkpoint stays in lockstep."""
        check(cm is not None,
              "chaos resize@ needs a checkpoint dir: with ckpt_dir=None "
              "there is nothing for the resized relaunch to resume")
        self._restore_handlers()
        self._save(cm, result.step, epoch, consumed, resize_to=to_world)
        cm.wait()  # the final write must hit disk before we die
        _LOG.warning("resize: wrote final checkpoint at step %d "
                     "(resize_to=%s), exiting resumable",
                     result.step, to_world)
        sys.exit(resumable_exit_code())

    def _final_exit(self, cm, result: FitResult, epoch: int,
                    consumed: int) -> None:
        """Preemption path: final verified checkpoint, then exit with the
        distinct resumable code. Without a checkpoint dir there is nothing
        to resume from, so the signal is re-delivered with its original
        disposition instead of lying to the relauncher with code 75."""
        signum = self._preempted
        signame = {signal.SIGTERM: "SIGTERM",
                   signal.SIGINT: "SIGINT"}.get(signum, str(signum))
        self._restore_handlers()
        if cm is None:
            signal.raise_signal(signum)  # default: die/KeyboardInterrupt
            sys.exit(128 + int(signum))  # fallback if it was ignored
        self._save(cm, result.step, epoch, consumed)
        cm.wait()  # the final write must hit disk before we die
        _LOG.warning("%s: wrote final checkpoint at step %d, exiting "
                     "resumable", signame, result.step)
        sys.exit(resumable_exit_code())
